// CSR SpMV: y[row] = sum_k data[k] * x[indices[k]] over k in
// [indptr[row], indptr[row + 1]), with hub rows split across the card.
//
// Replaces: src/repro/kernels/csr.py  csr_spmv_pallas / _csr_kernel. That
// kernel walks a flat nonzero stream in equal tiles along a sequential grid
// and carries y in on-chip memory, so it is balanced by nonzeros by
// construction. On the card CTAs run in parallel and nothing carries between
// them. One launch holds two kinds of CTA:
//
// * Row CTAs (blockIdx >= hub_ctas). CTA b owns `rows_per_block`
//   consecutive rows; its min(rows_per_block, 8) warps take them one row at
//   a time: the 32 lanes stride the row's nonzeros (coalesced values and
//   columns, a trip's `unroll` loads per lane issued before their x
//   gathers), each lane keeps `unroll` accumulators, a shuffle tree sums
//   the warp, lane 0 stores y[row]. A row of more than `hub_row` nonzeros is
//   skipped: one warp would walk it trip after trip while the card idles.
// * Chunk CTAs (blockIdx < hub_ctas, first in launch order). CTA h owns
//   nonzeros [h * chunk, (h + 1) * chunk) and adds the part of every hub row
//   (more than `hub_row` nonzeros) that falls in it: all threads stride the
//   part (the loads of a round issued before their x gathers), each adds a
//   round's products as a pairwise tree and the rounds in order, then a
//   fixed tree over the CTA. It finds the rows of its first and last
//   nonzero by a k-ary search of indptr, one probe per thread: a window
//   around the row a uniform spread predicts and rows at a stride in the
//   first round, strided rounds after; then it checks the lengths of the
//   rows between (kScan rows per thread per round of loads). A hub row that
//   lies in one chunk is stored; the pieces of one that crosses chunks go to
//   wrapper scratch, a ticket per row (indexed by its first chunk) counts
//   them in, and the CTA that brings the last one adds them in chunk order
//   (thread-strided sums, then a fixed tree), stores y and resets the ticket
//   to 0, so the scratch is ready for the next launch on the stream.
//
// Where no chunk CTA is launched (hub_ctas == 0: no row can be a hub, as
// with at most `hub_row` columns, or no nonzero) the entry point launches
// csr_rows_kernel, the row path alone, whose registers are then not sized
// for the chunk path. The launch comes from integers (kernels/csr.py,
// csr_launch_plan): nothing is copied from the device, nothing is prepared
// per matrix. No atomics on
// y; every sum has a fixed order, so two launches give the same bits.
//
// bf16 sums stay short. With AccBF16 every product is rounded as AccBF16
// rounds it. A row warp's lanes keep bf16 running sums, folded into a
// float32 carry after each trip that reaches a multiple of kCarryProducts of
// the row's products. A chunk CTA adds a round's bf16 products in float32
// (the pairwise tree and the thread's carry): a bf16 tree of each round's 8
// products alone left 1.7 % of max |y| on webgraph's 4,252-nonzero hub row,
// against 0.6 % for the plain version's float32 sum of the same products.
// The warp tree, the CTA tree and the pieces of a split row add float32,
// and y is rounded to bf16 once (as the plain version rounds it). So no
// bf16 running sum spans a whole row or chunk. AccF32 has no carry: its
// instructions and bits are those of a kernel without the rule.
//
// Bound on this card: bytes. Each nonzero moves 8 bytes (value, column) for
// 2 flops, plus x, indptr and y. At the served sizes latency sets the time:
// the chain indptr -> values and columns -> x -> sums of a row CTA, and for
// a hub row search -> values and columns -> x -> sums -> ticket.
//
// x is read only through the read-only path (__ldg), so where it lives is
// the split of the SM's 256 KB between L1 and shared memory. `stream_x`
// picks it per launch (the schedule's x_residency): 0 ("vmem") asks for the
// least shared memory that keeps the CTAs an SM holds with the most, so the
// rest is L1 for x; 1 ("stream") asks for the most shared memory, the least
// L1. Measured on an H100 (PERF.md): the least shared memory outright (0 %)
// cuts the CTAs an SM holds of csr_spmv_kernel, whose chunk path keeps
// ~0.6 KB of static shared memory per CTA, and was up to 22 % slower at
// human_gene2 than the driver's own choice; the most shared memory was
// 4-78 % slower.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // 8 warps
constexpr int kNoHub = 0x7fffffff;  // hub_row that makes no row a hub: no chunk CTA
constexpr int kMaxHubs = 128;     // hub rows one chunk can meet
constexpr int kRound = 8;         // nonzeros a thread loads per round of a hub part
constexpr int kScan = 4;          // rows a thread checks per round of the hub scan
// a row's products between two folds of a bf16 lane's sums into its carry
constexpr int kCarryProducts = 128;

// What adds carries (lanes, threads, chunks): float32 under AccBF16.
template <typename Acc>
using Sum = std::conditional_t<Acc::kRounds, spmv::AccF32, Acc>;

// y as the policy stores it: AccBF16 rounds the float32 total once.
template <typename Acc>
__device__ __forceinline__ float stored(float s) {
  if constexpr (Acc::kRounds) {
    return Acc::rnd(s);
  } else {
    return s;
  }
}

// Row path: the warps of a CTA take its rows one at a time.
template <typename Acc, int UNROLL>
__device__ __forceinline__ void row_block(const float* __restrict__ data,
                                          const int* __restrict__ indices,
                                          const int* __restrict__ indptr,
                                          const float* __restrict__ x, float* __restrict__ y,
                                          int n_rows, int rows_per_block, int hub_row,
                                          long long block) {
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  const int n_warps = blockDim.x / spmv::kWarp;
  const long long row0 = block * rows_per_block;
  const long long row1 = row0 + rows_per_block < n_rows ? row0 + rows_per_block : n_rows;
  for (long long row = row0 + warp; row < row1; row += n_warps) {
    const int beg = __ldg(indptr + row);
    const int end = __ldg(indptr + row + 1);
    if (end - beg > hub_row) continue;  // a hub row: the chunk CTAs add it
    float acc[UNROLL];
    float carry = 0.0f;  // AccBF16: float32 sum of the folded bf16 partials
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = 0.0f;
    for (int k = beg + lane; k < end; k += spmv::kWarp * UNROLL) {
      float d[UNROLL], xv[UNROLL];
      int c[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // a trip's loads, all in flight
        const int kk = k + u * spmv::kWarp;
        d[u] = kk < end ? __ldg(data + kk) : 0.0f;
        c[u] = kk < end ? __ldg(indices + kk) : 0;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) xv[u] = k + u * spmv::kWarp < end ? __ldg(x + c[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k + u * spmv::kWarp < end) acc[u] = Acc::fma(d[u], xv[u], acc[u]);
      }
      if constexpr (Acc::kRounds) {
        // a trip is kWarp * UNROLL of the row's products (powers of two):
        // this one reached a multiple of kCarryProducts
        constexpr int trip = spmv::kWarp * UNROLL;
        if ((k - beg - lane + trip) % kCarryProducts < trip) {
          carry += spmv::fold<Acc, UNROLL>(acc);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) acc[u] = 0.0f;
        }
      }
    }
    float v = spmv::fold<Acc, UNROLL>(acc);
    if constexpr (Acc::kRounds) v += carry;
    const float s = spmv::warp_reduce<Sum<Acc>>(v);
    if (lane == 0) y[row] = stored<Acc>(s);
  }
}

// Sum over the CTA of one value per thread: a shuffle tree per warp, then
// thread 0 adds the warps' sums as a pairwise tree (warp w and w + half,
// halves down to 1) and returns the sum (other threads: not).
template <typename Acc>
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
  v = spmv::warp_reduce<Acc>(v);
  if ((threadIdx.x & (spmv::kWarp - 1)) == 0) s_warp[threadIdx.x / spmv::kWarp] = v;
  __syncthreads();
  float tot = s_warp[0];
  if (threadIdx.x == 0) {
    float w[kMaxThreads / spmv::kWarp];
    int n = blockDim.x / spmv::kWarp;
    for (int i = 0; i < n; ++i) w[i] = s_warp[i];
    for (; n > 1; n = (n + 1) / 2) {
      const int half = (n + 1) / 2;
      for (int i = 0; i + half < n; ++i) w[i] = Acc::add(w[i], w[i + half]);
    }
    tot = w[0];
  }
  __syncthreads();
  return tot;
}

// Chunk path: the hub-row parts of nonzeros [h * chunk, (h + 1) * chunk).
template <typename Acc>
__device__ __forceinline__ void hub_chunk(const float* __restrict__ data,
                                          const int* __restrict__ indices,
                                          const int* __restrict__ indptr,
                                          const float* __restrict__ x, float* __restrict__ y,
                                          int n_rows, int nnz, int hub_row, int chunk, int h,
                                          int* __restrict__ tickets,
                                          float* __restrict__ end_part,
                                          float* __restrict__ start_part) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int k0 = (int)((long long)h * chunk);
  const int k1 = (int)min((long long)k0 + chunk, (long long)nnz);
  __shared__ int s_lo[2][2], s_hi[2][2], s_mlo[2][2], s_mhi[2][2];
  __shared__ int s_hub[kMaxHubs];
  __shared__ int s_nhub;
  __shared__ float s_warp[kMaxThreads / spmv::kWarp];
  __shared__ float s_piece[2];
  __shared__ int s_last[2];

  // ---- the rows of nonzeros k0 and k1 - 1: i = #{p : indptr[p + 1] <= k}.
  // Per key two brackets [lo, hi] of it, with indptr[lo] and indptr[hi + 1]:
  // set 0 probes a window of T rows around the row a uniform spread
  // predicts, then strided rounds; set 1 probes T rows at a stride in the
  // first round only. One probe per thread, key and set; both brackets stay
  // valid, each round searches their intersection (kept in registers,
  // the same in every thread).
  const int key[2] = {k0, k1 - 1};
  if (t < 4) {
    s_lo[t >> 1][t & 1] = 0;
    s_hi[t >> 1][t & 1] = n_rows - 1;
    s_mlo[t >> 1][t & 1] = 0;    // indptr[0]
    s_mhi[t >> 1][t & 1] = nnz;  // indptr[n_rows]
  }
  int lo[2] = {0, 0}, hi[2] = {n_rows - 1, n_rows - 1}, mlo[2] = {0, 0}, mhi[2] = {nnz, nnz};
  const float rows_per_nnz = (float)n_rows / (float)nnz;
  for (bool first = true; lo[0] < hi[0] || lo[1] < hi[1]; first = false) {
    int p[2][2], m[2][2];
    bool on[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int step = (hi[q] - lo[q] + T - 1) / T;
      int w = (int)((float)key[q] * rows_per_nnz) - T / 2;
      w = w > hi[q] - T ? hi[q] - T : w;
      w = w < lo[q] ? lo[q] : w;
      p[q][0] = first ? w + t : lo[q] + (t + 1) * step - 1;
      p[q][1] = lo[q] + (t + 1) * step - 1;
      on[q][0] = lo[q] < hi[q] && p[q][0] < hi[q];
      on[q][1] = first && lo[q] < hi[q] && p[q][1] < hi[q];
#pragma unroll
      for (int set = 0; set < 2; ++set) m[q][set] = on[q][set] ? __ldg(indptr + p[q][set] + 1) : 0;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int set = 0; set < 2; ++set) {
        // probes at or below the key: a prefix of the set's probes
        const int below = __syncthreads_count(on[q][set] && m[q][set] <= key[q]);
        const int j = on[q][set] ? t : -2;  // this thread's probe is the set's j-th
        if (j == below - 1) {
          s_lo[q][set] = p[q][set] + 1;
          s_mlo[q][set] = m[q][set];
        }
        if (j == below) {
          s_hi[q][set] = p[q][set];
          s_mhi[q][set] = m[q][set];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int a = s_lo[q][1] > s_lo[q][0], b = s_hi[q][1] < s_hi[q][0];
      lo[q] = s_lo[q][a];
      mlo[q] = s_mlo[q][a];
      hi[q] = s_hi[q][b];
      mhi[q] = s_mhi[q][b];
    }
  }
  const int ra = lo[0], rb = lo[1];  // the rows of nonzeros k0 and k1 - 1

  // ---- the hub rows among ra .. rb (their order does not change a sum)
  if (t == 0) {
    s_nhub = 0;
    if (ra == rb && mhi[0] - mlo[0] > hub_row) s_hub[s_nhub++] = ra;
  }
  __syncthreads();
  if (ra != rb) {
    for (int r0 = ra; r0 <= rb; r0 += kScan * T) {
      int rbeg[kScan], rend[kScan];
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int r = r0 + u * T + t;
        rbeg[u] = r <= rb ? __ldg(indptr + r) : 0;
        rend[u] = r <= rb ? __ldg(indptr + r + 1) : 0;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        if (rend[u] - rbeg[u] > hub_row) s_hub[atomicAdd(&s_nhub, 1)] = r0 + u * T + t;
      }
    }
    __syncthreads();
  }
  const int n_hub = s_nhub;
  // piece[0]: the end of a row begun before k0; piece[1]: a row going on past k1
  bool piece[2] = {false, false};
  int prow[2] = {0, 0};
  for (int i = 0; i < n_hub; ++i) {
    const int r = s_hub[i];
    const int rbeg = __ldg(indptr + r), rend = __ldg(indptr + r + 1);
    const int beg = rbeg > k0 ? rbeg : k0, end = rend < k1 ? rend : k1;
    float acc = 0.0f;
    for (int k = beg + t; k < end; k += T * kRound) {
      float d[kRound];
      int c[kRound];
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int kk = k + u * T;
        d[u] = kk < end ? __ldg(data + kk) : 0.0f;
        c[u] = kk < end ? __ldg(indices + kk) : 0;
      }
      float pr[kRound];
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        pr[u] = k + u * T < end ? Acc::fma(d[u], __ldg(x + c[u]), 0.0f) : 0.0f;
      }
#pragma unroll
      for (int w = kRound / 2; w > 0; w /= 2) {  // the round's products: a pairwise tree
#pragma unroll
        for (int u = 0; u < w; ++u) pr[u] = Sum<Acc>::add(pr[u], pr[u + w]);
      }
      acc = Sum<Acc>::add(acc, pr[0]);
    }
    const float s = block_sum<Sum<Acc>>(acc, s_warp);
    if (rbeg >= k0 && rend <= k1) {
      if (t == 0) y[r] = stored<Acc>(s);  // the whole row lies in this chunk
    } else {
      const int q = rend <= k1 ? 0 : 1;
      piece[q] = true;
      prow[q] = r;
      if (t == 0) s_piece[q] = s;
    }
  }
  if (!piece[0] && !piece[1]) return;  // uniform

  // ---- pieces of rows that cross chunks: ticket, and the last one adds them
  int ga[2], gb[2];  // first and last chunk of each piece's row
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    ga[q] = piece[q] ? __ldg(indptr + prow[q]) / chunk : 0;
    gb[q] = piece[q] ? (__ldg(indptr + prow[q] + 1) - 1) / chunk : 0;
  }
  if (t == 0) {
    if (piece[0]) start_part[h] = s_piece[0];
    if (piece[1]) end_part[h] = s_piece[1];
    __threadfence();
    s_last[0] = piece[0] && atomicAdd(tickets + ga[0], 1) == gb[0] - ga[0];
    s_last[1] = piece[1] && atomicAdd(tickets + ga[1], 1) == gb[1] - ga[1];
    __threadfence();
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (!s_last[q]) continue;  // uniform
    const int a = ga[q], b = gb[q], g = b - a + 1;
    float s = 0.0f;
    for (int u = t; u < g; u += T) {
      const float p = u < g - 1 ? __ldcg(end_part + a + u) : __ldcg(start_part + b);
      s = u == t ? p : Sum<Acc>::add(s, p);
    }
    s = block_sum<Sum<Acc>>(s, s_warp);
    if (t == 0) {
      y[prow[q]] = stored<Acc>(s);
      tickets[a] = 0;
    }
  }
}

template <typename Acc, int UNROLL>
__global__ void __launch_bounds__(kMaxThreads)
    csr_spmv_kernel(const float* __restrict__ data, const int* __restrict__ indices,
                    const int* __restrict__ indptr, const float* __restrict__ x,
                    float* __restrict__ y, int n_rows, int nnz, int rows_per_block,
                    int hub_row, int chunk, int hub_ctas, int* __restrict__ tickets,
                    float* __restrict__ end_part, float* __restrict__ start_part) {
  if ((int)blockIdx.x >= hub_ctas) {
    row_block<Acc, UNROLL>(data, indices, indptr, x, y, n_rows, rows_per_block, hub_row,
                           (long long)blockIdx.x - hub_ctas);
  } else {
    hub_chunk<Acc>(data, indices, indptr, x, y, n_rows, nnz, hub_row, chunk, blockIdx.x,
                   tickets, end_part, start_part);
  }
}

// A launch with no chunk CTA (no row can be a hub): the row path alone, so
// its registers are not sized for the chunk path as well.
template <typename Acc, int UNROLL>
__global__ void __launch_bounds__(kMaxThreads)
    csr_rows_kernel(const float* __restrict__ data, const int* __restrict__ indices,
                    const int* __restrict__ indptr, const float* __restrict__ x,
                    float* __restrict__ y, int n_rows, int rows_per_block) {
  row_block<Acc, UNROLL>(data, indices, indptr, x, y, n_rows, rows_per_block, kNoHub,
                         (long long)blockIdx.x);
}

constexpr int kMaxDevices = 16;
// Per device, kernel (rows only, chunk + rows), accumulator and unroll: the
// carveout (percent of the SM's shared memory) last set, -1 before any, and
// the "vmem" carveout at each warp count, 0 until computed (stored + 1).
int g_set[kMaxDevices][2][2][4];
int g_vmem[kMaxDevices][2][2][4][kMaxThreads / spmv::kWarp + 1];
bool g_init = false;
// For measurement only (spmv_csr_force_carveout): a carveout every launch
// asks for in place of the schedule's, -1 the driver's own choice; -2: none.
int g_force = -2;

// The least carveout that keeps the CTAs of `threads` threads an SM holds at
// the most shared memory: those CTAs times (static + reserved) shared bytes,
// over the SM's shared capacity, rounded up. 0 for a kernel without shared
// memory. Leaves the kernel's carveout at 100.
template <typename Kernel>
cudaError_t vmem_carveout(Kernel kernel, int threads, int* pct) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  *pct = 0;
  if (a.sharedSizeBytes == 0) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return e;
  int dev = 0, blocks = 0, per_sm = 0, reserved = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0)) !=
          cudaSuccess ||
      (e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) !=
          cudaSuccess ||
      (e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
          cudaSuccess) {
    return e;
  }
  const long long need = (long long)blocks * ((long long)a.sharedSizeBytes + reserved);
  const long long p = (100 * need + per_sm - 1) / per_sm;
  *pct = p > 100 ? 100 : (int)p;
  return cudaSuccess;
}

// Set `kernel`'s carveout for this launch (kind 0: rows only, 1: chunk +
// rows) where it differs from the one last set on this device.
template <typename Acc, int UNROLL, typename Kernel>
cudaError_t set_carveout(Kernel kernel, int kind, int warps, int stream_x) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_init) {
    for (auto& d : g_set)
      for (auto& k : d)
        for (auto& a : k)
          for (int& u : a) u = -1;
    g_init = true;
  }
  const int acc = std::is_same<Acc, spmv::AccBF16>::value ? 1 : 0;
  const int u = UNROLL == 1 ? 0 : UNROLL == 2 ? 1 : UNROLL == 4 ? 2 : 3;
  int& last = g_set[dev][kind][acc][u];
  int pct = 100;
  if (g_force != -2) {
    pct = g_force;
  } else if (!stream_x) {
    int& known = g_vmem[dev][kind][acc][u][warps];
    if (known == 0) {
      int p = 0;
      if ((e = vmem_carveout(kernel, warps * spmv::kWarp, &p)) != cudaSuccess) return e;
      last = 100;  // vmem_carveout leaves it at the most
      known = p + 1;
    }
    pct = known - 1;
  }
  if (last == pct) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
  if (e == cudaSuccess) last = pct;
  return e;
}

}  // namespace

// The launch is the plan's (kernels/csr.py, csr_launch_plan): CTAs of
// min(rows_per_block, 8) warps; ceil(nnz / chunk) chunk CTAs, then
// ceil(n_rows / rows_per_block) row CTAs; rows of more than `hub_row`
// nonzeros go to the chunk CTAs (hub_row == kNoHub: none, and no chunk
// CTA). Refuses any other launch. `tickets` (int,
// zero at the first launch; every launch leaves it zero), `end_part` and
// `start_part` (float) hold at least `hub_ctas` entries each: wrapper
// scratch, owned by one stream. `stream_x`: the L1 / shared split (above).
extern "C" int spmv_csr_launch(const void* data, const void* indices, const void* indptr,
                               const void* x, void* y, int n_rows, int nnz,
                               int rows_per_block, int unroll, int hub_row, int chunk,
                               int hub_ctas, int ctas, void* tickets, void* end_part,
                               void* start_part, int accum_bf16, int stream_x,
                               void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0 || nnz < 0 || hub_row < 1 || chunk < 1 ||
      (long long)chunk / hub_row + 2 > kMaxHubs) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_ctas = (n_rows + (long long)rows_per_block - 1) / rows_per_block;
  const int want_hub_ctas =
      hub_row == kNoHub ? 0 : (int)((nnz + (long long)chunk - 1) / chunk);
  if (hub_ctas != want_hub_ctas ||
      (long long)ctas != row_ctas + hub_ctas) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int warps = rows_per_block < 8 ? rows_per_block : 8;
  const dim3 block(warps * spmv::kWarp);
  const dim3 grid((unsigned)ctas);
  cudaError_t set = cudaSuccess;
#define LAUNCH(ACC, U)                                                                   \
  if (hub_ctas == 0) {                                                                   \
    set = set_carveout<ACC, U>(csr_rows_kernel<ACC, U>, 0, warps, stream_x);             \
    if (set != cudaSuccess) return (int)set;                                             \
    csr_rows_kernel<ACC, U><<<grid, block, 0, (cudaStream_t)stream>>>(                   \
        (const float*)data, (const int*)indices, (const int*)indptr, (const float*)x,    \
        (float*)y, n_rows, rows_per_block);                                              \
  } else {                                                                               \
    set = set_carveout<ACC, U>(csr_spmv_kernel<ACC, U>, 1, warps, stream_x);             \
    if (set != cudaSuccess) return (int)set;                                             \
    csr_spmv_kernel<ACC, U><<<grid, block, 0, (cudaStream_t)stream>>>(                   \
        (const float*)data, (const int*)indices, (const int*)indptr, (const float*)x,    \
        (float*)y, n_rows, nnz, rows_per_block, hub_row, chunk, hub_ctas, (int*)tickets, \
        (float*)end_part, (float*)start_part);                                           \
  }
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The constants the host side must agree with: the most threads per CTA,
// the most hub rows per chunk, the nonzeros a thread adds per hub round,
// a row's products between two folds of a bf16 lane's sums into its carry.
extern "C" void spmv_csr_constants(int* out) {
  out[0] = kMaxThreads;
  out[1] = kMaxHubs;
  out[2] = kRound;
  out[3] = kCarryProducts;
}

// The carveout (percent) last set on the current device for one instance
// (kind 0: rows only, 1: chunk + rows), -1 if none: what the last launch of
// that instance asked of the driver.
extern "C" int spmv_csr_carveout(int kind, int accum_bf16, int unroll, int* out) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int u = unroll == 1 ? 0 : unroll == 2 ? 1 : unroll == 4 ? 2 : unroll == 8 ? 3 : -1;
  if (dev < 0 || dev >= kMaxDevices || kind < 0 || kind > 1 || u < 0) {
    return (int)cudaErrorInvalidValue;
  }
  *out = g_init ? g_set[dev][kind][accum_bf16 ? 1 : 0][u] : -1;
  return (int)cudaSuccess;
}

// For measurement: make every launch ask for carveout `pct` (0-100, or -1:
// the driver's own choice, as before the schedule chose it) whatever its
// x_residency; -2 restores the schedule's.
extern "C" int spmv_csr_force_carveout(int pct) {
  if (pct < -2 || pct > 100) return (int)cudaErrorInvalidValue;
  g_force = pct;
  return (int)cudaSuccess;
}
