// SpMSpV over column-major ELL (CscEll): y[rows[c, j]] += data[c, j] *
// xvals[i] for every frontier entry i (column c = active[i]) and every
// stored slot j < col_len[c] of that column; y has n_rows + 1 slots, the last
// one the spill slot that padding (value 0, row n_rows) would point at.
//
// Replaces: src/repro/kernels/spmspv.py  csc_spmspv_pallas / _spmspv_kernel.
// That kernel runs a sequential grid (k_pad, W / nnz_tile): step (0, 0)
// zeroes a y held in on-chip memory, every step copies one width tile of
// column active[i] and scatter-adds it into y. It reads every tile of every
// active column, padding included (work ~ k * W), and pads k to a power of
// two so a solve retraces at most log2(n) kernel shapes.
//
// Bound on this card: latency, then bytes. A frontier touches few bytes
// (each live slot's value and row id, 8 bytes, and the frontier), but each
// slot is a chain of dependent loads (frontier entry, column length, slot)
// before its atomic, and a power-law matrix has hub columns: webgraph@14011
// stores 3,322 nonzeros in its longest column against a mean of 4. A warp
// that walks such a column alone takes many trips while the other SMs idle,
// and every frontier that holds the column waits for it. So:
//
// * Pieces (kernels/spmspv.py, spmspv_launch_plan, integers only, from the
//   frontier's column lengths on the host). A group of G lanes (G = 4, 8, 16
//   or 32, a template parameter; 32 / G groups per warp) owns a piece of a
//   column: group q < k owns slots [0, H) of entry q's column, and a column
//   longer than H slots gets one more group for each further piece
//   [s, s + H), listed by the plan as (entry, start). Those groups come
//   first in launch order, so hub pieces start first. The kernel loops to
//   the column's length (col_len), no scan for the padding tail: work is
//   sum(col_len[frontier]) exactly, and an entry on the spill column
//   (length 0) loads nothing.
// * Trips. Lane j of a group loads slots t + u * G + j (u < kSlots) of a
//   trip of G * kSlots slots (G consecutive slots per load, coalesced), all
//   values and row ids before any atomic, so a piece of one trip (the
//   plan's H = 8 * G) is one round trip to memory. schedule.unroll is not
//   read: every product is its own atomic, there is no accumulator chain
//   for it to split.
// * The grid. G is the most that keeps the frontier's warps within ~16 per
//   SM (a fraction of one round of resident warps): 32 lanes per column for small
//   frontiers, 4 for a whole-matrix one, whose columns hold a few nonzeros
//   each. Fewer warps per CTA where the frontier is small, so its warps
//   spread over the SMs.
// * What it reads. Given a `reads` array (one int per warp), each warp
//   writes the slots its groups loaded, so a run can check them against the
//   host twin (spmspv_pieces, spmspv_slots_read); the served launch passes
//   none and runs an instance without counting code.
// * Atomics. Columns share rows, so the scatter adds with float atomicAdd.
//   The atomics land in the order warps reach them, which changes from run
//   to run, and float addition is not associative: the low bits of y vary
//   between runs (held to 1e-4 / 3e-2 scaled). Atomics onto one address are
//   serialised where they land, in L2: a hub row (webgraph's longest row,
//   4,252 nonzeros) that a dense frontier hits takes that many one after
//   another, and at the 50 % and full frontiers that chain sets the pace.
//   The solvers send B6 frontiers below a tenth of the columns, so this
//   kernel does not add hub rows in shared memory first.
// * The frontier's copy. The served call hands over the frontier in pageable
//   host memory; the entry point copies it into the caller's pinned staging
//   buffer and from there to the device (a cudaMemcpyAsync straight from
//   pageable memory stages it through the CUDA runtime's own buffer, which
//   costs the host more). Before it writes the staging buffer it waits on
//   the caller's event, which it records after the copy: the wait is for
//   this buffer's previous copy only, never for the device or the stream
//   at large.
// y is zeroed with cudaMemsetAsync on the launch stream first. bf16:
// operands and products rounded through the common.cuh policy and combined
// by float atomics; the reference's bf16 running y cannot be reproduced
// under atomics.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kSlots = 8;  // slots a lane loads per trip
constexpr int kMaxWarpsPerCta = 8;

template <typename Acc, int G, bool kCount>
__global__ void __launch_bounds__(kMaxWarpsPerCta * spmv::kWarp)
    csc_spmspv_kernel(const float* __restrict__ data, const int* __restrict__ rows,
                      const int* __restrict__ col_len, const int* __restrict__ active,
                      const float* __restrict__ xvals, const int* __restrict__ pieces,
                      float* __restrict__ y, int k, int n_extra, int width,
                      int piece, int* __restrict__ reads) {
  constexpr int kGroups = spmv::kWarp / G;  // pieces a warp takes at once
  constexpr int kTrip = G * kSlots;         // slots a group loads per trip
  const int lane = threadIdx.x % spmv::kWarp;
  const int j = lane % G;
  const long long w =
      (long long)blockIdx.x * (blockDim.x / spmv::kWarp) + threadIdx.x / spmv::kWarp;
  const long long q = w * kGroups + lane / G;  // the group's piece
  int n_read = 0;                              // slots this lane loaded
  if (q < (long long)k + n_extra) {
    int i = (int)(q - n_extra), start = 0;  // entry i's first piece
    if (q < n_extra) {                      // a further piece of a long column
      i = __ldg(pieces + 2 * q);
      start = __ldg(pieces + 2 * q + 1);
    }
    const int c = __ldg(active + i);
    const float xv = __ldg(xvals + i);
    const int end = min(start + piece, __ldg(col_len + c));
    const long long base = (long long)c * width;
    for (int t = start; t < end; t += kTrip) {
      int r[kSlots];
      float v[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int s = t + u * G + j;
        r[u] = 0;
        v[u] = 0.0f;
        if (s < end) {
          r[u] = __ldg(rows + base + s);
          v[u] = __ldg(data + base + s);
          ++n_read;
        }
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (t + u * G + j < end) atomicAdd(y + r[u], Acc::fma(v[u], xv, 0.0f));
      }
    }
  }
  if constexpr (kCount) {  // one int per warp of the plan; the last CTA may hold more
    const int n = __reduce_add_sync(spmv::kFullMask, n_read);
    if (lane == 0 && w * kGroups < (long long)k + n_extra) reads[w] = n;
  }
}

template <typename Acc, int G>
void launch(dim3 grid, dim3 block, cudaStream_t s, const float* data, const int* rows,
            const int* col_len, const int* active, const float* xvals, const int* pieces,
            float* y, int k, int n_extra, int width, int piece, int* reads) {
  if (reads != nullptr) {
    csc_spmspv_kernel<Acc, G, true><<<grid, block, 0, s>>>(data, rows, col_len, active, xvals,
                                                           pieces, y, k, n_extra, width,
                                                           piece, reads);
  } else {
    csc_spmspv_kernel<Acc, G, false><<<grid, block, 0, s>>>(data, rows, col_len, active,
                                                            xvals, pieces, y, k, n_extra,
                                                            width, piece, nullptr);
  }
}

template <typename Acc>
int launch_lanes(int lanes, dim3 grid, dim3 block, cudaStream_t s, const float* data,
                 const int* rows, const int* col_len, const int* active, const float* xvals,
                 const int* pieces, float* y, int k, int n_extra, int width, int piece,
                 int* reads) {
#define LANES(G)                                                                  \
  case G:                                                                         \
    launch<Acc, G>(grid, block, s, data, rows, col_len, active, xvals, pieces, y, \
                   k, n_extra, width, piece, reads);                              \
    break
  switch (lanes) {
    LANES(4);
    LANES(8);
    LANES(16);
    LANES(32);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LANES
  return (int)cudaGetLastError();
}

}  // namespace

// The launch is the plan's (kernels/spmspv.py, spmspv_launch_plan): k first
// pieces and n_extra further ones, pieces of `piece` slots, `lanes` per
// piece, `warps_per_cta` warps per CTA and `ctas` CTAs. `frontier`: int32 on
// the device, [active (k) | the bits of xvals (k) | the further pieces'
// (entry, start) pairs (2 * n_extra)]; `frontier_host`: null, or the same
// ints in host memory, copied into `frontier` on the stream first through
// `pinned` (pinned host memory of at least as many ints) after a wait on
// the event `copied`, which is then recorded after the copy; the caller may
// reuse `frontier_host` at once. Zeroes y; with no piece
// (k = 0) that is all it does. Refuses a piece that is not a whole
// number of trips (lanes * kSlots) and a grid that does not cover the
// pieces with exactly its last CTA partly used. `reads`: null, or one int
// per warp.
extern "C" int spmspv_csc_launch(const void* data, const void* rows, const void* col_len,
                                 const void* frontier_host, void* pinned, void* copied,
                                 void* frontier, void* y, int k, int n_extra, int width,
                                 int n_rows, int lanes, int piece, int warps_per_cta, int ctas,
                                 int accum_bf16, void* reads, void* stream) {
  if (n_rows < 0 || k < 0 || n_extra < 0 || width <= 0) return (int)cudaErrorInvalidValue;
  if (lanes <= 0 || lanes > spmv::kWarp || piece <= 0 || piece % (lanes * kSlots)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_extra > 0 && k == 0) return (int)cudaErrorInvalidValue;
  if (warps_per_cta != 1 && warps_per_cta != 2 && warps_per_cta != 4 &&
      warps_per_cta != kMaxWarpsPerCta) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_pieces = (long long)k + n_extra;
  const long long per_cta = (long long)warps_per_cta * (spmv::kWarp / lanes);  // pieces
  if (n_pieces == 0 ? ctas != 0
                    : (ctas < 1 || (long long)ctas * per_cta < n_pieces ||
                       (long long)(ctas - 1) * per_cta >= n_pieces)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (frontier_host != nullptr && n_pieces > 0) {
    if (pinned == nullptr || copied == nullptr) return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)(2 * n_pieces) * sizeof(int);
    const cudaEvent_t done = (cudaEvent_t)copied;
    cudaError_t err = cudaEventSynchronize(done);  // the staging buffer's last copy has run
    if (err != cudaSuccess) return (int)err;
    std::memcpy(pinned, frontier_host, bytes);
    err = cudaMemcpyAsync(frontier, pinned, bytes, cudaMemcpyHostToDevice, s);
    if (err == cudaSuccess) err = cudaEventRecord(done, s);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t zeroed = cudaMemsetAsync(y, 0, (size_t)(n_rows + 1) * sizeof(float), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (n_pieces == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)ctas);
  const dim3 block((unsigned)(warps_per_cta * spmv::kWarp));
  const float* d = (const float*)data;
  const int* r = (const int*)rows;
  const int* len = (const int*)col_len;
  const int* act = (const int*)frontier;
  const float* xv = (const float*)(act + k);
  const int* pc = act + 2 * k;
  return accum_bf16 ? launch_lanes<spmv::AccBF16>(lanes, grid, block, s, d, r, len, act, xv, pc,
                                                  (float*)y, k, n_extra, width, piece,
                                                  (int*)reads)
                    : launch_lanes<spmv::AccF32>(lanes, grid, block, s, d, r, len, act, xv, pc,
                                                 (float*)y, k, n_extra, width, piece,
                                                 (int*)reads);
}

// The constants the host plan must agree with: slots a lane loads per trip
// (a piece is a whole number of trips of lanes * kSlots) and the most warps
// per CTA.
extern "C" void spmspv_csc_constants(int* out) {
  out[0] = kSlots;
  out[1] = kMaxWarpsPerCta;
}
