// ELL SpMM over row-major (R, W) value/column planes and a row-major dense
// right-hand side X: (n_cols, k):
//   Y[r, j] = sum_w data[r, w] * X[cols[r, w], j],   Y: (R, k), row-major.
//
// Replaces: src/repro/kernels/ell.py  ell_spmm_pallas / _ell_spmm_kernel.
// That kernel runs a sequential (R / rows_per_block, W / nnz_tile) grid,
// keeps all of X in VMEM, gathers an (rpb, nt, k) block of X rows per step,
// contracts it with an einsum and revisits the (rpb, k) output block along
// the width axis. Here the width loop is inside the kernel and the launch is
// sized by the problem, not by rows_per_block (which, with nnz_tile, only
// aligns the planes).
//
// Bound on this card: latency, then bytes. The bytes a product needs are
// small (each live slot's 8 bytes, X once, Y once: 1.5 MB for a 1,024-row
// FFN matrix at k = 16), but each slot is a chain of two dependent loads
// (the slot, then its X row), and a row is a chain of chunks. So the design
// puts many independent loads in flight and reads nothing it can skip:
//
// * The plan (kernels/ell.py, spmm_launch_plan, integers only). Lanes own
//   output columns: a group of G lanes (G = 1, 2, 4, ..., 32, a template
//   parameter, so every inner loop unrolls) multiplies one slot, each lane
//   V consecutive columns of it (V = 4, one 16-byte load, where k % 4 == 0);
//   the warp's 32 / G groups take different slots, and passes of G * V
//   columns repeat for wider k. Where R alone would leave each SM only a few
//   warps, WPR warps share a row, each over its own range of chunks; where
//   R exceeds one wave, a warp takes several rows in turn.
// * Chunks. A warp reads 32 slots at a time, one coalesced (value, column)
//   load per lane, stages them in shared memory and issues all G gathers of
//   its lanes before their FMAs. The next chunk's load is issued before the
//   gathers of this one, so the two round trips overlap.
// * The padding tail. Rows store their nonzeros first and their padding
//   (value 0, column 0) after (ell_from_dense). A warp stops after the chunk
//   that holds its row's first zero value (host twin: ell_live_width), and
//   gathers no X row for a padding slot. Precondition: that order.
//   Observable difference from summing every slot: a non-finite X[0] turns
//   a padded row into NaN there, not here.
// * What it reads. Given a `reads` array (one int per warp of the grid), each
//   warp writes the plane slots it loaded, so a run can check the stop rule
//   against its host twin (spmm_slots_read). The count is a template
//   parameter: the served launch passes no array and runs an instance
//   without counting code.
// * Fixed-order sums, no atomics. A lane adds its slots in order; the
//   groups of a warp are added by a butterfly over the group bits (at k = 1
//   this is the ELL SpMV kernel's sum at unroll 1); a split row's WPR
//   partials go through shared memory and warp 0 of the row adds them in
//   warp order. Two launches give the same bits.
//
// No tensor cores. Each row gathers its own X rows, so no B operand is
// shared by the rows of an mma tile: a tile would be a dense (rows x slots)
// block of mostly zeros, or a gather per row into shared memory first,
// which is the load this kernel already issues. TF32 inputs would also
// break the 1e-4 fp32 tolerance. X is not staged in shared memory: each CTA
// would copy all of X (196 KB at a 3,072-row X with k = 16) to use a few
// dozen of its rows, where a gather reads only those, from L2 after the
// first touch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = spmv::kWarp;  // slots a warp reads per step: one per lane
constexpr int kWarpsPerCta = 8;
constexpr int kMaxSplitCols = 128;   // a split row's partial: 32 lanes x float4
static_assert(kMaxSplitCols >= spmv::kWarp * 4, "a split row's partial: G <= 32, V <= 4");
constexpr int kBatch = 8;            // gathers a lane issues before their FMAs

struct Slot {
  float d;
  int c;
};

// V consecutive floats through the read-only path: one 16-byte load at V = 4.
template <int V>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldg(p + i);
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// No __launch_bounds__: with it ptxas held several instances to 32-48
// registers and spilled their row pointers; without, none spills.
template <typename Acc, int G, int V, bool kCount>
__global__ void ell_spmm_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                                const float* __restrict__ X, float* __restrict__ Y, int n_rows,
                                int width, int k, int warps_per_row, int rows_per_warp,
                                int* __restrict__ reads) {
  constexpr int kGroups = spmv::kWarp / G;  // slots a warp multiplies at once
  constexpr int kCols = G * V;              // output columns per pass
  constexpr int kB = G < kBatch ? G : kBatch;
  __shared__ Slot stage[kWarpsPerCta][2][kChunk];
  __shared__ float part[kWarpsPerCta][kMaxSplitCols];

  const int lane = threadIdx.x % spmv::kWarp;
  const int warp = threadIdx.x / spmv::kWarp;
  const int g = lane / G;  // slot group
  const int j = lane % G;  // columns j * V .. j * V + V - 1 of each pass
  const int piece = warp % warps_per_row;
  const int rows_at_once = kWarpsPerCta / warps_per_row;
  const int n_chunks = (width + kChunk - 1) / kChunk;
  const int c_beg = n_chunks * piece / warps_per_row;
  const int c_end = n_chunks * (piece + 1) / warps_per_row;
  const long long first_row =
      (long long)blockIdx.x * rows_at_once * rows_per_warp + warp / warps_per_row;
  int n_read = 0;  // plane slots this warp loaded (the same on every lane)

  for (int i = 0; i < rows_per_warp; ++i) {
    const long long row = first_row + (long long)i * rows_at_once;
    const bool has_row = row < n_rows;  // the same for every lane of the warp
    const float* __restrict__ d = data + row * width;
    const int* __restrict__ c = cols + row * width;
    for (int col0 = 0; col0 < k; col0 += kCols) {
      const int col = col0 + j * V;
      const bool has_col = col < k;  // V = 4 only when k % 4 == 0: all V or none
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;

      if (has_row && c_beg < c_end) {
        int s = c_beg * kChunk + lane;
        float dv = s < width ? __ldg(d + s) : 0.0f;
        int cv = s < width ? __ldg(c + s) : 0;
        for (int ch = c_beg;; ++ch) {
          if constexpr (kCount) n_read += min(kChunk, width - ch * kChunk);
          Slot* buf = stage[warp][ch & 1];
          buf[lane] = Slot{dv, cv};
          // the padding tail starts in this chunk: it is the warp's last
          const bool tail = __any_sync(spmv::kFullMask, dv == 0.0f);
          const bool last = tail || ch + 1 >= c_end;
          __syncwarp();
          if (!last) {  // in flight while this chunk's gathers are
            s += kChunk;
            dv = s < width ? __ldg(d + s) : 0.0f;
            cv = s < width ? __ldg(c + s) : 0;
          }
#pragma unroll
          for (int t0 = 0; t0 < G; t0 += kB) {
            Slot sl[kB];
            float xv[kB][V];
#pragma unroll
            for (int t = 0; t < kB; ++t) {
              sl[t] = buf[(t0 + t) * kGroups + g];
              if (has_col && sl[t].d != 0.0f) {
                load_cols<V>(X + (long long)sl[t].c * k + col, xv[t]);
              } else {
#pragma unroll
                for (int v = 0; v < V; ++v) xv[t][v] = 0.0f;
              }
            }
#pragma unroll
            for (int t = 0; t < kB; ++t) {
              if (sl[t].d != 0.0f) {
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = Acc::fma(sl[t].d, xv[t][v], acc[v]);
              }
            }
          }
          if (last) break;
        }
        __syncwarp();  // every lane's reads of the stage end before the next row writes it
      }
      // the groups' sums, halves first (spmv::warp_reduce's pairing)
#pragma unroll
      for (int off = spmv::kWarp / 2; off >= G; off >>= 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[v] = Acc::add(acc[v], __shfl_xor_sync(spmv::kFullMask, acc[v], off));
        }
      }
      if (warps_per_row == 1) {
        if (has_row && g == 0 && has_col) store_cols<V>(Y + row * k + col, acc);
        continue;
      }
      // a split row (one pass, kCols <= kMaxSplitCols): warp 0 of the row
      // adds the partials of warps 1 .. WPR - 1 in order
      if (g == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) part[warp][j * V + v] = acc[v];
      }
      __syncthreads();
      if (piece == 0 && has_row && g == 0 && has_col) {
        for (int q = 1; q < warps_per_row; ++q) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = Acc::add(acc[v], part[warp + q][j * V + v]);
        }
        store_cols<V>(Y + row * k + col, acc);
      }
      __syncthreads();
    }
  }
  if constexpr (kCount) {
    if (lane == 0) reads[blockIdx.x * kWarpsPerCta + warp] = n_read;
  }
}

template <typename Acc, int V>
int launch_lanes(int lanes, dim3 grid, cudaStream_t stream, const float* data, const int* cols,
                 const float* X, float* Y, int n_rows, int width, int k, int wpr, int rpw,
                 int* reads) {
  const dim3 block(kWarpsPerCta * spmv::kWarp);
#define LANES(G)                                                                         \
  case G:                                                                                \
    if (reads != nullptr) {                                                              \
      ell_spmm_kernel<Acc, G, V, true><<<grid, block, 0, stream>>>(                      \
          data, cols, X, Y, n_rows, width, k, wpr, rpw, reads);                          \
    } else {                                                                             \
      ell_spmm_kernel<Acc, G, V, false><<<grid, block, 0, stream>>>(                     \
          data, cols, X, Y, n_rows, width, k, wpr, rpw, nullptr);                        \
    }                                                                                    \
    break
  switch (lanes) {
    LANES(1);
    LANES(2);
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

// The launch is the plan's (kernels/ell.py, spmm_launch_plan): `lanes` per
// slot, `vec` columns per lane, `warps_per_row`, `rows_per_warp` and the
// grid, `ctas`. Refuses what the kernel cannot run, and a grid that does not
// cover the rows with exactly its last CTA partly used, rather than picking
// something else. `reads`: null, or one int per warp of the grid.
extern "C" int spmm_ell_launch(const void* data, const void* cols, const void* X, void* Y,
                               int n_rows, int width, int k, int lanes, int vec,
                               int warps_per_row, int rows_per_warp, int ctas, int accum_bf16,
                               void* reads, void* stream) {
  if (n_rows <= 0 || k <= 0) return (int)cudaSuccess;
  if (width < 0 || rows_per_warp < 1) return (int)cudaErrorInvalidValue;
  if (warps_per_row != 1 && warps_per_row != 2 && warps_per_row != 4 && warps_per_row != 8) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec == 4) {
    if (k % 4 || (reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y)) % 16) {
      return (int)cudaErrorMisalignedAddress;
    }
  } else if (vec != 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (warps_per_row > 1 && lanes * vec < k) return (int)cudaErrorInvalidValue;  // one pass
  const long long rows_per_cta = (long long)(kWarpsPerCta / warps_per_row) * rows_per_warp;
  if (ctas < 1 || (long long)ctas * rows_per_cta < n_rows ||
      (long long)(ctas - 1) * rows_per_cta >= n_rows) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)ctas);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)data;
  const int* c = (const int*)cols;
  const float* x = (const float*)X;
  float* y = (float*)Y;
  int* r = (int*)reads;
  if (accum_bf16) {
    return vec == 4 ? launch_lanes<spmv::AccBF16, 4>(lanes, grid, s, d, c, x, y, n_rows, width,
                                                     k, warps_per_row, rows_per_warp, r)
                    : launch_lanes<spmv::AccBF16, 1>(lanes, grid, s, d, c, x, y, n_rows, width,
                                                     k, warps_per_row, rows_per_warp, r);
  }
  return vec == 4 ? launch_lanes<spmv::AccF32, 4>(lanes, grid, s, d, c, x, y, n_rows, width, k,
                                                  warps_per_row, rows_per_warp, r)
                  : launch_lanes<spmv::AccF32, 1>(lanes, grid, s, d, c, x, y, n_rows, width, k,
                                                  warps_per_row, rows_per_warp, r);
}

// The constants the host plan must agree with: slots per chunk, warps per
// CTA.
extern "C" void spmm_ell_constants(int* out) {
  out[0] = kChunk;
  out[1] = kWarpsPerCta;
}
