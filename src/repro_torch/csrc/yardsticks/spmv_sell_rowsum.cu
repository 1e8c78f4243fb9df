// Yardstick for chip_smoke.py, never built or called by the port
// (kernels/build.py builds only its listed sources): kernel B3 as it was
// before its bf16 sums were folded into a float32 carry, that is one bf16
// running sum per thread over the whole of its share of a row. Its float32
// instantiation is the served one's instruction for instruction; chip_smoke.py
// builds it beside the port's kernels and runs both on the same inputs, in
// turns, to show the same float32 bits and the bf16 error before and after.
// Built with -I src/repro_torch/csrc.
//
// SELL-C-q SpMV over ragged column-major slices: element (row r, k-th stored
// nonzero) of slice s lives at slice_ptr[s] + k * C + r, and
// y[s * C + r] = sum_{k < slice_width[s]} data[...] * x[cols[...]].
//
// Replaces: src/repro/kernels/sell.py  sell_spmv_pallas / _sell_kernel. That
// kernel drives a (slices, max_width_tiles) grid from scalar-prefetched
// tile_ptr / width_tiles, aliases out-of-range tiles to the last valid one
// and masks their compute. On a GPU a loop bound is a runtime value, so all
// of that disappears.
//
// Bound on this card: latency, then bytes. The product needs each nonzero's
// 8 bytes and x; a thread that walks its row alone (one thread per row)
// waits on a chain of dependent loads (slot, then x[col]) as long as the
// slice's stored width, and widths are padded to nnz_tile (128 at the
// default, against ~38 nonzeros per row of a FEM matrix). So the design
// splits rows, fills the card from the problem's size and stops at the
// padding:
//
// * The plan (kernels/sell.py, sell_launch_plan, integers only). P threads
//   per row: thread p * C + r of a slice takes row r's elements k = p,
//   p + P, ..., so at each step the slice's P * C threads read P * C
//   consecutive elements (coalesced). P is the most that keeps the grid
//   within ~32 warps per SM; slices share a CTA where P * C is small, and a
//   CTA is whole warps (threads past its slices idle). Each thread keeps
//   `unroll` independent accumulators (UNROLL elements per step) and loads
//   the next step's elements before this step's x gathers.
// * The padding tail. Rows store their nonzeros first and their padding
//   (value 0, column 0) after (sell_from_dense). A warp stops after the
//   first step at which every one of its threads reads padding at its last
//   element (host twin: sell_live_width, sell_slots_read); no x is gathered
//   for a padding slot. Precondition: that order. Observable difference from
//   summing every slot: a non-finite x[0] turns a padded row into NaN there,
//   not here.
// * What it reads. Given a `reads` array (one int per thread of the grid),
//   each thread writes the elements it loaded, so a run can check the stop
//   rule against its host twin (sell_slots_read); the served launch passes
//   none.
// * Fixed-order sums, no atomics. A thread folds its accumulators in order;
//   thread p = 0 of a row adds the P partials from shared memory in p order.
//   Two launches give the same bits.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <typename Acc, int UNROLL>
__global__ void __launch_bounds__(kMaxThreads)
    sell_spmv_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                     const int* __restrict__ slice_ptr, const int* __restrict__ slice_width,
                     const float* __restrict__ x, float* __restrict__ y, int n_slices, int C,
                     int P, int slices_per_cta, int* __restrict__ reads) {
  __shared__ float part[kMaxThreads];
  const int per_slice = P * C;
  const int t = threadIdx.x;
  const int local = t / per_slice;
  const int p = (t % per_slice) / C;
  const int r = t % C;
  const long long s = (long long)blockIdx.x * slices_per_cta + local;
  const bool has = local < slices_per_cta && s < n_slices;
  const long long base = has ? (long long)__ldg(slice_ptr + s) + r : 0;
  const int width = has ? __ldg(slice_width + s) : 0;
  const int wmax = __reduce_max_sync(spmv::kFullMask, width);  // the warp's loop bound
  const int step = P * UNROLL;

  float acc[UNROLL];
  float dv[UNROLL];
  int cv[UNROLL];
  int n_read = 0;  // elements this thread loaded
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    acc[u] = 0.0f;
    const int k = u * P + p;
    const long long idx = base + (long long)k * C;
    dv[u] = k < width ? __ldg(data + idx) : 0.0f;
    cv[u] = k < width ? __ldg(cols + idx) : 0;
    n_read += k < width;
  }
  for (int k0 = 0; k0 < wmax; k0 += step) {
    // every thread's last element of this step is padding: the tails began
    const bool last =
        k0 + step >= wmax || !__any_sync(spmv::kFullMask, dv[UNROLL - 1] != 0.0f);
    float d[UNROLL];
    int c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      d[u] = dv[u];
      c[u] = cv[u];
    }
    if (!last) {  // in flight while this step's gathers are
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + step + u * P + p;
        const long long idx = base + (long long)k * C;
        dv[u] = k < width ? __ldg(data + idx) : 0.0f;
        cv[u] = k < width ? __ldg(cols + idx) : 0;
        n_read += k < width;
      }
    }
    float xg[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) xg[u] = d[u] != 0.0f ? __ldg(x + c[u]) : 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (d[u] != 0.0f) acc[u] = Acc::fma(d[u], xg[u], acc[u]);
    }
    if (last) break;
  }
  if (reads != nullptr) reads[blockIdx.x * blockDim.x + t] = n_read;
  float v = spmv::fold<Acc, UNROLL>(acc);
  if (P == 1) {  // uniform over the CTA
    if (has) y[s * C + r] = v;
    return;
  }
  part[t] = v;
  __syncthreads();
  if (has && p == 0) {
    for (int q = 1; q < P; ++q) v = Acc::add(v, part[local * per_slice + q * C + r]);
    y[s * C + r] = v;
  }
}

}  // namespace

// The launch is the plan's (kernels/sell.py, sell_launch_plan): P threads per
// row, slices_per_cta slices per CTA, `threads` per CTA (the slices' threads
// rounded up to whole warps) and `ctas`. Refuses a launch that differs from
// that rule rather than picking another. `reads`: null, or one int per
// thread of the grid.
extern "C" int spmv_sell_rowsum_launch(const void* data, const void* cols, const void* slice_ptr,
                                const void* slice_width, const void* x, void* y, int n_slices,
                                int C, int unroll, int accum_bf16, int row_threads,
                                int slices_per_cta, int threads, int ctas, void* reads,
                                void* stream) {
  if (n_slices <= 0) return (int)cudaSuccess;
  if (C <= 0 || row_threads <= 0 || slices_per_cta <= 0) return (int)cudaErrorInvalidValue;
  const long long used = (long long)slices_per_cta * row_threads * C;
  if (threads % spmv::kWarp || threads > kMaxThreads || threads < used ||
      threads - used >= spmv::kWarp || ctas < 1 ||
      (long long)ctas * slices_per_cta < n_slices ||
      (long long)(ctas - 1) * slices_per_cta >= n_slices) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 block((unsigned)threads);
  const dim3 grid((unsigned)ctas);
#define LAUNCH(ACC, U)                                                                  \
  sell_spmv_kernel<ACC, U><<<grid, block, 0, (cudaStream_t)stream>>>(                   \
      (const float*)data, (const int*)cols, (const int*)slice_ptr,                      \
      (const int*)slice_width, (const float*)x, (float*)y, n_slices, C, row_threads, \
      slices_per_cta, (int*)reads)
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
