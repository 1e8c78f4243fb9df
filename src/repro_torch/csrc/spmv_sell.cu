// SELL-C-q SpMV over ragged column-major slices: element (row r, k-th stored
// nonzero) of slice s lives at slice_ptr[s] + k * C + r, and
// y[s * C + r] = sum_{k < slice_width[s]} data[...] * x[cols[...]].
//
// Replaces: src/repro/kernels/sell.py  sell_spmv_pallas / _sell_kernel. That
// kernel drives a (slices, max_width_tiles) grid from scalar-prefetched
// tile_ptr / width_tiles, aliases out-of-range tiles to the last valid one
// and masks their compute. On a GPU a loop bound can be a runtime value, so
// all of that disappears: one CTA per slice with C threads, thread r walks
// k < slice_width[s]; at each k the C threads read C consecutive elements,
// which is already coalesced. Each thread keeps `unroll` independent
// accumulators over k. No cross-thread reduction is needed at all.
//
// Bound on this card: bytes, 8 per stored slot plus the x gathers. The
// design reads each slot once, coalesced, and skips nothing it stored.
// Known weakness, left for later: C < 32 leaves most of a warp idle (C = 8
// uses a quarter of it) and a CTA per slice gives few resident warps for
// small C; packing several slices per CTA is the fix.
#include "common.cuh"

namespace {

template <typename Acc, int UNROLL>
__global__ void sell_spmv_kernel(const float* __restrict__ data,
                                 const int* __restrict__ cols,
                                 const int* __restrict__ slice_ptr,
                                 const int* __restrict__ slice_width,
                                 const float* __restrict__ x,
                                 float* __restrict__ y, int C) {
  const int s = blockIdx.x;
  const int r = threadIdx.x;
  if (r >= C) return;
  const long long base = (long long)__ldg(slice_ptr + s) + r;
  const int width = __ldg(slice_width + s);
  float acc[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) acc[u] = 0.0f;

  for (int k = 0; k < width; k += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (k + u < width) {
        const long long idx = base + (long long)(k + u) * C;
        acc[u] =
            Acc::fma(__ldg(data + idx), __ldg(x + __ldg(cols + idx)), acc[u]);
      }
    }
  }
  y[(long long)s * C + r] = spmv::fold<Acc, UNROLL>(acc);
}

}  // namespace

extern "C" int spmv_sell_launch(const void* data, const void* cols,
                                const void* slice_ptr, const void* slice_width,
                                const void* x, void* y, int n_slices, int C,
                                int unroll, int accum_bf16, void* stream) {
  if (n_slices <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > 1024) return (int)cudaErrorInvalidValue;
  const dim3 block(C);
  const dim3 grid((unsigned)n_slices);
#define LAUNCH(ACC, U)                                                      \
  sell_spmv_kernel<ACC, U><<<grid, block, 0, (cudaStream_t)stream>>>(       \
      (const float*)data, (const int*)cols, (const int*)slice_ptr,          \
      (const int*)slice_width, (const float*)x, (float*)y, C)
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
