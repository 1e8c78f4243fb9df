// Yardstick for chip_smoke.py, never built or called by the port
// (kernels/build.py builds only its listed sources): the warp-per-row form
// of kernel B2 that csrc/spmv_ell.cu replaced, as it was. It reads every
// stored slot, padding included, and its grid is rows_per_block.
// chip_smoke.py builds it beside the port's kernels and times it on the same
// inputs, so the old and the new design are compared within one run on one
// card. Built with -I src/repro_torch/csrc.
//
// ELL SpMV over row-major (R, W) value/column planes:
// y[r] = sum_k data[r, k] * x[cols[r, k]].
//
// Replaces: src/repro/kernels/ell.py  ell_spmv_pallas / _ell_kernel. That
// kernel runs a (R / rows_per_block, W / nnz_tile) grid and revisits the
// output block along the width axis. Here the width loop is inside the
// kernel: a CTA owns `rows_per_block` rows, a warp takes one row at a time
// and its lanes stride the width, which is the coalesced access for
// row-major planes (32 consecutive floats / ints per warp load). Each lane
// keeps `unroll` independent accumulators; a shuffle tree sums the warp.
// Padding slots hold value 0 and column 0, so the gather needs no mask.
//
// Bound on this card: bytes. Every stored slot, padding included, moves 8
// bytes; x gathers go through the read-only path and mostly hit L1/L2. The
// design reads each plane exactly once, coalesced. Left for later: a
// column-major plane with one thread per row, vector loads, skipping the
// all-padding tail of short rows.
#include "common.cuh"

namespace {

template <typename Acc, int UNROLL>
__global__ void ell_spmv_kernel(const float* __restrict__ data,
                                const int* __restrict__ cols,
                                const float* __restrict__ x,
                                float* __restrict__ y, int n_rows, int width,
                                int rows_per_block) {
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  const int n_warps = blockDim.x / spmv::kWarp;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 =
      row0 + rows_per_block < n_rows ? row0 + rows_per_block : n_rows;

  for (long long row = row0 + warp; row < row1; row += n_warps) {
    const float* __restrict__ d = data + row * width;
    const int* __restrict__ c = cols + row * width;
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = 0.0f;

    for (int k = lane; k < width; k += spmv::kWarp * UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kk = k + u * spmv::kWarp;
        if (kk < width) {
          acc[u] = Acc::fma(__ldg(d + kk), __ldg(x + __ldg(c + kk)), acc[u]);
        }
      }
    }
    const float s = spmv::warp_reduce<Acc>(spmv::fold<Acc, UNROLL>(acc));
    if (lane == 0) y[row] = s;
  }
}

}  // namespace

extern "C" int spmv_ell_warp_launch(const void* data, const void* cols,
                                    const void* x, void* y, int n_rows, int width,
                                    int rows_per_block, int unroll, int accum_bf16,
                                    void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  const int warps = rows_per_block < 8 ? rows_per_block : 8;
  const dim3 block(warps * spmv::kWarp);
  const dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
#define LAUNCH(ACC, U)                                                      \
  ell_spmv_kernel<ACC, U><<<grid, block, 0, (cudaStream_t)stream>>>(        \
      (const float*)data, (const int*)cols, (const float*)x, (float*)y,     \
      n_rows, width, rows_per_block)
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
