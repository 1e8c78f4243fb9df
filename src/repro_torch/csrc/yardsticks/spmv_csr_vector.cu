// Yardstick for chip_smoke.py, never built or called by the port
// (kernels/build.py builds only its listed sources): the vector-CSR form of
// kernel B1 (one warp per row) that csrc/spmv_csr.cu replaced.
// chip_smoke.py builds it beside the port's kernels and times it on the same
// inputs, so the old and the new design are compared within one run on one
// card.
//
// y[row] = sum_k data[k] * x[indices[k]] over k in [indptr[row],
// indptr[row + 1]). A CTA owns `rows_per_block` consecutive rows and its
// min(rows_per_block, 8) warps take them one row at a time: the 32 lanes
// stride the row's nonzeros, each lane keeps `unroll` accumulators, a
// shuffle tree sums the warp and lane 0 stores y[row]. One warp per row
// sets the pace on a hub row. Built with -I src/repro_torch/csrc.
#include "common.cuh"

namespace {

template <typename Acc, int UNROLL>
__global__ void csr_vector_kernel(const float* __restrict__ data,
                                  const int* __restrict__ indices,
                                  const int* __restrict__ indptr,
                                  const float* __restrict__ x,
                                  float* __restrict__ y, int n_rows,
                                  int rows_per_block) {
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  const int n_warps = blockDim.x / spmv::kWarp;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 =
      row0 + rows_per_block < n_rows ? row0 + rows_per_block : n_rows;

  for (long long row = row0 + warp; row < row1; row += n_warps) {
    const int beg = __ldg(indptr + row);
    const int end = __ldg(indptr + row + 1);
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = 0.0f;

    for (int k = beg + lane; k < end; k += spmv::kWarp * UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kk = k + u * spmv::kWarp;
        if (kk < end) {
          acc[u] = Acc::fma(__ldg(data + kk), __ldg(x + __ldg(indices + kk)),
                            acc[u]);
        }
      }
    }
    const float s = spmv::warp_reduce<Acc>(spmv::fold<Acc, UNROLL>(acc));
    if (lane == 0) y[row] = s;
  }
}

}  // namespace

extern "C" int spmv_csr_vector_launch(const void* data, const void* indices,
                                      const void* indptr, const void* x, void* y,
                                      int n_rows, int rows_per_block, int unroll,
                                      int accum_bf16, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  const int warps = rows_per_block < 8 ? rows_per_block : 8;
  const dim3 block(warps * spmv::kWarp);
  const dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
#define LAUNCH(ACC, U)                                                      \
  csr_vector_kernel<ACC, U><<<grid, block, 0, (cudaStream_t)stream>>>(      \
      (const float*)data, (const int*)indices, (const int*)indptr,          \
      (const float*)x, (float*)y, n_rows, rows_per_block)
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
