// CSR SpMV, vector-CSR form: y[row] = sum_k data[k] * x[indices[k]] over
// k in [indptr[row], indptr[row + 1]).
//
// Replaces: src/repro/kernels/csr.py  csr_spmv_pallas / _csr_kernel. That
// kernel walks a flat COO-tile stream along a sequential grid and carries y
// in on-chip memory with a scatter-add per tile. Nothing carries between
// CUDA blocks, and the container has indptr, so here a CTA owns
// `rows_per_block` consecutive rows and its warps take them one row at a
// time: the 32 lanes stride the row's nonzeros (coalesced reads of data and
// indices), each lane keeps `unroll` independent accumulators, a shuffle
// tree sums the warp, lane 0 stores y[row]. No atomics, so the result is
// deterministic; no row_ids, no padding, no spill slot; an empty row stores
// an exact 0.
//
// Bound on this card: bytes. Each nonzero moves 8 bytes (value + column)
// for 2 flops, plus the gathers of x, indptr and y. The design keeps the
// value/column streams coalesced and leaves x to the L1/L2 caches via the
// read-only path. Known weakness, left for a later pass: one warp per row is
// unbalanced on power-law matrices (a hub row of ~n/2 nonzeros beside rows
// of 1) and wastes lanes on rows shorter than 32.
#include "common.cuh"

namespace {

template <typename Acc, int UNROLL>
__global__ void csr_spmv_kernel(const float* __restrict__ data,
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

extern "C" int spmv_csr_launch(const void* data, const void* indices,
                               const void* indptr, const void* x, void* y,
                               int n_rows, int rows_per_block, int unroll,
                               int accum_bf16, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  const int warps = rows_per_block < 8 ? rows_per_block : 8;
  const dim3 block(warps * spmv::kWarp);
  const dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
#define LAUNCH(ACC, U)                                                      \
  csr_spmv_kernel<ACC, U><<<grid, block, 0, (cudaStream_t)stream>>>(        \
      (const float*)data, (const int*)indices, (const int*)indptr,          \
      (const float*)x, (float*)y, n_rows, rows_per_block)
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
