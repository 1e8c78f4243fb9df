// Blocked-ELL SpMV: data (nbr, mb, br, 128), block_cols (nbr, mb),
// x_panels (ncb, 128); y[i, r] = sum_j data[i, j, r, :] . x_panels[block_cols[i, j], :].
//
// Replaces: src/repro/kernels/bell.py  bell_spmv_pallas / _bell_kernel. That
// kernel lets the pipeline gather the x panel (a BlockSpec index map reads
// the scalar-prefetched block_cols) and runs a matrix-unit matvec per
// stored block. With a single right-hand side the product is below any
// tensor-core tile, so here it is multiply-and-reduce: one CTA per block
// row; a warp takes row r of the block row and walks the mb stored blocks,
// reading block_cols[i, j] itself. A block row is 128 contiguous floats, so
// each lane loads one float4 of the block and the matching float4 of the x
// panel (read-only path; the CTA's warps share the panel through L1),
// accumulates over j in registers, and one shuffle tree per output row
// finishes the sum. Padding blocks are all-zero with block column 0 and
// need no mask.
//
// Bound on this card: bytes. A stored block moves br * 512 bytes for
// 2 * br * 128 flops, far below the fp32 rate. The design reads every block
// once with 16-byte loads, fully coalesced; the x panel costs 512 bytes per
// block from cache. `unroll` is not used: the four lanes-wide products of a
// float4 are already independent. Left for later: several right-hand sides
// (then tensor cores apply) and skipping padding blocks.
#include "common.cuh"

namespace {

constexpr int kBlockCols = 128;  // bc: one float4 per lane

template <typename Acc>
__global__ void bell_spmv_kernel(const float* __restrict__ data,
                                 const int* __restrict__ block_cols,
                                 const float* __restrict__ x_panels,
                                 float* __restrict__ y, int max_blocks,
                                 int br) {
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  const int n_warps = blockDim.x / spmv::kWarp;
  const long long i = blockIdx.x;
  const int* __restrict__ bcols = block_cols + i * max_blocks;
  const float4* __restrict__ xp = reinterpret_cast<const float4*>(x_panels);
  const float4* __restrict__ d4 = reinterpret_cast<const float4*>(data);
  constexpr int kVecPerRow = kBlockCols / 4;  // 32 float4 per block row

  for (int r = warp; r < br; r += n_warps) {
    float acc = 0.0f;
    for (int j = 0; j < max_blocks; ++j) {
      const long long bcol = __ldg(bcols + j);
      const float4 xv = __ldg(xp + bcol * kVecPerRow + lane);
      const float4 dv =
          __ldg(d4 + ((i * max_blocks + j) * br + r) * kVecPerRow + lane);
      acc = Acc::fma(dv.x, xv.x, acc);
      acc = Acc::fma(dv.y, xv.y, acc);
      acc = Acc::fma(dv.z, xv.z, acc);
      acc = Acc::fma(dv.w, xv.w, acc);
    }
    acc = spmv::warp_reduce<Acc>(acc);
    if (lane == 0) y[i * br + r] = acc;
  }
}

}  // namespace

extern "C" int spmv_bell_launch(const void* data, const void* block_cols,
                                const void* x_panels, void* y,
                                int n_block_rows, int max_blocks, int br,
                                int bc, int accum_bf16, void* stream) {
  if (n_block_rows <= 0) return (int)cudaSuccess;
  if (bc != kBlockCols || br <= 0 || max_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int warps = br < 8 ? br : 8;
  const dim3 block(warps * spmv::kWarp);
  const dim3 grid((unsigned)n_block_rows);
  if (accum_bf16) {
    bell_spmv_kernel<spmv::AccBF16><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)block_cols, (const float*)x_panels,
        (float*)y, max_blocks, br);
  } else {
    bell_spmv_kernel<spmv::AccF32><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)block_cols, (const float*)x_panels,
        (float*)y, max_blocks, br);
  }
  return (int)cudaGetLastError();
}
