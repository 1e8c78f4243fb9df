// Blocked-CSR SpMV: data (nb_pad, br, 128), block_cols (nb_pad,),
// block_ptr (nbr + 1,), x_panels (ncb, 128);
// y[i, r] = sum_{k in [block_ptr[i], block_ptr[i+1])} data[k, r, :] . x_panels[block_cols[k], :].
//
// Replaces: src/repro/sparse/bcsr.py  bcsr_spmv_pallas / _bcsr_kernel. That
// kernel walks the flat list of stored blocks along a sequential grid and
// scatter-adds each block's (br, 128) x (128,) product into the row of a y
// held in on-chip memory that its block_rows entry names. Blocks of a CUDA
// grid run in parallel, but the container also carries the CSR-style
// block_ptr over block rows, so here one CTA owns block row i and loops
// block_ptr[i] .. block_ptr[i+1]: it is the BELL kernel's body
// (spmv_bell.cu) with a ragged bound per block row. A warp takes row r of
// the block row; each lane loads one float4 of the stored block row and
// the matching float4 of the x panel that block_cols[k] selects (read-only
// path; the CTA's warps share the panel through L1), accumulates over the
// blocks in a register, and one shuffle tree finishes the row. No atomics,
// so the result is deterministic; an empty block row stores exact zeros;
// padding blocks (block row n_block_rows, past block_ptr[nbr]) are never
// read.
//
// Bound on this card: bytes. A stored block moves br * 512 bytes for
// 2 * br * 128 flops, far below the fp32 rate; every stored block is read
// once with 16-byte loads, fully coalesced, and the x panel costs 512 bytes
// per block from cache (x_residency "stream" and "vmem" read it the same
// way). Unlike BELL, no padding block of a short block row is read. Left
// for later: balancing block rows of very different lengths across CTAs.
#include "common.cuh"

namespace {

constexpr int kBlockCols = 128;  // bc: one float4 per lane

template <typename Acc>
__global__ void bcsr_spmv_kernel(const float* __restrict__ data,
                                 const int* __restrict__ block_cols,
                                 const int* __restrict__ block_ptr,
                                 const float* __restrict__ x_panels,
                                 float* __restrict__ y, int br) {
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  const int n_warps = blockDim.x / spmv::kWarp;
  const long long i = blockIdx.x;
  const int beg = __ldg(block_ptr + i);
  const int end = __ldg(block_ptr + i + 1);
  const float4* __restrict__ xp = reinterpret_cast<const float4*>(x_panels);
  const float4* __restrict__ d4 = reinterpret_cast<const float4*>(data);
  constexpr int kVecPerRow = kBlockCols / 4;  // 32 float4 per block row

  for (int r = warp; r < br; r += n_warps) {
    float acc = 0.0f;
    for (int k = beg; k < end; ++k) {
      const long long bcol = __ldg(block_cols + k);
      const float4 xv = __ldg(xp + bcol * kVecPerRow + lane);
      const float4 dv = __ldg(d4 + ((long long)k * br + r) * kVecPerRow + lane);
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

extern "C" int spmv_bcsr_launch(const void* data, const void* block_cols,
                                const void* block_ptr, const void* x_panels,
                                void* y, int n_block_rows, int br, int bc,
                                int accum_bf16, void* stream) {
  if (n_block_rows <= 0) return (int)cudaSuccess;
  if (bc != kBlockCols || br <= 0) return (int)cudaErrorInvalidValue;
  const int warps = br < 8 ? br : 8;
  const dim3 block(warps * spmv::kWarp);
  const dim3 grid((unsigned)n_block_rows);
  if (accum_bf16) {
    bcsr_spmv_kernel<spmv::AccBF16><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)block_cols, (const int*)block_ptr,
        (const float*)x_panels, (float*)y, br);
  } else {
    bcsr_spmv_kernel<spmv::AccF32><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)block_cols, (const int*)block_ptr,
        (const float*)x_panels, (float*)y, br);
  }
  return (int)cudaGetLastError();
}
