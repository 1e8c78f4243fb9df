// Blocked-CSR SpMV: data (nb_pad, br, 128), block_cols (nb_pad,),
// block_ptr (nbr + 1,), x_panels (ncb, 128);
// y[i, r] = sum_{k in [block_ptr[i], block_ptr[i+1])} data[k, r, :] . x_panels[block_cols[k], :].
//
// Replaces: src/repro/sparse/bcsr.py  bcsr_spmv_pallas / _bcsr_kernel. That
// kernel walks the flat list of stored blocks along a sequential grid and
// scatter-adds each block's (br, 128) x (128,) product into the row of a y
// held in on-chip memory that its block_rows entry names. Blocks of a CUDA
// grid run in parallel, so here the CSR-style block_ptr over block rows
// gives each block row its contiguous range of blocks.
//
// Bound on this card: bytes. A stored block moves br * 512 bytes for
// 2 * br * 128 flops, far below the fp32 rate. The design is the BELL
// kernel's (block_spmv.cuh) with a ragged range per block row: the range
// block_ptr[i] .. block_ptr[i+1] is cut into S segments, one CTA each,
// launched as a cluster of S CTAs per block row; a producer thread streams
// the segment with TMA bulk copies into a shared-memory ring, consumer
// warps keep their rows in registers and read each block's x panel once
// per lane, and the S partials are added in rank order through distributed
// shared memory. No atomics, so the result is deterministic; an empty block
// row stores exact zeros; padding blocks (block row n_block_rows, past
// block_ptr[nbr]) are never read. S comes from the mean blocks per row, so
// a block row far longer than the mean still sets the pace (no balancing
// across block rows).
#include "block_spmv.cuh"

namespace {

using blockspmv::kThreads;

template <typename Acc, int BR>
__global__ void __launch_bounds__(kThreads)
    bcsr_spmv_kernel(const float* __restrict__ data, const int* __restrict__ block_cols,
                     const int* __restrict__ block_ptr, const float* __restrict__ x_panels,
                     float* __restrict__ y, int segments) {
  const long long i = blockIdx.x / segments;
  const int s = blockIdx.x % segments;
  const int row_beg = __ldg(block_ptr + i);
  const int row_end = __ldg(block_ptr + i + 1);
  int beg, end;
  blockspmv::segment_range(row_end - row_beg, s, segments, &beg, &end);
  const long long first = static_cast<long long>(row_beg) + beg;
  const float* seg_data = data + first * BR * blockspmv::kBlockCols;
  blockspmv::segment_spmv<Acc, BR>(seg_data, block_cols + first, end - beg, x_panels,
                                   y + i * BR);
}

int bcsr_launch(const void* data, const void* block_cols, const void* block_ptr,
                const void* x_panels, void* y, int n_block_rows, int br, int accum_bf16,
                int segments, cudaStream_t stream) {
#define BCSR_LAUNCH(Acc, BR)                                                               \
  return blockspmv::launch_clusters<&bcsr_spmv_kernel<Acc, BR>>(                          \
      BR, n_block_rows, segments, stream, (const float*)data, (const int*)block_cols,      \
      (const int*)block_ptr, (const float*)x_panels, (float*)y, segments)
  BLOCK_SPMV_DISPATCH(br, accum_bf16, BCSR_LAUNCH);
#undef BCSR_LAUNCH
}

}  // namespace

extern "C" int spmv_bcsr_launch(const void* data, const void* block_cols,
                                const void* block_ptr, const void* x_panels, void* y,
                                int n_block_rows, int br, int bc, int accum_bf16,
                                int segments, void* stream) {
  if (n_block_rows <= 0) return (int)cudaSuccess;
  if (bc != blockspmv::kBlockCols) return (int)cudaErrorInvalidValue;
  const int err = bcsr_launch(data, block_cols, block_ptr, x_panels, y, n_block_rows, br,
                              accum_bf16, segments, (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The launch plan of one (br, segments, accum) instance, into out[0:5]:
// stages, chunk bytes, dynamic shared memory per CTA, clusters of
// `segments` CTAs the device holds at once, threads per CTA.
extern "C" int spmv_bcsr_plan(int br, int segments, int accum_bf16, int* out) {
#define BCSR_PLAN(Acc, BR) return blockspmv::plan_launch(bcsr_spmv_kernel<Acc, BR>, BR, segments, out)
  BLOCK_SPMV_DISPATCH(br, accum_bf16, BCSR_PLAN);
#undef BCSR_PLAN
}
