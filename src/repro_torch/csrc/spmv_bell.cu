// Blocked-ELL SpMV: data (nbr, mb, br, 128), block_cols (nbr, mb),
// x_panels (ncb, 128); y[i, r] = sum_j data[i, j, r, :] . x_panels[block_cols[i, j], :]
// over the live blocks j < count_i of block row i.
//
// Replaces: src/repro/kernels/bell.py  bell_spmv_pallas / _bell_kernel. That
// kernel lets the pipeline gather the x panel (a BlockSpec index map reads
// the scalar-prefetched block_cols) and runs a matrix-unit matvec per
// stored block along a sequential grid. With one right-hand side the
// product is below any tensor-core tile, so here it is multiply-and-reduce.
//
// Bound on this card: bytes. A stored block moves br * 512 bytes for
// 2 * br * 128 flops, far below the fp32 rate. The design (block_spmv.cuh,
// shared with the BCSR kernel) streams each block row's live blocks, one
// contiguous range, with TMA bulk copies into a shared-memory ring: the
// range is cut into S segments, one CTA each, launched as a cluster of S
// CTAs per block row, so the grid fills the SMs and every SM keeps up to
// kStages * 32 KB per CTA in flight. Consumer warps keep their rows'
// accumulators in registers and read each block's x panel once per lane.
// The S partials are added in rank order through distributed shared memory:
// no atomics, the same bits on every run.
//
// Padding. bell_from_dense writes each block row's real block columns in
// strictly ascending order and pads with block column 0, so the first
// j > 0 whose column is not greater than column j - 1 starts the padding;
// each CTA finds count_i from block_cols[i, :] (mb int32 reads) and never
// streams a padding block. A block row with no real block reads its one
// all-zero block. Precondition: the container comes from bell_from_dense
// (or keeps its order). Observable difference from summing every stored
// block, as the plain version does: a non-finite value in x panel 0 turns
// the padding of the reference into NaN, not this kernel's.
#include "block_spmv.cuh"

namespace {

using blockspmv::kThreads;

template <typename Acc, int BR>
__global__ void __launch_bounds__(kThreads)
    bell_spmv_kernel(const float* __restrict__ data, const int* __restrict__ block_cols,
                     const float* __restrict__ x_panels, float* __restrict__ y,
                     int max_blocks, int segments) {
  __shared__ int first_pad[kThreads / spmv::kWarp];
  const long long i = blockIdx.x / segments;
  const int s = blockIdx.x % segments;
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int* __restrict__ cols_i = block_cols + i * max_blocks;

  // count_i: the first j > 0 with cols[j] <= cols[j - 1], else max_blocks
  int first = max_blocks;
  for (int j = 1 + threadIdx.x; j < max_blocks; j += kThreads) {
    if (__ldg(cols_i + j) <= __ldg(cols_i + j - 1)) {
      first = j;
      break;
    }
  }
  first = __reduce_min_sync(spmv::kFullMask, first);
  if (lane == 0) first_pad[threadIdx.x / spmv::kWarp] = first;
  __syncthreads();
  int count = max_blocks;
#pragma unroll
  for (int w = 0; w < kThreads / spmv::kWarp; ++w) count = min(count, first_pad[w]);

  int beg, end;
  blockspmv::segment_range(count, s, segments, &beg, &end);
  const float* seg_data = data + (i * max_blocks + beg) * BR * blockspmv::kBlockCols;
  blockspmv::segment_spmv<Acc, BR>(seg_data, cols_i + beg, end - beg, x_panels, y + i * BR);
}

int bell_launch(const void* data, const void* block_cols, const void* x_panels, void* y,
                int n_block_rows, int max_blocks, int br, int accum_bf16, int segments,
                cudaStream_t stream) {
#define BELL_LAUNCH(Acc, BR)                                                               \
  return blockspmv::launch_clusters<&bell_spmv_kernel<Acc, BR>>(                          \
      BR, n_block_rows, segments, stream, (const float*)data, (const int*)block_cols,      \
      (const float*)x_panels, (float*)y, max_blocks, segments)
  BLOCK_SPMV_DISPATCH(br, accum_bf16, BELL_LAUNCH);
#undef BELL_LAUNCH
}

}  // namespace

extern "C" int spmv_bell_launch(const void* data, const void* block_cols,
                                const void* x_panels, void* y, int n_block_rows,
                                int max_blocks, int br, int bc, int accum_bf16,
                                int segments, void* stream) {
  if (n_block_rows <= 0) return (int)cudaSuccess;
  if (bc != blockspmv::kBlockCols || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int err = bell_launch(data, block_cols, x_panels, y, n_block_rows, max_blocks, br,
                              accum_bf16, segments, (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The launch plan of one (br, segments, accum) instance, into out[0:5]:
// stages, chunk bytes, dynamic shared memory per CTA, clusters of
// `segments` CTAs the device holds at once, threads per CTA.
extern "C" int spmv_bell_plan(int br, int segments, int accum_bf16, int* out) {
#define BELL_PLAN(Acc, BR) return blockspmv::plan_launch(bell_spmv_kernel<Acc, BR>, BR, segments, out)
  BLOCK_SPMV_DISPATCH(br, accum_bf16, BELL_PLAN);
#undef BELL_PLAN
}
