// Yardstick for chip_smoke.py, never built or called by the port
// (kernels/build.py builds only its listed sources): the single-launch fused
// composite kernel that csrc/spmv_fused.cu replaced, as it was. One CTA per
// stored tile, y zeroed by a cudaMemsetAsync before the launch, a warp
// segmented scan per 32 elements and one float atomicAdd on y per run of
// equal rows (per nonzero on a column-major SELL stream). chip_smoke.py
// builds it beside the port's kernels and times it on the same streams, so
// the old and the new design are compared within one run on one card.
// Built with -I src/repro_torch/csrc.
//
// Fused single-launch partitioned SpMV over a flat composite stream:
// y[rows[k]] += data[k] * x[cols[k]] for every element k of every flat tile
// tile_map[b], b = 0 .. n_tiles - 1; y has n_rows + 1 slots, the last one
// the spill slot that padding entries (value 0, row n_rows) point at.
//
// Replaces: src/repro/kernels/fused.py  fused_spmv_pallas / _fused_kernel.
// That kernel relies on a sequential grid: program 0 zeroes a y held in
// on-chip memory and every program scatter-adds its tile into it in turn.
// CUDA blocks run in parallel and in no order, and y (n_rows + 1 floats) is
// shared by all of them, so here:
//   * y is zeroed on the launch stream (cudaMemsetAsync in the launch
//     helper) before the kernel runs;
//   * CTA b reads its work item tile_map[b] (the prefix-sum work
//     descriptor, kept as a device array so a later schedule may reorder
//     it) and walks that tile: each warp takes 32 * UNROLL consecutive
//     elements per trip, as UNROLL coalesced sub-steps of 32;
//   * rows are NOT monotone inside a tile (SELL streams are column-major
//     within a slice, BELL streams come in panel order), so a run ends on
//     ANY change of row id: head flags (row differs from the previous lane)
//     go through __ballot_sync, each lane finds its run's first lane, and a
//     segmented Hillis-Steele scan sums the run; the run's last lane issues
//     one atomicAdd. The run still open at lane 31 is carried into the next
//     sub-step (added into lane 0 when the row continues), so a long CSR
//     row costs one atomic per 32 * UNROLL elements, not per 32;
//   * padding entries (row n_rows) are summed like any run but never
//     written.
// Float atomics make the low bits of y depend on the order CTAs finish in:
// the result varies from run to run within float rounding.
//
// Bound on this card: bytes. Each element moves 12 bytes (value, column,
// row) for 2 flops, plus the gather of x (cached). Reads of the three
// streams are coalesced 4-byte loads; atomics are one per run per trip.
// bf16 (every block asked for it): operands, products and the scan's
// partial sums rounded through the common.cuh policy, carried as float and
// combined by float atomics — the reference's ordered bf16 running sum
// cannot be reproduced under atomics.
#include "common.cuh"

namespace {

template <typename Acc, int UNROLL>
__global__ void fused_spmv_kernel(const float* __restrict__ data,
                                  const int* __restrict__ cols,
                                  const int* __restrict__ rows,
                                  const int* __restrict__ tile_map,
                                  const float* __restrict__ x,
                                  float* __restrict__ y, int tile,
                                  int n_rows) {
  constexpr int kTrip = spmv::kWarp * UNROLL;  // elements per warp trip
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  const int n_warps = blockDim.x / spmv::kWarp;
  const long long base = (long long)__ldg(tile_map + blockIdx.x) * tile;
  // bits 0..lane: the lanes at or before this one
  const unsigned upto = spmv::kFullMask >> (spmv::kWarp - 1 - lane);

  for (int trip = warp * kTrip; trip < tile; trip += n_warps * kTrip) {
    int carry_row = -1;  // warp-uniform: the run left open at lane 31
    float carry = 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int off = trip + u * spmv::kWarp + lane;
      int r = n_rows;  // beyond the tile: a zero into the spill slot
      float v = 0.0f;
      if (off < tile) {
        const long long k = base + off;
        r = __ldg(rows + k);
        v = Acc::fma(__ldg(data + k), __ldg(x + __ldg(cols + k)), 0.0f);
      }
      if (lane == 0 && carry_row >= 0) {
        if (r == carry_row) {
          v = Acc::add(carry, v);  // the open run continues here
        } else if (carry_row < n_rows) {
          atomicAdd(y + carry_row, carry);
        }
      }
      const int r_prev = __shfl_up_sync(spmv::kFullMask, r, 1);
      const bool head = lane == 0 || r != r_prev;
      const unsigned heads = __ballot_sync(spmv::kFullMask, head);
      const int start = spmv::kWarp - 1 - __clz(heads & upto);
#pragma unroll
      for (int d = 1; d < spmv::kWarp; d <<= 1) {
        const float t = __shfl_up_sync(spmv::kFullMask, v, d);
        if (lane - d >= start) v = Acc::add(v, t);
      }
      const bool tail =
          lane == spmv::kWarp - 1 || ((heads >> (lane + 1)) & 1u) != 0u;
      if (tail && lane != spmv::kWarp - 1 && r < n_rows) {
        atomicAdd(y + r, v);
      }
      carry_row = __shfl_sync(spmv::kFullMask, r, spmv::kWarp - 1);
      carry = __shfl_sync(spmv::kFullMask, v, spmv::kWarp - 1);
    }
    if (lane == 0 && carry_row >= 0 && carry_row < n_rows) {
      atomicAdd(y + carry_row, carry);
    }
  }
}

}  // namespace

extern "C" int spmv_fused_scan_launch(const void* data, const void* cols,
                                      const void* rows, const void* tile_map,
                                      const void* x, void* y, int n_tiles, int tile,
                                      int n_rows, int unroll, int accum_bf16,
                                      void* stream) {
  if (n_rows < 0 || n_tiles < 0 || tile <= 0 || tile % spmv::kWarp) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t zeroed =
      cudaMemsetAsync(y, 0, (size_t)(n_rows + 1) * sizeof(float), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const dim3 block(8 * spmv::kWarp);
  const dim3 grid((unsigned)n_tiles);
#define LAUNCH(ACC, U)                                                    \
  fused_spmv_kernel<ACC, U><<<grid, block, 0, s>>>(                       \
      (const float*)data, (const int*)cols, (const int*)rows,             \
      (const int*)tile_map, (const float*)x, (float*)y, tile, n_rows)
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
