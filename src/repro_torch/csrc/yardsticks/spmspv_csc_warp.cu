// Yardstick for chip_smoke.py, never built or called by the port
// (kernels/build.py builds only its listed sources): the warp-per-entry form
// of kernel B6 that csrc/spmspv_csc.cu replaced, as it was (its wrapper
// copied the frontier with two pageable host-to-device copies). One warp
// walks a whole frontier column, so a hub column sets the pace.
// chip_smoke.py builds it beside the port's kernels and times it on the same
// inputs, so the old and the new design are compared within one run on one
// card. Built with -I src/repro_torch/csrc.
//
// SpMSpV over column-major ELL (CscEll): y[rows[c, j]] += data[c, j] *
// xvals[i] for every frontier entry i (column c = active[i]) and every
// stored slot j of that column; y has n_rows + 1 slots, the last one the
// spill slot that padding (value 0, row n_rows) would point at.
//
// Replaces: src/repro/kernels/spmspv.py  csc_spmspv_pallas / _spmspv_kernel.
// That kernel runs a sequential grid (k_pad, W / nnz_tile): step (0, 0)
// zeroes a y held in on-chip memory, every step copies one width tile of
// column active[i] and scatter-adds it into y. It reads every tile of every
// active column, padding included (work ~ k * W), and pads k to a power of
// two so a solve retraces at most log2(n) kernel shapes. On the card:
//   * y is zeroed with cudaMemsetAsync on the launch stream, then one warp
//     owns one frontier entry i < k (k is a runtime argument: no power-of-two
//     padding, no retrace); eight warps per CTA;
//   * the warp walks its column in trips of 32 * UNROLL slots, lanes on
//     neighbouring slots (coalesced int32 row ids; the value is loaded only
//     for a real slot), and atomicAdds value * xvals[i] into y[row] — columns
//     share rows, so the scatter needs atomics;
//   * padding is a contiguous tail of every column (csc_from_dense packs the
//     nonzeros first), so the warp stops after the first trip that holds a
//     padding slot, found warp-uniformly with __any_sync: work is
//     ~ sum(col_nnz[frontier]) rounded up to a trip per column, not k * W.
//     A frontier entry pointing at the spill column (all padding) costs one
//     trip and contributes nothing.
// Float atomics make the low bits of y depend on the order warps finish in:
// the result varies from run to run within float rounding. Hub rows (rows
// that many active columns hit) serialise on their atomics.
//
// Bound on this card: bytes. Each real nonzero moves 8 bytes (value, row id)
// for 2 flops; the frontier adds 8 bytes per entry, y 4 bytes per row.
// bf16: operands and products rounded through the common.cuh policy and
// combined by float atomics — the reference's bf16 running y cannot be
// reproduced under atomics.
#include "common.cuh"

namespace {

constexpr int kWarpsPerCta = 8;

template <typename Acc, int UNROLL>
__global__ void csc_spmspv_kernel(const float* __restrict__ data,
                                  const int* __restrict__ rows,
                                  const int* __restrict__ active,
                                  const float* __restrict__ xvals,
                                  float* __restrict__ y, int k, int width,
                                  int n_rows) {
  constexpr int kTrip = spmv::kWarp * UNROLL;  // slots per warp trip
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const long long i =
      (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / spmv::kWarp;
  if (i >= k) return;  // warp-uniform: the whole warp leaves
  const long long base = (long long)__ldg(active + i) * width;
  const float xv = __ldg(xvals + i);

  for (int t = 0; t < width; t += kTrip) {
    int r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = t + u * spmv::kWarp + lane;
      r[u] = j < width ? __ldg(rows + base + j) : n_rows;
    }
    bool pad = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r[u] < n_rows) {
        const float v = __ldg(data + base + t + u * spmv::kWarp + lane);
        atomicAdd(y + r[u], Acc::fma(v, xv, 0.0f));
      } else {
        pad = true;
      }
    }
    if (__any_sync(spmv::kFullMask, pad)) break;  // the padding tail began
  }
}

}  // namespace

extern "C" int spmspv_csc_warp_launch(const void* data, const void* rows,
                                      const void* active, const void* xvals,
                                      void* y, int k, int width, int n_rows,
                                      int unroll, int accum_bf16, void* stream) {
  if (n_rows < 0 || k < 0 || width <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t zeroed =
      cudaMemsetAsync(y, 0, (size_t)(n_rows + 1) * sizeof(float), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (k == 0) return (int)cudaGetLastError();
  const dim3 block(kWarpsPerCta * spmv::kWarp);
  const dim3 grid((unsigned)((k + kWarpsPerCta - 1) / kWarpsPerCta));
#define LAUNCH(ACC, U)                                                     \
  csc_spmspv_kernel<ACC, U><<<grid, block, 0, s>>>(                        \
      (const float*)data, (const int*)rows, (const int*)active,            \
      (const float*)xvals, (float*)y, k, width, n_rows)
  SPMV_DISPATCH(accum_bf16, unroll, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
