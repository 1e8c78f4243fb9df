// ELL SpMM over row-major (R, W) value/column planes and a row-major dense
// right-hand side X: (n_cols, k):
//   Y[r, j] = sum_w data[r, w] * X[cols[r, w], j],   Y: (R, k), row-major.
//
// Replaces: src/repro/kernels/ell.py  ell_spmm_pallas / _ell_spmm_kernel.
// That kernel runs a sequential (R / rows_per_block, W / nnz_tile) grid,
// keeps all of X in VMEM, gathers an (rpb, nt, k) block of X rows per step,
// contracts it with an einsum and revisits the (rpb, k) output block along
// the width axis. Here blocks run in parallel and in no order, so the width
// loop moves inside the kernel and each output row is owned by exactly one
// warp: no cross-block reduction, no atomics.
//
// Design. A CTA owns `rows_per_block` rows, one warp per row at a time. The
// warp's 32 lanes are split into `groups = 32 / kl` slot groups of `kl`
// lanes, kl = min(32, k rounded up to a power of two): lane (g, j) adds the
// slots g, g + groups, ... of the row into the output columns j, j + kl, ...
// (kCols of them per pass; passes repeat for k > 32 * kCols). Lanes load the
// row's (value, column) slots 32 at a time, coalesced, and hand each slot to
// its group with __shfl_sync; the kl lanes of a group then read kl
// consecutive floats of one X row, coalesced. A butterfly of shuffles over
// the group bits sums the groups at the end. At k = 1 this is B2's
// arithmetic (every lane its own slot, then B2's warp sum); at k >= 32 every
// lane owns output columns and walks all slots. k is a runtime argument:
// any k >= 1 is right. Padding slots hold value 0 and column 0, so reading
// them adds zero.
//
// Bound on this card: bytes. Every stored slot, padding included, moves 8
// bytes (R*W*8), X is read once (n_cols*k*4; its rows are gathered again
// per slot but mostly from L1/L2) and Y written once (R*k*4). The design
// reads each plane exactly once and coalesced, and X coalesced within a
// group. Left for a later PR: tensor cores for k >= 16 (mma.sync / wgmma
// over gathered X tiles), staging X in shared memory, skipping the padding
// tail of short rows, wider loads.
#include "common.cuh"

namespace {

constexpr int kCols = 4;  // output columns per lane per pass

template <typename Acc>
__global__ void ell_spmm_kernel(const float* __restrict__ data,
                                const int* __restrict__ cols,
                                const float* __restrict__ X,
                                float* __restrict__ Y, int n_rows, int width,
                                int k, int rows_per_block, int kl_log2) {
  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  const int n_warps = blockDim.x / spmv::kWarp;
  const int kl = 1 << kl_log2;             // lanes across the output columns
  const int groups = spmv::kWarp >> kl_log2;  // slot groups
  const int j = lane & (kl - 1);
  const int g = lane >> kl_log2;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 =
      row0 + rows_per_block < n_rows ? row0 + rows_per_block : n_rows;

  for (long long row = row0 + warp; row < row1; row += n_warps) {
    const float* __restrict__ d = data + row * width;
    const int* __restrict__ c = cols + row * width;
    float* __restrict__ y = Y + row * k;
    for (int col0 = 0; col0 < k; col0 += kl * kCols) {
      float acc[kCols];
#pragma unroll
      for (int a = 0; a < kCols; ++a) acc[a] = 0.0f;

      for (int base = 0; base < width; base += spmv::kWarp) {
        const int s = base + lane;
        const float dv = s < width ? __ldg(d + s) : 0.0f;
        const int cv = s < width ? __ldg(c + s) : 0;
        for (int t = 0; t < kl; ++t) {
          // slot t * groups + g of this 32-slot chunk goes to group g
          const int src = t * groups + g;
          const float dj = __shfl_sync(spmv::kFullMask, dv, src);
          const int cj = __shfl_sync(spmv::kFullMask, cv, src);
          const float* __restrict__ xr = X + (long long)cj * k;
#pragma unroll
          for (int a = 0; a < kCols; ++a) {
            const int col = col0 + j + a * kl;
            if (col < k) acc[a] = Acc::fma(dj, __ldg(xr + col), acc[a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        float v = acc[a];
        // halves first, as spmv::warp_reduce pairs them: at k = 1 the sum is
        // B2's (unroll 1) bit for bit
        for (int off = spmv::kWarp / 2; off >= kl; off >>= 1) {
          v = Acc::add(v, __shfl_xor_sync(spmv::kFullMask, v, off));
        }
        const int col = col0 + j + a * kl;
        if (g == 0 && col < k) y[col] = v;
      }
    }
  }
}

}  // namespace

extern "C" int spmm_ell_launch(const void* data, const void* cols,
                               const void* X, void* Y, int n_rows, int width,
                               int k, int rows_per_block, int accum_bf16,
                               void* stream) {
  if (n_rows <= 0 || k <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0 || width < 0) return (int)cudaErrorInvalidValue;
  int kl_log2 = 0;
  while ((1 << kl_log2) < k && (1 << kl_log2) < spmv::kWarp) ++kl_log2;
  const int warps = rows_per_block < 8 ? rows_per_block : 8;
  const dim3 block(warps * spmv::kWarp);
  const dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
  if (accum_bf16) {
    ell_spmm_kernel<spmv::AccBF16><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)cols, (const float*)X, (float*)Y,
        n_rows, width, k, rows_per_block, kl_log2);
  } else {
    ell_spmm_kernel<spmv::AccF32><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)cols, (const float*)X, (float*)Y,
        n_rows, width, k, rows_per_block, kl_log2);
  }
  return (int)cudaGetLastError();
}
