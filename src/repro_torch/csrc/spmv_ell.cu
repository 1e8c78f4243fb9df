// ELL SpMV over row-major (R, W) value/column planes:
// y[r] = sum_k data[r, k] * x[cols[r, k]].
//
// Replaces: src/repro/kernels/ell.py  ell_spmv_pallas / _ell_kernel. That
// kernel runs a (R / rows_per_block, W / nnz_tile) grid, revisits the output
// block along the width axis and reads every stored slot, padding included.
// Here the width loop is inside the kernel and the launch is sized by the
// problem, not by rows_per_block (which, with nnz_tile, only aligns the
// planes).
//
// Bound on this card: latency, then bytes. The bytes a product needs are
// each live slot's 8 bytes and x, but the planes are padded to the widest
// row rounded up to nnz_tile (rim: rows of 38.5 nonzeros on average in
// planes 128 wide, 14.5 MB stored against 4.5 MB needed), and each slot is
// a chain of two dependent loads (the slot, then x[col]). So the design
// reads no padding it can skip, fills the card from the problem's size and
// keeps several loads in flight (the design of B3 and B8):
//
// * The plan (kernels/ell.py, ell_launch_plan, integers only). A group of G
//   lanes owns one row (G = 4, 8, 16 or 32, a template parameter; 32 / G
//   rows per warp, eight warps per CTA). G is the most that keeps the grid
//   within ~32 warps per SM. At each step the group reads G * UNROLL
//   consecutive slots of its row, lane j the slots j + u * G (u < UNROLL):
//   G consecutive floats or ints per load, coalesced on row-major planes.
//   Each lane keeps UNROLL independent accumulators (schedule.unroll) and
//   loads the next step's slots before this step's x gathers.
// * The padding tail. Rows store their nonzeros first and their padding
//   (value 0, column 0) after (ell_from_dense). A group stops after the step
//   that holds its row's first zero value (host twin: ell_live_width,
//   ell_slots_read) and gathers no x for a padding slot. Precondition: that
//   order. Observable difference from summing every slot: a non-finite x[0]
//   turns a padded row into NaN there, not here.
// * What it reads. Given a `reads` array (one int per warp of the grid),
//   each warp writes the plane slots it loaded, so a run can check the stop
//   rule against its host twin; the served launch passes none and runs an
//   instance without counting code.
// * Fixed-order sums, no atomics. A lane adds its slots in step order into
//   accumulator u, folds the accumulators in u order, and the group's lanes
//   are added by a butterfly over the lane bits (halves first). Two
//   launches give the same bits.
#include "common.cuh"

namespace {

constexpr int kWarpsPerCta = 8;

template <typename Acc, int G, int UNROLL, bool kCount>
__global__ void __launch_bounds__(kWarpsPerCta * spmv::kWarp)
    ell_spmv_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ y, int n_rows, int width,
                    int* __restrict__ reads) {
  constexpr int kStep = G * UNROLL;  // consecutive slots a group reads per step
  const int lane = threadIdx.x % spmv::kWarp;
  const int g = lane / G;  // the warp's row
  const int j = lane % G;  // slots j + u * G of each step
  const unsigned group =  // the group's lanes (G % 32: no shift by 32 at G = 32)
      G == spmv::kWarp ? spmv::kFullMask : ((1u << (G % spmv::kWarp)) - 1u) << (g * G);
  const long long warp = (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / spmv::kWarp;
  const long long row = warp * (spmv::kWarp / G) + g;
  const bool has = row < n_rows;  // the same for every lane of the group
  const float* __restrict__ d = data + (has ? row : 0) * width;
  const int* __restrict__ c = cols + (has ? row : 0) * width;

  float acc[UNROLL];
  float dv[UNROLL];
  int cv[UNROLL];
  int n_read = 0;  // plane slots this lane loaded
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    acc[u] = 0.0f;
    const int s = u * G + j;
    const bool ok = has && s < width;
    dv[u] = ok ? __ldg(d + s) : 0.0f;
    cv[u] = ok ? __ldg(c + s) : 0;
    n_read += ok;
  }
  bool live = has;  // the group has not yet read its row's first padding slot
  for (int s0 = 0; __any_sync(spmv::kFullMask, live); s0 += kStep) {
    float dn[UNROLL];
    int cn[UNROLL];
    bool pad = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      dn[u] = dv[u];
      cn[u] = cv[u];
      pad |= dv[u] == 0.0f;
    }
    // the group goes on where none of its lanes read padding in this step
    // (every lane votes: the ballot stays outside the short-circuit)
    const unsigned pads = __ballot_sync(spmv::kFullMask, live && pad);
    const bool more = live && !(pads & group) && s0 + kStep < width;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // in flight while this step's gathers are
      const int s = s0 + kStep + u * G + j;
      const bool ok = more && s < width;
      dv[u] = ok ? __ldg(d + s) : 0.0f;
      cv[u] = ok ? __ldg(c + s) : 0;
      n_read += ok;
    }
    float xg[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) xg[u] = dn[u] != 0.0f ? __ldg(x + cn[u]) : 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (dn[u] != 0.0f) acc[u] = Acc::fma(dn[u], xg[u], acc[u]);
    }
    live = more;
  }
  float v = spmv::fold<Acc, UNROLL>(acc);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v = Acc::add(v, __shfl_xor_sync(spmv::kFullMask, v, off));
  }
  if (has && j == 0) y[row] = v;
  if constexpr (kCount) {
    const int n = __reduce_add_sync(spmv::kFullMask, n_read);
    if (lane == 0) reads[warp] = n;
  }
}

template <typename Acc, int G>
void launch_unroll(int unroll, dim3 grid, cudaStream_t s, const float* data, const int* cols,
                   const float* x, float* y, int n_rows, int width, int* reads, int* err) {
  const dim3 block(kWarpsPerCta * spmv::kWarp);
#define UNROLL_CASE(U)                                                                     \
  case U:                                                                                  \
    if (reads != nullptr) {                                                                \
      ell_spmv_kernel<Acc, G, U, true><<<grid, block, 0, s>>>(data, cols, x, y, n_rows,    \
                                                              width, reads);               \
    } else {                                                                               \
      ell_spmv_kernel<Acc, G, U, false><<<grid, block, 0, s>>>(data, cols, x, y, n_rows,   \
                                                               width, nullptr);            \
    }                                                                                      \
    break
  switch (unroll) {
    UNROLL_CASE(1);
    UNROLL_CASE(2);
    UNROLL_CASE(4);
    UNROLL_CASE(8);
    default:
      *err = (int)cudaErrorInvalidValue;
  }
#undef UNROLL_CASE
}

template <typename Acc>
void launch_lanes(int lanes, int unroll, dim3 grid, cudaStream_t s, const float* data,
                  const int* cols, const float* x, float* y, int n_rows, int width, int* reads,
                  int* err) {
  switch (lanes) {
    case 4:
      launch_unroll<Acc, 4>(unroll, grid, s, data, cols, x, y, n_rows, width, reads, err);
      break;
    case 8:
      launch_unroll<Acc, 8>(unroll, grid, s, data, cols, x, y, n_rows, width, reads, err);
      break;
    case 16:
      launch_unroll<Acc, 16>(unroll, grid, s, data, cols, x, y, n_rows, width, reads, err);
      break;
    case 32:
      launch_unroll<Acc, 32>(unroll, grid, s, data, cols, x, y, n_rows, width, reads, err);
      break;
    default:
      *err = (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch is the plan's (kernels/ell.py, ell_launch_plan): `lanes` per
// row and the grid, `ctas`. Refuses a grid that does not cover the rows with
// exactly its last CTA partly used, rather than picking another. `reads`:
// null, or one int per warp of the grid.
extern "C" int spmv_ell_launch(const void* data, const void* cols, const void* x, void* y,
                               int n_rows, int width, int lanes, int ctas, int unroll,
                               int accum_bf16, void* reads, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (width <= 0 || lanes <= 0 || lanes > spmv::kWarp) return (int)cudaErrorInvalidValue;
  const long long rows_per_cta = (long long)kWarpsPerCta * (spmv::kWarp / lanes);
  if (ctas < 1 || (long long)ctas * rows_per_cta < n_rows ||
      (long long)(ctas - 1) * rows_per_cta >= n_rows) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)ctas);
  const cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaSuccess;
  if (accum_bf16) {
    launch_lanes<spmv::AccBF16>(lanes, unroll, grid, s, (const float*)data, (const int*)cols,
                                (const float*)x, (float*)y, n_rows, width, (int*)reads, &err);
  } else {
    launch_lanes<spmv::AccF32>(lanes, unroll, grid, s, (const float*)data, (const int*)cols,
                               (const float*)x, (float*)y, n_rows, width, (int*)reads, &err);
  }
  return err != (int)cudaSuccess ? err : (int)cudaGetLastError();
}

// The constant the host plan must agree with: warps per CTA.
extern "C" void spmv_ell_constants(int* out) { out[0] = kWarpsPerCta; }
