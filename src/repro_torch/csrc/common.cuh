// Shared device helpers for the hand-written SpMV kernels (sm_90a).
//
// Accumulation policy. Every kernel is templated on an accumulator policy
// that fixes where rounding happens:
//   AccF32   products and sums in float (the compiler may fuse to FMA);
//   AccBF16  both operands, every product and every running sum are rounded
//            to bfloat16 (round-to-nearest-even) and carried as float, which
//            reproduces bf16 accumulation without bf16 registers.
// Launch helpers return cudaGetLastError() as an int; kernels launch on the
// stream they are given, never synchronise and allocate nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace spmv {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

struct AccF32 {
  __device__ __forceinline__ static float fma(float a, float b, float acc) {
    return fmaf(a, b, acc);
  }
  __device__ __forceinline__ static float add(float a, float b) { return a + b; }
};

struct AccBF16 {
  __device__ __forceinline__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ __forceinline__ static float fma(float a, float b, float acc) {
    // rnd(a) * rnd(b) is exact in float (8 + 8 significand bits)
    const float p = rnd(rnd(a) * rnd(b));
    return rnd(acc + p);
  }
  __device__ __forceinline__ static float add(float a, float b) { return rnd(a + b); }
};

// Sum over the 32 lanes of a warp; every lane must call it. Lane 0 holds
// the result.
template <typename Acc>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = Acc::add(v, __shfl_down_sync(kFullMask, v, off));
  }
  return v;
}

// Fold UNROLL independent accumulators into one.
template <typename Acc, int UNROLL>
__device__ __forceinline__ float fold(const float (&acc)[UNROLL]) {
  float s = acc[0];
#pragma unroll
  for (int u = 1; u < UNROLL; ++u) s = Acc::add(s, acc[u]);
  return s;
}

// Bulk copies into shared memory completing on mbarriers (sm_90). A wait
// that spins for kHangCycles traps: a fault in the copy protocol ends the
// launch with an error instead of hanging the card.
constexpr long long kHangCycles = 1LL << 33;  // ~5 s at the H100's clock

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kHangCycles) {
      __trap();
    }
  }
}

// 1-D bulk copy global -> this CTA's shared memory, completing on `bar`.
// dst, src and bytes must be multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace spmv

// Dispatch a runtime (accum_bf16, unroll) pair onto the template grid.
// LAUNCH(Acc, UNROLL) must expand to a kernel launch statement.
#define SPMV_DISPATCH(accum_bf16, unroll, LAUNCH)            \
  do {                                                       \
    if (accum_bf16) {                                        \
      switch (unroll) {                                      \
        case 1: LAUNCH(spmv::AccBF16, 1); break;             \
        case 2: LAUNCH(spmv::AccBF16, 2); break;             \
        case 4: LAUNCH(spmv::AccBF16, 4); break;             \
        case 8: LAUNCH(spmv::AccBF16, 8); break;             \
        default: return (int)cudaErrorInvalidValue;          \
      }                                                      \
    } else {                                                 \
      switch (unroll) {                                      \
        case 1: LAUNCH(spmv::AccF32, 1); break;              \
        case 2: LAUNCH(spmv::AccF32, 2); break;              \
        case 4: LAUNCH(spmv::AccF32, 4); break;              \
        case 8: LAUNCH(spmv::AccF32, 8); break;              \
        default: return (int)cudaErrorInvalidValue;          \
      }                                                      \
    }                                                        \
  } while (0)
