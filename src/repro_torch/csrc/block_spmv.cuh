// Shared Hopper body of the block-format SpMV kernels: BELL (spmv_bell.cu)
// and BCSR (spmv_bcsr.cu).
//
// Both containers store a block row's live blocks as ONE contiguous range of
// (br, 128) float blocks: BELL data[i, 0:count_i], BCSR
// data[block_ptr[i]:block_ptr[i+1]]. The product is bound by the bytes of
// those blocks (a block moves br * 512 bytes for 2 * br * 128 flops), so the
// design streams them at the memory rate and touches each byte once:
//
// * Segments and clusters. Block row i's range is cut into S segments of
//   near-equal block counts (segment s holds blocks [count*s/S,
//   count*(s+1)/S)). CTA (i, s) owns segment s; the grid is nbr * S CTAs,
//   launched as thread block clusters of S CTAs, one cluster per block row.
//   The wrapper picks S from host-side shapes (kernels/common.py,
//   block_segments): the most segments whose CTAs still fit one wave of
//   two per SM (a CTA takes ~100 KB of shared memory).
// * TMA-streamed blocks. One producer thread streams the segment's bytes
//   with 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx::bytes) in
//   chunks of 64 block rows (32 KB, less for the last) into a ring of
//   kStages stages in dynamic shared memory; chunk c lands in stage
//   c % kStages and completes on that stage's `full` mbarrier. Chunks ignore
//   block boundaries: at br <= 64 a chunk holds 64 / br whole blocks, at
//   br > 64 a block spans br / 64 chunks.
// * Consumers keep rows in registers. kConsumerWarps warps each own the
//   block rows r = k * 8 + warp (k < br / 8) and one float accumulator per
//   owned row and lane. For each block a lane loads its float4 of the x
//   panel once (x is small: L1/L2), then reads its rows' float4s from the
//   stage and runs Acc::fma; the warp releases the stage on its `empty`
//   mbarrier. The segment's block columns go to shared memory in windows of
//   kColWindow while the first chunks are in flight. After the last block,
//   one warp_reduce<Acc> per owned row gives the CTA's (br,) partial.
// * Deterministic combine. Each CTA writes its partial to shared memory,
//   then cluster.sync(); rank 0 adds the S partials read through
//   distributed shared memory (cluster.map_shared_rank) in rank order with
//   Acc::add and writes y. No atomics and no second launch: the same inputs
//   give the same bits on every run. With S = 1 the sum is the one the
//   earlier one-CTA-per-block-row kernel took.
//
// A wait that spins for kHangCycles traps: a fault in the copy protocol ends
// the launch with an error instead of hanging the card.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>

#include "common.cuh"

namespace blockspmv {

namespace cg = cooperative_groups;

constexpr int kBlockCols = 128;                      // bc
constexpr int kVecPerRow = kBlockCols / 4;           // 32 float4, one per lane
constexpr int kRowBytes = kBlockCols * 4;            // 512 bytes per block row
constexpr int kChunkRows = 64;                       // block rows per chunk
constexpr int kChunkBytes = kChunkRows * kRowBytes;  // 32 KB
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * spmv::kWarp;  // + producer warp
constexpr int kConsumerThreads = kConsumerWarps * spmv::kWarp;
constexpr int kColWindow = 512;  // block columns staged in shared memory at once
constexpr int kMaxSegments = 8;  // portable cluster size
constexpr long long kHangCycles = 1LL << 33;  // ~5 s at the H100's clock

// Dynamic shared memory: [stages][full bars][empty bars][cols][partial].
__host__ __device__ constexpr int bars_offset() { return kStages * kChunkBytes; }
__host__ __device__ constexpr int cols_offset() { return bars_offset() + 2 * kStages * 8; }
__host__ __device__ constexpr int partial_offset() { return cols_offset() + kColWindow * 4; }
__host__ __device__ constexpr int smem_bytes(int br) { return partial_offset() + br * 4; }

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

// Barrier of the consumer warps only (the producer warp does not take part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

template <typename Acc>
__device__ __forceinline__ float dot4(const float4 d, const float4 x, float acc) {
  acc = Acc::fma(d.x, x.x, acc);
  acc = Acc::fma(d.y, x.y, acc);
  acc = Acc::fma(d.z, x.z, acc);
  return Acc::fma(d.w, x.w, acc);
}

// Blocks [beg, end) of a block row of `count` blocks that segment s of S owns.
__device__ __forceinline__ void segment_range(int count, int s, int S, int* beg, int* end) {
  *beg = static_cast<int>(static_cast<long long>(count) * s / S);
  *end = static_cast<int>(static_cast<long long>(count) * (s + 1) / S);
}

// One CTA's segment: `nseg` consecutive (BR, 128) blocks at `seg_data` whose
// block columns are `seg_cols[0:nseg]`; rank 0 of the cluster writes
// y_rows[0:BR]. Every thread of the CTA must call it.
template <typename Acc, int BR>
__device__ __forceinline__ void segment_spmv(const float* __restrict__ seg_data,
                                             const int* __restrict__ seg_cols, int nseg,
                                             const float* __restrict__ x_panels,
                                             float* __restrict__ y_rows) {
  static_assert(BR % kConsumerWarps == 0 && BR >= kConsumerWarps, "br: a multiple of 8");
  static_assert(BR <= kChunkRows ? kChunkRows % BR == 0 : BR % kChunkRows == 0, "br");
  constexpr int R = BR / kConsumerWarps;                         // rows per warp
  constexpr int BPC = BR <= kChunkRows ? kChunkRows / BR : 1;    // blocks per chunk
  constexpr int CPB = BR <= kChunkRows ? 1 : BR / kChunkRows;    // chunks per block
  static_assert(kColWindow % BPC == 0, "a column window holds whole chunks");

  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars_offset());
  uint64_t* empty = full + kStages;
  int* cols = reinterpret_cast<int*>(smem + cols_offset());
  float* partial = reinterpret_cast<float*>(smem + partial_offset());

  const int lane = threadIdx.x & (spmv::kWarp - 1);
  const int warp = threadIdx.x / spmv::kWarp;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(full + k, 1);                // the producer's arrive.expect_tx
      mbar_init(empty + k, kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread streams the segment through the ring
    if (lane == 0 && nseg > 0) {
      const char* src = reinterpret_cast<const char*>(seg_data);
      const long long total = static_cast<long long>(nseg) * BR * kRowBytes;
      const long long n_chunks = (total + kChunkBytes - 1) / kChunkBytes;
      int stage = 0;
      uint32_t phase = 0;
      for (long long c = 0; c < n_chunks; ++c) {
        mbar_wait(empty + stage, phase ^ 1);  // the first round passes at once
        const long long left = total - c * kChunkBytes;
        const uint32_t bytes = static_cast<uint32_t>(left < kChunkBytes ? left : kChunkBytes);
        mbar_arrive_expect_tx(full + stage, bytes);
        bulk_copy(smem + stage * kChunkBytes, src + c * kChunkBytes, bytes, full + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: rows r = k * 8 + warp of every block, in registers
    const float4* __restrict__ xp = reinterpret_cast<const float4*>(x_panels);
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int b0 = 0; b0 < nseg;) {
      if (b0 % kColWindow == 0) {  // stage the next window of block columns
        const int n = min(kColWindow, nseg - b0);
        if (b0 > 0) consumer_sync();  // every warp is done with the last window
        for (int t = threadIdx.x; t < n; t += kConsumerThreads) cols[t] = __ldg(seg_cols + b0 + t);
        consumer_sync();
      }
      const int w0 = b0 % kColWindow;
      if constexpr (CPB == 1) {
        const int nb = min(BPC, nseg - b0);
        float4 xv[BPC];
#pragma unroll
        for (int j = 0; j < BPC; ++j) {
          xv[j] = j < nb ? __ldg(xp + static_cast<long long>(cols[w0 + j]) * kVecPerRow + lane)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        mbar_wait(full + stage, phase);
        const float4* buf = reinterpret_cast<const float4*>(smem + stage * kChunkBytes);
#pragma unroll
        for (int j = 0; j < BPC; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < R; ++k) {
              const float4 d = buf[(j * BR + k * kConsumerWarps + warp) * kVecPerRow + lane];
              acc[k] = dot4<Acc>(d, xv[j], acc[k]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        b0 += nb;
      } else {
        const float4 xv = __ldg(xp + static_cast<long long>(cols[w0]) * kVecPerRow + lane);
#pragma unroll
        for (int q = 0; q < CPB; ++q) {
          mbar_wait(full + stage, phase);
          const float4* buf = reinterpret_cast<const float4*>(smem + stage * kChunkBytes);
#pragma unroll
          for (int k = 0; k < kChunkRows / kConsumerWarps; ++k) {
            const float4 d = buf[(k * kConsumerWarps + warp) * kVecPerRow + lane];
            acc[q * (kChunkRows / kConsumerWarps) + k] =
                dot4<Acc>(d, xv, acc[q * (kChunkRows / kConsumerWarps) + k]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        b0 += 1;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float v = spmv::warp_reduce<Acc>(acc[k]);
      if (lane == 0) partial[k * kConsumerWarps + warp] = v;
    }
  }

  // ---- combine the S partials of the block row in rank order
  __syncwarp();  // the producer warp reconverges before the cluster barrier
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial is written and visible across the cluster
  if (cluster.block_rank() == 0) {
    const int S = static_cast<int>(cluster.num_blocks());
    for (int r = threadIdx.x; r < BR; r += kThreads) {
      float v = partial[r];
      for (int s = 1; s < S; ++s) v = Acc::add(v, cluster.map_shared_rank(partial, s)[r]);
      y_rows[r] = v;
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 still reads its shared memory
}

// Dispatch runtime (br, accum_bf16) onto the template grid. LAUNCH(Acc, BR)
// must expand to a statement that returns the launch's error code.
#define BLOCK_SPMV_CASE(BR, accum_bf16, LAUNCH)      \
  case BR:                                           \
    if (accum_bf16) LAUNCH(spmv::AccBF16, BR);       \
    LAUNCH(spmv::AccF32, BR)
#define BLOCK_SPMV_DISPATCH(br, accum_bf16, LAUNCH)  \
  do {                                               \
    switch (br) {                                    \
      BLOCK_SPMV_CASE(8, accum_bf16, LAUNCH);        \
      BLOCK_SPMV_CASE(16, accum_bf16, LAUNCH);       \
      BLOCK_SPMV_CASE(32, accum_bf16, LAUNCH);       \
      BLOCK_SPMV_CASE(64, accum_bf16, LAUNCH);       \
      BLOCK_SPMV_CASE(128, accum_bf16, LAUNCH);      \
      BLOCK_SPMV_CASE(256, accum_bf16, LAUNCH);      \
      default:                                       \
        return (int)cudaErrorInvalidValue;           \
    }                                                \
  } while (0)

// What a launch of `kernel` with clusters of S CTAs takes, written to
// out[0:5]: stages, chunk bytes, dynamic shared memory per CTA, clusters
// the device holds at once, threads per CTA. Raises the kernel's dynamic
// shared memory limit first. Returns a cudaError_t; cudaErrorInvalidConfiguration
// when not one cluster fits.
template <typename Kernel>
int plan_launch(Kernel kernel, int br, int S, int* out) {
  const int smem = smem_bytes(br);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = kStages;
  out[1] = kChunkBytes;
  out[2] = smem;
  out[3] = clusters;
  out[4] = kThreads;
  return clusters > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidConfiguration;
}

// Launch Kernel over nbr * S CTAs in clusters of S on `stream`; returns the
// launch's cudaError_t (the caller then checks cudaGetLastError). The plan
// (shared memory limit, cluster occupancy) is made once per kernel instance,
// device and S: cudaFuncSetAttribute raises the limit on the current device
// only, so each device gets its own plan. A device ordinal beyond the table
// and a cluster that cannot be scheduled are errors, never a fallback.
// (Every test card so far has been the only device of its machine, so the
// second device's plan has not been exercised on hardware.)
constexpr int kMaxDevices = 16;

template <auto Kernel, typename... Args>
int launch_clusters(int br, int nbr, int S, cudaStream_t stream, Args... args) {
  if (S < 1 || S > kMaxSegments || (S & (S - 1)) != 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  // per instance, device and S: 1 = planned, else the error
  static int planned[kMaxDevices][kMaxSegments + 1] = {};
  int& plan = planned[dev][S];
  if (plan == 0) {
    int out[5];
    const int err = plan_launch(Kernel, br, S, out);
    plan = err == 0 ? 1 : err;
  }
  if (plan != 1) return plan;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nbr) * static_cast<unsigned>(S));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(br);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, Kernel, args...);
}

}  // namespace blockspmv
