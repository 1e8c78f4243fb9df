// Fused single-launch partitioned SpMV over a flat composite stream:
// y[rows[k]] += data[k] * x[cols[k]] for every element k of every flat tile
// tile_map[b]; y has n_rows + 1 slots, the last one the spill slot that
// padding entries (value 0, row n_rows) point at.
//
// Replaces: src/repro/kernels/fused.py  fused_spmv_pallas / _fused_kernel.
// That kernel relies on a sequential grid: program 0 zeroes a y held in
// on-chip memory and every program scatter-adds its tile into it in turn.
// CUDA blocks run in parallel and in no order, and rows are not monotone in
// the stream (SELL slices are column-major, so 32 consecutive elements
// belong to 32 rows; BELL streams come in panel order). Adding each run of
// equal rows to y with a float atomic (the design this replaced; its times
// are in PERF.md) costs one global atomic per nonzero
// on a SELL stream, a memset of y before every launch, and one CTA per
// stored tile. Here:
//
// * The plan (kernels/fused.py, fused_launch_plan, integers only, built
//   once on the host) cuts the stream into pieces, each a sub-range of one
//   tile_map entry, sized from the stream length and the SM count and cut
//   wherever its row window (max row - min row + 1, padding rows excluded)
//   would exceed kWindow. CTA b owns piece b.
// * Row windows in shared memory. Each warp owns a private slice of the
//   window (kWindow floats). Per sub-step of 32 elements a warp forms its
//   products, sums runs of equal consecutive rows with a segmented
//   Hillis-Steele scan, and adds each run's sum into its slice. One row can
//   end two runs of a sub-step only where rows decrease between them (a
//   SELL slice's next column, a BELL block row's next panel): the stretches
//   between decreases add in turn, in lane order, so each row's runs add
//   into the slice in lane order (__match_any_sync, which finds such rows
//   directly, cost more than all the rest of the sums, even where no row
//   repeats). Where each lane holds one row in all kSteps sub-steps of a
//   trip (SELL columns with every row of the slice live, long rows), a lane
//   first adds its kSteps products in registers, and the warp takes one
//   sub-step's sums instead of kSteps (carrying such sums on from trip to
//   trip was slower). A warp takes its sub-steps in order;
//   the epilogue adds the kWarps slices of a row in warp order. So every
//   sum has a fixed order: two launches give the same bits.
// * No memset and no float atomics on y. A row that one piece alone touches
//   is stored by it. A row shared by several pieces belongs to a group (the
//   rows touched by the same set of pieces); each piece stores its partial
//   at the slot the plan gives it in wrapper scratch, takes the group's
//   ticket (an integer atomic), and the last one in adds the partials in
//   piece order, stores y and resets the ticket to 0, so the scratch is
//   ready for the next launch on the stream (B1's chunk mechanism). Rows no
//   piece touches, and the spill slot n_rows, are stored as 0 by the piece
//   the plan names (zero run z: piece z mod n_pieces). y comes from
//   torch.empty.
// * Loads in flight. A trip is kSteps sub-steps per warp (kTrip = kThreads *
//   kSteps elements per CTA; warp w takes its kSteps * 32 consecutive
//   elements). One thread streams the piece's values,
//   columns and window rows into a ring of kStages slots in shared memory
//   with 1-D bulk copies (cp.async.bulk, completing on an mbarrier per
//   slot), widened to 16-byte units (kAlign elements; the elements outside
//   the piece are masked), and refills a slot once every warp has summed
//   it: kStages trips (18 KB) per CTA are in flight while the warps gather x
//   and sum. Holding the next trip in registers instead left each CTA
//   latency-bound at human_gene2; three or four slots (more shared memory
//   per CTA, less L1 for x) were slower there than two. The schedule's
//   `unroll` is checked and not read.
// * Rows as window offsets. The plan gives each element's row as a byte:
//   its offset into the piece's window (kPadRow for padding), so a window
//   holds at most kWindow rows; the kernel reads those instead of the 4-byte
//   row ids: 9 bytes per element (the 4-byte ids and 2-byte offsets were
//   slower at human_gene2: the stream is bound by bytes there).
// * What it writes. Given a `writes` array (one int per CTA), each CTA
//   stores the number of its global stores (y and partials), so a run can
//   check them against the plan's count; the served launch passes none.
//
// Bound on this card: bytes for a large stream (each element moves 9 bytes,
// value, column and window row, for 2 flops, plus the gather of x, cached),
// latency for a small one (the chain plan -> stream -> x -> sums -> ticket;
// pieces of at least kThreads elements, enough of them to fill the card).
// bf16 (every block asked for it): operands, products, scan sums, window
// sums and the piece-order combination rounded through the common.cuh
// policy; the reference carries y in bf16 from tile to tile instead.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / spmv::kWarp;
constexpr int kWindow = 255;  // rows of a piece's window: byte offsets, 0xFF for padding
constexpr int kSteps = 4;     // sub-steps of 32 elements per warp and trip
constexpr int kStages = 2;    // trips of a piece in flight in shared memory
constexpr int kCtasPerSm = 4;  // resident CTAs the registers must allow (<= 64 each)
constexpr int kPieceInts = 8;  // start, live, rlo, width, table, group begin, group end, 0
constexpr int kGroupInts = 4;  // row offset, rows, pieces, scratch base
constexpr int kDirect = -1;    // table code: this piece stores the row
constexpr int kSkip = -2;      // table code: this piece does not touch the row
constexpr int kPadRow = 0xFF;  // window row of a padding element
constexpr int kRowsPerThread = (kWindow + kThreads - 1) / kThreads;

// One sub-step of a warp: lane holds window row `local` and product `v`
// (valid: a real element). Adds the sub-step into the warp's slice `win`.
// Runs of equal consecutive rows are summed by a segmented scan; the run
// tails of a stretch of lanes whose rows do not decrease hold distinct rows,
// so each stretch is one round of read-add-store into the slice, the
// stretches in lane order (a SELL column starting again makes a new one).
template <typename Acc>
__device__ __forceinline__ void add_step(float* __restrict__ win, int local, float v,
                                         bool valid, int lane, unsigned upto) {
  const int key = valid ? local : kWindow;  // padding: after every row
  const int prev = __shfl_up_sync(spmv::kFullMask, key, 1);
  const unsigned heads = __ballot_sync(spmv::kFullMask, lane == 0 || key != prev);
  const unsigned drops = __ballot_sync(spmv::kFullMask, lane > 0 && key < prev);
  const int first = spmv::kWarp - 1 - __clz(heads & upto);
  const int longest = __reduce_max_sync(spmv::kFullMask, lane - first);  // lanes before a tail
#pragma unroll
  for (int d = 1; d < spmv::kWarp; d <<= 1) {
    if (d > longest) break;  // warp-uniform: a SELL column's rows are runs of one
    const float t = __shfl_up_sync(spmv::kFullMask, v, d);
    if (lane - d >= first) v = Acc::add(t, v);
  }
  const bool tail =
      valid && (lane == spmv::kWarp - 1 || ((heads >> (lane + 1)) & 1u) != 0u);
  if (drops == 0u) {
    if (tail) win[local] = Acc::add(win[local], v);
  } else {
    const int stretch = __popc(drops & upto);
    for (int s = 0; s <= __popc(drops); ++s) {
      if (tail && stretch == s) win[local] = Acc::add(win[local], v);
      __syncwarp();
    }
  }
  __syncwarp();
}

constexpr int kTrip = kThreads * kSteps;  // elements per CTA trip
constexpr int kAlign = 16;  // elements per 16 bytes of window rows: the bulk copies' unit

// A piece's trips stream through kStages slots; the window is per warp.
struct Shared {
  float data[kStages][kTrip];
  int cols[kStages][kTrip];
  unsigned char wrows[kStages][kTrip];
  float win[kWarps][kWindow];
  uint64_t full[kStages];  // one per slot: its trip has landed
  int last;
  int writes;
};

// Trip i of a piece whose copies cover [a0, end) (multiples of kAlign) into
// slot i % kStages: one thread's arrive with the byte count, three copies.
__device__ __forceinline__ void issue_trip(const float* __restrict__ data,
                                           const int* __restrict__ cols,
                                           const unsigned char* __restrict__ wrows,
                                           long long a0, long long end, int i, Shared& sh) {
  const int slot = i % kStages;
  const long long lo = a0 + (long long)i * kTrip;
  const uint32_t n = (uint32_t)((end - lo) < kTrip ? (end - lo) : kTrip);
  uint64_t* bar = &sh.full[slot];
  spmv::mbar_arrive_expect_tx(bar, n * 9u);
  spmv::bulk_copy(sh.data[slot], data + lo, n * 4u, bar);
  spmv::bulk_copy(sh.cols[slot], cols + lo, n * 4u, bar);
  spmv::bulk_copy(sh.wrows[slot], wrows + lo, n, bar);
}

// Piece blockIdx.x of the plan, by the whole CTA.
template <typename Acc, bool COUNT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    fused_spmv_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                      const unsigned char* __restrict__ wrows, const float* __restrict__ x,
                      float* __restrict__ y, const int* __restrict__ plan, int n_pieces,
                      int off_table, int off_pgroups, int off_groups, int off_grows,
                      int off_zero, int n_zero, int* __restrict__ tickets,
                      float* __restrict__ partials, int* __restrict__ writes) {
  __shared__ __align__(128) Shared sh;
  float (*s_win)[kWindow] = sh.win;
  const int piece = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & (spmv::kWarp - 1);
  const int warp = t / spmv::kWarp;
  const unsigned upto = spmv::kFullMask >> (spmv::kWarp - 1 - lane);
  const int* pc = plan + (long long)piece * kPieceInts;
  const long long start = __ldg(pc);
  const int live = __ldg(pc + 1), rlo = __ldg(pc + 2), width = __ldg(pc + 3);
  const int table = __ldg(pc + 4), g0 = __ldg(pc + 5), g1 = __ldg(pc + 6);
  // the copies cover the live elements, widened to whole 16-byte units
  const long long a0 = start & ~(long long)(kAlign - 1);
  const long long end = (start + live + kAlign - 1) & ~(long long)(kAlign - 1);
  const int n_trips = live > 0 ? (int)((end - a0 + kTrip - 1) / kTrip) : 0;

  if (t == 0) {
    for (int k = 0; k < kStages; ++k) spmv::mbar_init(&sh.full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kStages && i < n_trips; ++i) issue_trip(data, cols, wrows, a0, end, i, sh);
  }
  int code[kRowsPerThread];  // the epilogue's codes, loaded now
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int j = t + i * kThreads;
    code[i] = j < width ? __ldg(plan + off_table + table + j) : kSkip;
  }
  for (int j = t; j < width; j += kThreads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_win[w][j] = 0.0f;
  }
  if (COUNT && t == 0) sh.writes = 0;
  __syncthreads();

  // element of sub-step u of a trip: (warp * kSteps + u) * 32 + lane
  for (int i = 0; i < n_trips; ++i) {
    const int slot = i % kStages;
    spmv::mbar_wait(&sh.full[slot], (uint32_t)(i / kStages) & 1u);
    const long long base = a0 + (long long)i * kTrip;
    float v[kSteps];
    int r[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int e = (warp * kSteps + u) * spmv::kWarp + lane;
      const bool mine = base + e >= start && base + e < start + live;
      r[u] = mine ? (int)sh.wrows[slot][e] : kPadRow;
      v[u] = r[u] != kPadRow ? Acc::fma(sh.data[slot][e], __ldg(x + sh.cols[slot][e]), 0.0f)
                             : 0.0f;
    }
    // where every lane holds one row in all kSteps sub-steps (a SELL slice's
    // columns with all its rows live, long CSR or ELL rows), its products
    // add in registers first, in sub-step order: one sub-step's sums, not kSteps
    bool one_row = true;
#pragma unroll
    for (int u = 1; u < kSteps; ++u) one_row = one_row && r[u] == r[0];
    if (__all_sync(spmv::kFullMask, one_row)) {
#pragma unroll
      for (int u = 1; u < kSteps; ++u) v[0] = Acc::add(v[0], v[u]);
      add_step<Acc>(s_win[warp], r[0], v[0], r[0] != kPadRow, lane, upto);
    } else {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        add_step<Acc>(s_win[warp], r[u], v[u], r[u] != kPadRow, lane, upto);
      }
    }
    __syncthreads();  // every warp is done with the slot: refill it
    if (t == 0 && i + kStages < n_trips) issue_trip(data, cols, wrows, a0, end, i + kStages, sh);
  }
  __syncthreads();

  // ---- the window out: a row's warp slices in warp order
  int n_writes = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (code[i] == kSkip) continue;
    const int j = t + i * kThreads;
    float s = s_win[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = Acc::add(s, s_win[w][j]);
    if (code[i] == kDirect) {
      y[rlo + j] = s;
    } else {
      partials[code[i]] = s;
    }
    ++n_writes;
  }
  // ---- rows no piece touches, and the spill slot: the zero runs named for this piece
  for (int z = piece; z < n_zero; z += n_pieces) {
    const int lo = __ldg(plan + off_zero + 2 * z), hi = __ldg(plan + off_zero + 2 * z + 1);
    for (int r = lo + t; r < hi; r += kThreads) {
      y[r] = 0.0f;
      ++n_writes;
    }
  }
  // ---- shared rows: ticket per group, the last piece in adds the partials
  if (g1 > g0) {
    __threadfence();
    __syncthreads();
    for (int g = g0; g < g1; ++g) {
      const int gid = __ldg(plan + off_pgroups + g);
      const int* gd = plan + off_groups + gid * kGroupInts;
      const int roff = __ldg(gd), m = __ldg(gd + 1), np = __ldg(gd + 2), sbase = __ldg(gd + 3);
      if (t == 0) sh.last = atomicAdd(tickets + gid, 1) == np - 1;
      __syncthreads();
      if (sh.last) {
        __threadfence();
        for (int j = t; j < m; j += kThreads) {
          float s = __ldcg(partials + sbase + j);
          for (int q = 1; q < np; ++q) s = Acc::add(s, __ldcg(partials + sbase + q * m + j));
          y[__ldg(plan + off_grows + roff + j)] = s;
          ++n_writes;
        }
        if (t == 0) tickets[gid] = 0;
      }
      __syncthreads();  // `last` is read before the next group sets it
    }
  }
  if (COUNT) {
    atomicAdd(&sh.writes, n_writes);
    __syncthreads();
    if (t == 0) writes[piece] = sh.writes;
  }
}

}  // namespace

// The launch is the plan's (kernels/fused.py, fused_launch_plan): one CTA of
// kThreads per piece. `plan` is the plan's packed int32 array on the device
// (pieces, then the window codes at off_table, the pieces' groups at
// off_pgroups, the groups at off_groups, their rows at off_grows, the zero
// runs at off_zero). `tickets` (int, zero at the first launch; every launch
// leaves it zero) and `partials` (float) hold the plan's groups and scratch
// slots: wrapper scratch, owned by one stream. `writes` (one int per CTA)
// or null. `unroll` is checked and not read. data, cols and wrows must be
// 16-byte aligned (torch allocations are).
extern "C" int spmv_fused_launch(const void* data, const void* cols, const void* wrows,
                                 const void* x, void* y, const void* plan, int n_pieces,
                                 int off_table, int off_pgroups, int off_groups, int off_grows,
                                 int off_zero, int n_zero, int n_rows, void* tickets,
                                 void* partials, void* writes, int unroll, int accum_bf16,
                                 void* stream) {
  if (n_pieces < 1 || n_zero < 1 || n_rows < 0 ||
      (unroll != 1 && unroll != 2 && unroll != 4 && unroll != 8) ||
      (((uintptr_t)data | (uintptr_t)cols | (uintptr_t)wrows) & 15u) != 0u) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)n_pieces), block(kThreads);
#define LAUNCH(ACC, COUNT)                                                                  \
  fused_spmv_kernel<ACC, COUNT><<<grid, block, 0, (cudaStream_t)stream>>>(                  \
      (const float*)data, (const int*)cols, (const unsigned char*)wrows, (const float*)x,   \
      (float*)y,                                                                           \
      (const int*)plan, n_pieces, off_table, off_pgroups, off_groups, off_grows, off_zero, \
      n_zero, (int*)tickets, (float*)partials, (int*)writes)
  if (accum_bf16) {
    if (writes) LAUNCH(spmv::AccBF16, true); else LAUNCH(spmv::AccBF16, false);
  } else {
    if (writes) LAUNCH(spmv::AccF32, true); else LAUNCH(spmv::AccF32, false);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The constants the host plan must agree with: threads per CTA, window rows,
// sub-steps per warp and trip, ints per piece and per group, resident CTAs
// per SM the plan sizes a wave by, the window row of padding, the elements
// of a bulk copy's 16-byte unit (a stream's tile is a multiple of it).
extern "C" void spmv_fused_constants(int* out) {
  out[0] = kThreads;
  out[1] = kWindow;
  out[2] = kSteps;
  out[3] = kPieceInts;
  out[4] = kGroupInts;
  out[5] = kCtasPerSm;
  out[6] = kPadRow;
  out[7] = kAlign;
}
