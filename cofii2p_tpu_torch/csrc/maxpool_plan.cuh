// Block plans of the banded maxpool's kernels: the forward band max
// (maxpool_fwd.cu), kernels #3 (radius membership) and #8 (k-NN
// membership, d2 <= tau[m]), and its COUNT mode, the tie count (#12), in
// fp32 and bf16; and the routing of the backward (maxpool_route.cu: #13
// and #14 by radius, on static bands and on windows, #15 by tau).
//
// Plain constexpr C++ with no CUDA in it, so that a host compiler can
// evaluate the same plan the kernel is built with
// (tests/test_torch_maxpool_plan.py does, on the CPU).  Nothing else keeps a
// copy of it: the launcher takes the block size, the vector width and the
// shared memory from here.
#pragma once

namespace cofii2p {

constexpr int kPoolThreads = 512;           // threads a block: 16 warps
constexpr int kPoolWalk = 4;                // member rows a warp loads at once in its walk
constexpr int kPoolTile = 128;              // queries a block at most: one band tile
constexpr int kPoolSeg = 3072;              // band rows a block keeps membership bits of at once
constexpr int kPoolRows = 32;               // listed rows a staged chunk: one membership word a query
constexpr int kPoolSmemPerBlock = 232448;   // dynamic shared memory a block may use (H100)
constexpr int kPoolSmemPerSM = 233472;      // shared memory an SM holds (H100)
constexpr int kPoolRegsPerSM = 65536;       // 32-bit registers an SM holds (H100)
constexpr int kCountLaneBytes16 = 8;        // bytes of bf16 channels a lane counts (COUNT; fp32 lanes take 16)

// A block owns one tile of up to 128 queries and every channel.  It tests
// each band row of a segment against all its queries once, keeps the rows
// that any query holds as an ordered list with each listed row's 128 query
// bits, transposes those into a membership word per (query, 32 listed
// rows), then walks the channels in slices of CS: the listed rows' slice
// is staged by cp.async, 32 rows a chunk, two chunks in flight, and every
// warp keeps the running maxima of QPW queries (queries warp, warp +
// WARPS, ...), a lane VEC channels of each, reading each member row of a
// query once from shared memory, kPoolWalk rows at a time.  16 warps a
// block, one block an SM: the deep levels have fewer tiles than the card
// has SMs (80 at encoder5_1, B = 8), and there 8 warps could not hide the
// shared loads' latency (PERF.md).  ESZ: bytes of a feature
// element (4 fp32, 2 bf16); a lane takes 16 bytes of channels (VEC: 4
// fp32, 8 bf16), so at 128 bf16 channels half the lanes idle (an 8-byte
// lane build's gain there lay within the spread of runs, PERF.md).
//
// COUNT (the tie count, #12): the same block, membership, list and
// staging; a warp keeps its queries' forward maxima (out) and their tie
// counts, two 16-bit counts a word (a count is at most the band, <= N <
// 2^16), in registers.  An fp32 lane takes 16 bytes (4 channels: 4 words
// of out, 2 of counts); a bf16 lane kCountLaneBytes16 = 8 (4 channels: 2
// words of out, 2 of counts), so that neither build holds more than the
// forward's 128 registers a thread.
template <int ESZ, bool COUNT = false>
struct PoolPlan {
  static constexpr int LANE_BYTES = COUNT && ESZ == 2 ? kCountLaneBytes16 : 16;  // a lane's channels of a row
  static constexpr int VEC = LANE_BYTES / ESZ;               // channels a lane takes
  static constexpr int THREADS = kPoolThreads;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TQ = kPoolTile;
  static constexpr int QPW = TQ / WARPS;                     // queries a warp keeps maxima of
  static constexpr int LANE_WORDS = LANE_BYTES / 4;          // in 32-bit words (bf16: two channels a word)
  static constexpr int CS = 32 * VEC;                        // channels a slice
  static constexpr int ROW_BYTES = 32 * LANE_BYTES;          // a staged row's slice
  static constexpr int PIECES = ROW_BYTES / 16;              // its 16-byte cp.async pieces
  static constexpr int SEG = kPoolSeg;
  static constexpr int WORDS = SEG / 32;                     // membership words a query and segment
  static constexpr int QB_STRIDE = WORDS + 1;                // odd: the transposing stores miss bank conflicts
  static constexpr int RB = kPoolRows;
  static constexpr int STAGES = 2;
  static constexpr int CNT_WORDS = COUNT ? VEC / 2 : 0;     // COUNT: 16-bit count pairs a query and lane
  static constexpr int ACC_REGS = QPW * (LANE_WORDS + CNT_WORDS);  // maxima (COUNT: out and counts) a thread holds
  static constexpr int MIN_BLOCKS = 512 / THREADS;           // blocks an SM holds: 16 warps in all
  static_assert(ESZ == 4 || ESZ == 2, "PoolPlan: fp32 or bf16 features");
  static_assert(TQ == 4 * 32, "PoolPlan: a listed row's query bits are four words");
  static_assert(QPW * WARPS == TQ, "PoolPlan: the warps cover the tile");
  static_assert(THREADS == 256 || THREADS == 512, "PoolPlan: 8 or 16 warps");
  static_assert(RB == 32, "PoolPlan: a chunk is one membership word a query");
  static_assert(SEG % THREADS == 0 && SEG % 32 == 0, "PoolPlan: a segment is whole membership passes");
  static_assert(SEG <= 1 << 16, "PoolPlan: 16-bit listed rows");
  static_assert(LANE_BYTES == 16 || LANE_BYTES == 8, "PoolPlan: a lane loads 16 or 8 bytes of a staged row");
  static_assert(!COUNT || VEC == 4, "PoolPlan: a COUNT lane takes 4 channels, one 16-byte store of counts");
  // shared memory in bytes, in layout order (every part a multiple of 16)
  static constexpr int Q_BYTES = TQ * 16;                    // centred query and threshold
  static constexpr int QBITS_BYTES = (TQ * QB_STRIDE * 4 + 15) / 16 * 16;  // membership words, query-major
  static constexpr int ROWBITS_BYTES = SEG * 16;             // a listed row's 128 query bits
  static constexpr int STAGE_BYTES = STAGES * RB * ROW_BYTES;  // staged chunks (alias the row bits)
  static constexpr int UNION_BYTES = ROWBITS_BYTES > STAGE_BYTES ? ROWBITS_BYTES : STAGE_BYTES;
  static constexpr int LIST_BYTES = SEG * 2;                 // ordered listed rows of the segment
  static constexpr int CNT_BYTES = 64;                       // a count a warp
  static constexpr int SMEM = Q_BYTES + QBITS_BYTES + UNION_BYTES + LIST_BYTES + CNT_BYTES;
  static_assert(Q_BYTES % 16 == 0 && QBITS_BYTES % 16 == 0 && UNION_BYTES % 16 == 0 && LIST_BYTES % 16 == 0,
                "PoolPlan: 16-byte aligned parts");
  static_assert(SMEM <= kPoolSmemPerBlock, "over the shared memory a block may use");
  // 1 KB of each block's shared memory is the system's
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= kPoolSmemPerSM, "the SM's 228 KB hold MIN_BLOCKS blocks");
  // the running maxima: at most half a thread's share of registers when
  // MIN_BLOCKS blocks share the SM
  static constexpr int REG_BUDGET = kPoolRegsPerSM / (THREADS * MIN_BLOCKS) / 2;
  static_assert(ACC_REGS <= REG_BUDGET, "running maxima over the register budget");
};

// Membership segments of a band: ceil(band / kPoolSeg), segment s covering
// rows [s * kPoolSeg, min(band, (s + 1) * kPoolSeg))
constexpr int pool_segments(int band) { return (band + kPoolSeg - 1) / kPoolSeg; }

// Channel slices of a block: ceil(C / CS)
constexpr int pool_slices(int C, int cs) { return (C + cs - 1) / cs; }

constexpr int kRouteThreads = 512;  // threads a block of the routing: 16 warps
constexpr int kRouteTS = 64;        // support rows a block: one bit each of a query's 64-bit word
constexpr int kRouteQSeg = 4096;    // window queries a block keeps membership words of at once
constexpr int kRouteRows = 32;      // listed queries a staged chunk: one ballot word a warp

// The routing (#13, #14, #15, maxpool_route.cu): a block owns TS support
// rows and every channel.  It walks the window of query tiles whose bands
// touch its rows (in window mode, #14, TS rows of one tile's window and
// that one tile) in segments of QSEG window queries, tests each (query, row)
// pair once and keeps a 64-bit word a query, lists the queries with any
// bit in query order, then walks the channels in slices of CS: the listed
// queries' out and gs slices are staged by cp.async, RB queries a chunk,
// two chunks in flight.  Warp w owns rows [RPW w, RPW w + RPW), a lane VEC
// channels of each: the rows' features and sums stay in registers, and a
// staged query's slice is read once by every warp whose rows it holds
// (fewer rows a warp: more such reads; more: more registers a thread).
// The sums run in fp64 (maxpool_route.cu says why).
// ESZ: bytes of a feature (and out) element; gs is fp32.
template <int ESZ>
struct RoutePlan {
  static constexpr int THREADS = kRouteThreads;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TS = kRouteTS;
  static constexpr int RPW = TS / WARPS;                     // rows a warp
  static constexpr int VEC = 4;                              // channels a lane: 16 bytes of gs
  static constexpr int CS = 32 * VEC;                        // channels a slice
  static constexpr int RB = kRouteRows;
  static constexpr int QSEG = kRouteQSeg;
  static constexpr int STAGES = 2;
  static constexpr int OUT_BYTES = CS * ESZ;                 // a staged query's out slice
  static constexpr int GS_BYTES = CS * 4;                    // ... and its gs slice, after it
  static constexpr int QROW_BYTES = OUT_BYTES + GS_BYTES;
  static constexpr int PIECES = QROW_BYTES / 16;             // its 16-byte cp.async pieces
  static constexpr int OUT_PIECES = OUT_BYTES / 16;
  static constexpr int MIN_BLOCKS = 1;
  static_assert(ESZ == 4 || ESZ == 2, "RoutePlan: fp32 or bf16 features");
  static_assert(TS == 64, "RoutePlan: a support row's bit in a 64-bit word");
  static_assert(RPW * WARPS == TS && RPW <= 32, "RoutePlan: the warps cover the block's rows");
  static_assert(RB == 32, "RoutePlan: a chunk is one ballot word a warp");
  static_assert(QSEG % 128 == 0 && QSEG <= 1 << 16, "RoutePlan: whole tiles a segment, 16-bit listed queries");
  // shared memory in bytes, in layout order (every part a multiple of 16)
  static constexpr int STAGE_BYTES = STAGES * RB * QROW_BYTES;  // staged chunks
  static constexpr int BITS_BYTES = QSEG * 8;                // a membership word a window query
  static constexpr int LIST_BYTES = QSEG * 2;                // ordered listed queries of the segment
  static constexpr int S_BYTES = TS * 3 * 4;                 // the block's support rows
  static constexpr int CNT_BYTES = 64;                       // a count a warp
  static constexpr int SMEM = STAGE_BYTES + BITS_BYTES + LIST_BYTES + S_BYTES + CNT_BYTES;
  static_assert(STAGE_BYTES % 16 == 0 && BITS_BYTES % 16 == 0 && LIST_BYTES % 16 == 0 && S_BYTES % 16 == 0,
                "RoutePlan: 16-byte aligned parts");
  static_assert(SMEM <= kPoolSmemPerBlock, "over the shared memory a block may use");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= kPoolSmemPerSM, "the SM's 228 KB hold MIN_BLOCKS blocks");
  // the rows' features (fp32) and sums (fp64): at most half a thread's
  // share of registers
  static constexpr int ACC_REGS = 3 * RPW * VEC;
  static constexpr int REG_BUDGET = kPoolRegsPerSM / (THREADS * MIN_BLOCKS) / 2;
  static_assert(ACC_REGS <= REG_BUDGET, "rows and sums over the register budget");
};

}  // namespace cofii2p
