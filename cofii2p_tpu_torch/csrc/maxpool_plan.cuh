// Block plan of the forward band max (maxpool_fwd.cu): kernels #3 (radius
// membership) and #8 (k-NN membership, d2 <= tau[m]), in fp32 and bf16.
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
template <int ESZ>
struct PoolPlan {
  static constexpr int VEC = 16 / ESZ;                       // channels a lane takes
  static constexpr int THREADS = kPoolThreads;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TQ = kPoolTile;
  static constexpr int QPW = TQ / WARPS;                     // queries a warp keeps maxima of
  static constexpr int LANE_BYTES = 16;                      // a lane's channels of a row
  static constexpr int LANE_WORDS = LANE_BYTES / 4;          // in 32-bit words (bf16: two channels a word)
  static constexpr int CS = 32 * VEC;                        // channels a slice
  static constexpr int ROW_BYTES = 32 * LANE_BYTES;          // a staged row's slice
  static constexpr int PIECES = ROW_BYTES / 16;              // its 16-byte cp.async pieces
  static constexpr int SEG = kPoolSeg;
  static constexpr int WORDS = SEG / 32;                     // membership words a query and segment
  static constexpr int QB_STRIDE = WORDS + 1;                // odd: the transposing stores miss bank conflicts
  static constexpr int RB = kPoolRows;
  static constexpr int STAGES = 2;
  static constexpr int ACC_REGS = QPW * LANE_WORDS;          // running maxima a thread holds
  static constexpr int MIN_BLOCKS = 512 / THREADS;           // blocks an SM holds: 16 warps in all
  static_assert(ESZ == 4 || ESZ == 2, "PoolPlan: fp32 or bf16 features");
  static_assert(TQ == 4 * 32, "PoolPlan: a listed row's query bits are four words");
  static_assert(QPW * WARPS == TQ, "PoolPlan: the warps cover the tile");
  static_assert(THREADS == 256 || THREADS == 512, "PoolPlan: 8 or 16 warps");
  static_assert(RB == 32, "PoolPlan: a chunk is one membership word a query");
  static_assert(SEG % THREADS == 0 && SEG % 32 == 0, "PoolPlan: a segment is whole membership passes");
  static_assert(SEG <= 1 << 16, "PoolPlan: 16-bit listed rows");
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

}  // namespace cofii2p
