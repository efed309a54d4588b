// Block plans of the tensor-core KPConvs (kpconv_mma.cuh, kpconv_tau_mma.cuh,
// kpconv_transpose_mma.cuh): which widths are built, how many queries (or
// support rows) a block takes, how its 8 warps tile the products, and what
// shared memory and registers that costs.
//
// Plain constexpr C++ with no CUDA in it, so that a host compiler can
// evaluate the same plan the kernel is built with
// (tests/test_torch_kpconv_mma_plan.py does, on the CPU).  The launcher picks
// the queries per block from here; nothing else keeps a copy of the plan.
#pragma once

namespace cofii2p {

constexpr int kMmaThreads = 256;             // threads a block (kpconv_fused.cuh's kThreads)
constexpr int kMmaSeg = 2048;                // band rows per membership segment (kSeg)
constexpr int kMmaWords = kMmaSeg / 32;      // membership words per query and segment (kWords)
constexpr int kMmaMaxC = 512;                // Cin and Cout the kernel takes
constexpr int kSmemPerBlock = 232448;        // dynamic shared memory a block may use (H100)
constexpr int kSmemPerSM = 233472;           // shared memory an SM holds (H100)
constexpr int kRegsPerSM = 65536;            // 32-bit registers an SM holds (H100)

// Cin or Cout padded as the kernel pads it: a power of two, at least 32
constexpr int mma_pad(int c) {
  int p = 32;
  while (p < c) p *= 2;
  return p;
}

// Every padded (CI, CO) pair up to 512: bf16 compute at any width the
// wrapper takes runs on the tensor cores
#define COFII2P_MMA_CO(X, ci) X(ci, 32) X(ci, 64) X(ci, 128) X(ci, 256) X(ci, 512)
#define COFII2P_MMA_WIDTHS(X) \
  COFII2P_MMA_CO(X, 32) COFII2P_MMA_CO(X, 64) COFII2P_MMA_CO(X, 128) COFII2P_MMA_CO(X, 256) COFII2P_MMA_CO(X, 512)

constexpr bool mma_widths(int cin, int cout) { return cin >= 1 && cout >= 1 && cin <= kMmaMaxC && cout <= kMmaMaxC; }

// Block plan for padded widths CI, CO.  Once both products run on the
// tensor cores a zero-influence pair costs a bit test and a zero, so a
// block takes 64 queries, 32 where a width is 512 (acc_k and out, TQ x CI
// and TQ x CO fp32 fragments over 256 threads, would otherwise pass the
// register budget); up to 128 channels two blocks share an SM.
template <int CI, int CO>
struct MmaPlan {
  static constexpr int kMaxC = CI > CO ? CI : CO;
  static constexpr int TQ = kMaxC <= 256 ? 64 : 32;                // queries per block at most
  static constexpr int RB = CI <= 64 ? 128 : (CI <= 256 ? 64 : 32);  // active rows per chunk
  static constexpr int MIN_BLOCKS = kMaxC <= 128 ? 2 : 1;          // blocks an SM holds: <= 128 registers
  static constexpr int MT = TQ / 16;                                 // 16-row m-tiles
  // 8 warps over the (TQ, CI) aggregate and the (TQ, CO) output: WMA x WNA
  // (WMO x WNO) warps, each MA x NA (MO x NO) fragments of 16 x 8
  static constexpr int WNA = CI / 8 < 8 ? CI / 8 : 8, WMA = 8 / WNA;
  static constexpr int MA = MT / WMA, NA = CI / 8 / WNA;
  static constexpr int WNO = CO / 8 < 8 ? CO / 8 : 8, WMO = 8 / WNO;
  static constexpr int MO = MT / WMO, NO = CO / 8 / WNO;
  static_assert(WMA * WNA * 32 == kMmaThreads && WMO * WNO * 32 == kMmaThreads, "MmaPlan: 8 warps");
  static_assert(WMA * MA * 16 == TQ && WNA * NA * 8 == CI, "MmaPlan: the warps tile the aggregate exactly");
  static_assert(WMO * MO * 16 == TQ && WNO * NO * 8 == CO, "MmaPlan: the warps tile the output exactly");
  static_assert(RB % 16 == 0 && CI % 32 == 0, "MmaPlan tiling");
  // shared rows in bf16 elements, padded by 16 bytes against bank conflicts
  static constexpr int A_STRIDE = RB + 8, F_STRIDE = CI + 8, P_STRIDE = CI + 8;
  // shared memory in bytes, in layout order (every part a multiple of 16)
  static constexpr int F_BYTES = 2 * RB * F_STRIDE * 2;   // feature chunks, two slots
  static constexpr int P_BYTES = TQ * P_STRIDE * 2;       // acc_k in bf16
  static constexpr int A_BYTES = TQ * A_STRIDE * 2;       // influence tile
  static constexpr int MASK_BYTES = TQ * kMmaWords * 4;   // membership bits of the segment
  static constexpr int ACT_BYTES = kMmaSeg * 4;           // ordered active rows of the segment
  static constexpr int Q_BYTES = TQ * 7 * 4;              // centred and uncentred queries, counts
  static constexpr int SMEM = F_BYTES + P_BYTES + A_BYTES + MASK_BYTES + ACT_BYTES + Q_BYTES + 64;
  static_assert(SMEM <= kSmemPerBlock, "over the shared memory a block may use");
  // 1 KB of each block's shared memory is the system's
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= kSmemPerSM, "the SM's 228 KB hold MIN_BLOCKS blocks");
  // fp32 fragment registers a thread holds: at most half of its share when
  // MIN_BLOCKS blocks share the SM, the rest for addresses and operands
  static constexpr int ACC_REGS = 4 * (MA * NA + MO * NO);
  static constexpr int REG_BUDGET = kRegsPerSM / (kMmaThreads * MIN_BLOCKS) / 2;
  static_assert(ACC_REGS <= REG_BUDGET, "accumulator registers over budget");
};

// ---------------------------------------------------------------------------
// The k-NN (tau) KPConv on the tensor cores (kpconv_tau_mma.cuh): kernel #7
// (CO > 0, the contraction fused in) and kernel #6 (CO = 0, the aggregate
// written out), in fp32 by 3xTF32 (F32) or in bf16; under radius
// membership (CO = 0) the same kernel is #2.

constexpr int kTauSeg = 3072;                  // band rows a block keeps membership bits of at once
constexpr int kTauWords = kTauSeg / 32;        // membership words per query

// Every padded (CI, CO) pair up to 512 for #7 and every padded CI for #6
// (CO = 0), each built for both precisions
#define COFII2P_TAU_WIDTHS(X) COFII2P_MMA_WIDTHS(X) X(32, 0) X(64, 0) X(128, 0) X(256, 0) X(512, 0)

constexpr bool tau_widths(int cin, int cout) { return cin >= 1 && cin <= kMmaMaxC && cout >= 0 && cout <= kMmaMaxC; }

// Block plan of the tau kernel for padded widths CI, CO (0: no
// contraction).  The queries, warp tiling and register budget follow
// MmaPlan (acc_k and out are fp32 fragments in both precisions).  fp32
// stages its operands at twice bf16's bytes and its influence tile split
// into tf32 hi and lo, so its chunks take 32 rows (64 at 32 channels);
// two blocks share an SM up to 64 channels in both precisions.  Unlike
// MmaPlan's, the membership bits and the ordered active rows cover a slice
// of kTauSeg rows, the whole band at every level of the FPN, so there
// membership is computed once a block, not once a kernel point and segment.
template <int CI, int CO, bool F32>
struct TauPlan {
  static constexpr bool CONTRACT = CO > 0;
  static constexpr int ESZ = F32 ? 4 : 2;                          // bytes of a staged operand
  static constexpr int kMaxC = CI > CO ? CI : CO;
  static constexpr int TQ = kMaxC <= 256 ? 64 : 32;                // queries per block at most
  static constexpr int RB = F32 ? (CI <= 32 ? 64 : 32) : (CI <= 64 ? 128 : (CI <= 256 ? 64 : 32));
  static constexpr int MIN_BLOCKS = kMaxC <= 64 ? 2 : 1;
  static constexpr int MT = TQ / 16;
  static constexpr int COT = CONTRACT ? CO : 64;                   // output tiling (unused without CONTRACT)
  static constexpr int WNA = CI / 8 < 8 ? CI / 8 : 8, WMA = 8 / WNA;
  static constexpr int MA = MT / WMA, NA = CI / 8 / WNA;
  static constexpr int WNO = COT / 8 < 8 ? COT / 8 : 8, WMO = 8 / WNO;
  static constexpr int MO = MT / WMO, NO = COT / 8 / WNO;
  static_assert(WMA * WNA * 32 == kMmaThreads && WMO * WNO * 32 == kMmaThreads, "TauPlan: 8 warps");
  static_assert(WMA * MA * 16 == TQ && WNA * NA * 8 == CI, "TauPlan: the warps tile the aggregate exactly");
  static_assert(WMO * MO * 16 == TQ && WNO * NO * 8 == COT, "TauPlan: the warps tile the output exactly");
  static_assert(RB % 16 == 0 && CI % 32 == 0, "TauPlan tiling");
  // shared rows in elements: fp32 rows padded by 4 words (A, acc_k) or 8
  // (features), bf16 rows by 16 bytes, so that fragment loads miss bank
  // conflicts and every row starts on 16 bytes
  static constexpr int A_STRIDE = F32 ? RB + 4 : RB + 8;
  static constexpr int F_STRIDE = CI + 8;
  static constexpr int P_STRIDE = F32 ? CI + 4 : CI + 8;
  static constexpr int F_BYTES = 2 * RB * F_STRIDE * ESZ;          // feature chunks, two slots
  static constexpr int P_BYTES = CONTRACT ? TQ * P_STRIDE * ESZ : 0;  // acc_k for the contraction
  static constexpr int A_BYTES = TQ * A_STRIDE * ESZ * (F32 ? 2 : 1);  // influence tile (fp32: tf32 hi and lo)
  static constexpr int MASK_BYTES = TQ * kTauWords * 4;            // influence bits of a slice
  static constexpr int ACT_BYTES = kTauSeg * 2;                    // ordered active rows (16-bit)
  static constexpr int PA_BYTES = 2 * RB * 3 * 4;                  // the chunks' row positions, two slots
  static constexpr int Q_BYTES = TQ * 8 * 4;                       // queries centred and not, tau, counts
  static constexpr int SMEM = F_BYTES + P_BYTES + A_BYTES + MASK_BYTES + ACT_BYTES + PA_BYTES + Q_BYTES + 64;
  static_assert(SMEM <= kSmemPerBlock, "over the shared memory a block may use");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= kSmemPerSM, "the SM's 228 KB hold MIN_BLOCKS blocks");
  static constexpr int ACC_REGS = 4 * (MA * NA + (CONTRACT ? MO * NO : 0));
  static constexpr int REG_BUDGET = kRegsPerSM / (kMmaThreads * MIN_BLOCKS) / 2;
  static_assert(ACC_REGS <= REG_BUDGET, "accumulator registers over budget");
};

// The radius-membership aggregate (kernel #2) runs the same kernel with
// CO = 0 and the plan above: every padded CI, each in both precisions
#define COFII2P_RADIUS_WIDTHS(X) X(32) X(64) X(128) X(256) X(512)

// ---------------------------------------------------------------------------
// The transposed KPConv aggregation on the tensor cores
// (kpconv_transpose_mma.cuh): kernel #11, the feature gradient under the
// k-NN semantics, in fp32 by 3xTF32 (F32) or in bf16.  A block owns TS
// support rows and a range of CB channels (C padded as mma_pad pads it, at
// most 256: C = 512 takes two blocks), and accumulates
// (TS, CB) += influence (TS, RB listed queries) @ g (RB, CB) in fp32
// fragments over every kernel point and query tile of its window.

constexpr int kTransposeQSeg = 4096;   // window queries a block keeps membership bits of at once
constexpr int kTransposeMaxCB = 256;   // channels a block takes at most

#define COFII2P_TRANSPOSE_WIDTHS(X) X(32) X(64) X(128) X(256)

constexpr int transpose_cb(int c) { return mma_pad(c) < kTransposeMaxCB ? mma_pad(c) : kTransposeMaxCB; }

// Block plan for channel range CB.  64 support rows a block, so each
// listed query's g row (15 * C fp32) is read by band / 64 support blocks;
// the chunk rows, warp tiling, strides and register budget follow
// TauPlan's with the support rows in the queries' place.  A support row's
// membership in one query's neighbourhood is one bit of a 64-bit word.
template <int CB, bool F32>
struct TransposePlan {
  static constexpr int TS = 64;                                    // support rows per block at most
  static constexpr int ESZ = F32 ? 4 : 2;                          // bytes of a staged operand
  static constexpr int RB = F32 ? (CB <= 32 ? 64 : 32) : (CB <= 64 ? 128 : 64);  // listed queries per chunk
  static constexpr int MIN_BLOCKS = CB <= 64 ? 2 : 1;
  static constexpr int MT = TS / 16;
  static constexpr int WNA = CB / 8 < 8 ? CB / 8 : 8, WMA = 8 / WNA;
  static constexpr int MA = MT / WMA, NA = CB / 8 / WNA;
  static_assert(TS == 64, "TransposePlan: a support row's bit in a 64-bit word");
  static_assert(WMA * WNA * 32 == kMmaThreads, "TransposePlan: 8 warps");
  static_assert(WMA * MA * 16 == TS && WNA * NA * 8 == CB, "TransposePlan: the warps tile the sums exactly");
  static_assert(RB % 16 == 0 && CB % 32 == 0 && CB <= kTransposeMaxCB, "TransposePlan tiling");
  static_assert(kMmaThreads % RB == 0, "TransposePlan: a thread keeps one listed query of a chunk");
  static constexpr int A_STRIDE = F32 ? RB + 4 : RB + 8;           // as TauPlan's
  static constexpr int F_STRIDE = CB + 8;
  static constexpr int F_BYTES = 2 * RB * F_STRIDE * ESZ;          // g chunks, two slots
  static constexpr int A_BYTES = TS * A_STRIDE * ESZ * (F32 ? 2 : 1);  // influence tile (fp32: tf32 hi and lo)
  static constexpr int BITS_BYTES = kTransposeQSeg * 8;            // a 64-bit membership word per window query
  static constexpr int LIST_BYTES = kTransposeQSeg * 2;            // ordered listed queries (16-bit)
  static constexpr int PQ_BYTES = 2 * RB * 3 * 4;                  // the chunks' query positions, two slots
  static constexpr int S_BYTES = TS * 6 * 4;                       // support rows, uncentred and centred
  static constexpr int SMEM = F_BYTES + A_BYTES + BITS_BYTES + LIST_BYTES + PQ_BYTES + S_BYTES + 64;
  static_assert(SMEM <= kSmemPerBlock, "over the shared memory a block may use");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= kSmemPerSM, "the SM's 228 KB hold MIN_BLOCKS blocks");
  static constexpr int ACC_REGS = 4 * MA * NA;
  static constexpr int REG_BUDGET = kRegsPerSM / (kMmaThreads * MIN_BLOCKS) / 2;
  static_assert(ACC_REGS <= REG_BUDGET, "accumulator registers over budget");
};

// Queries a block takes in a band tile of `tile` queries: the largest power
// of two at most the plan's TQ that divides the tile
constexpr int mma_tq(int tile, int tq_max) {
  int tq = 1;
  while (tq * 2 <= tq_max && tile % (tq * 2) == 0) tq *= 2;
  return tq;
}

}  // namespace cofii2p
