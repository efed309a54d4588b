// Block plan of the banded k-NN threshold (knn_tau.cu, kernel #5).
//
// Plain constexpr C++ with no CUDA in it, so that a host compiler can
// evaluate the same plan the kernel is built with
// (tests/test_torch_knn_tau_plan.py does, on the CPU).  The launcher takes
// the warps, the queries a block, the mode and the shared memory from here.
#pragma once

namespace cofii2p {

constexpr int kTauWarps = 8;             // warps a block: queries selected at once
constexpr int kTauQueries = 16;          // queries a block at most (a band tile is 128)
constexpr int kTauWalk = 4;              // 32-row steps a walk loads before it counts them
constexpr int kTauDigitBits = 5;         // bits a counting pass: 32 bins, one a lane
constexpr int kTauFirstShift = 21;       // the first pass's bins: 2^21 bit patterns (quarter binades)
constexpr int kTauListWords = 256;       // candidates a warp compacts into its list at most
constexpr int kTauMaxBand = 16384;       // the wrapper's MAX_BAND
constexpr int kTauSmemPerBlock = 232448; // dynamic shared memory a block may use (H100)
constexpr int kTauSmemPerSM = 233472;    // shared memory an SM holds (H100)
constexpr int kTauRegsPerSM = 65536;     // 32-bit registers an SM holds (H100)
constexpr int kTauRegs = 64;             // registers a thread may take (__launch_bounds__)

// A block owns up to kTauQueries queries of one band tile.  It stages the
// tile's band rows, centred on the tile's first query, once (12 bytes a
// row); each warp then takes one query at a time (queries warp, warp +
// warps, ...) and computes d2 once per band row, keeping its bit pattern
// in a slab of `band` words of shared memory (keep: every band of the
// seven paths), which every later walk reads.  Bands whose slabs do not
// fit (up to kTauMaxBand) compute d2 again on each walk.  Counting passes walk the band until at most
// kTauListWords candidates are left, which one walk compacts into a
// warp's list; the last 32 go one a lane into registers (32 more words a
// warp).
struct TauPlan {
  int warps;        // warps a block
  int queries;      // queries a block at most (the launcher halves it to divide the tile)
  bool keep;        // d2 kept as bits in a slab a warp
  int coord_bytes;  // the band's centred coordinates, 16-byte aligned
  int words;        // 32-bit words a warp: the list, 32 lanes' candidates, the slab (keep)
  int smem;         // dynamic shared memory of a block, bytes
  int min_blocks;   // blocks an SM holds by shared memory
};

constexpr int tau_coord_bytes(int band) { return (band * 12 + 15) / 16 * 16; }

constexpr int tau_words(int band, bool keep) { return kTauListWords + 32 + (keep ? band : 0); }

constexpr int tau_smem(int band, bool keep) { return tau_coord_bytes(band) + kTauWarps * tau_words(band, keep) * 4; }

constexpr TauPlan tau_plan(int band) {
  const bool keep = tau_smem(band, true) <= kTauSmemPerBlock;
  const int smem = tau_smem(band, keep);
  return TauPlan{kTauWarps, kTauQueries, keep, tau_coord_bytes(band), tau_words(band, keep), smem,
                 kTauSmemPerSM / (smem + 1024)};  // 1 KB of each block's is the system's
}

// The shift of a counting pass over the candidates lo <= u <= hi, given
// width = hi - lo >= 1: the 32 bins t = (hi - u) >> shift, each 2^shift bit
// patterns, cover the width, so the pass takes the top kTauDigitBits of the
// width's bit length (the kernel computes it with __clz).  The first pass
// instead takes kTauFirstShift below the band's max, its lowest bin
// holding every row below the other 31.
constexpr int tau_bit_length(unsigned width) {
  int n = 0;
  while (n < 32 && (width >> n) != 0u) ++n;
  return n;
}

constexpr int tau_shift(unsigned width) {
  return tau_bit_length(width) > kTauDigitBits ? tau_bit_length(width) - kTauDigitBits : 0;
}

static_assert(kTauWarps >= 1 && kTauWarps * 32 <= 1024, "TauPlan: 1 to 32 warps");
static_assert(kTauQueries >= 1 && kTauQueries <= 128, "TauPlan: at most one tile a block");
static_assert(kTauDigitBits == 5, "TauPlan: 32 bins, one a lane");
static_assert(kTauFirstShift + kTauDigitBits <= 31, "TauPlan: the first bins lie within bits 30..0");
static_assert(kTauListWords >= 32 && kTauListWords % 32 == 0, "TauPlan: whole steps of a list");
static_assert(kTauWalk >= 1 && kTauWalk <= 8, "TauPlan: 1 to 8 steps a walk loads at once");
static_assert(tau_plan(kTauMaxBand).smem <= kTauSmemPerBlock, "MAX_BAND's coordinates fit a block");
static_assert(tau_plan(2304).keep, "the seven paths' widest band keeps its d2");
static_assert(kTauRegs * kTauWarps * 32 <= kTauRegsPerSM, "a block's registers fit an SM");

}  // namespace cofii2p
