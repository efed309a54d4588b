// The block plan of the point branch's GroupNorm kernels (point_norm.cu):
// plain constexpr C++ with no includes, so that tests/test_torch_point_norm.py
// compiles it with the host g++ and holds ops/norm_kernel.py's copy of the
// rule to it.
//
// x is (B, N, C) in bf16 or fp32, C = G groups of cg channels.  A thread
// reads 16 bytes (VEC channels) of a row; a block of kThreads threads is
// CS vector columns by RY rows.  Where a row holds more than kThreads
// vectors, the channels are cut into SLICES of kThreads vectors, each a
// block of its own.  GPV groups share a vector where cg < VEC; CPG vectors
// make a group where cg >= VEC; GS groups lie in a slice.
#pragma once

namespace point_norm {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 256;     // row chunks a (frame, slice) at most: the merge's partials
constexpr int kStatsBlocks = 528;   // statistics blocks aimed at: 4 on each of the 132 SMs
constexpr int kApplyBlocks = 1056;  // apply blocks aimed at: 8 on each SM

struct Plan {
  int ok, vec, cg, vpr, cs, ry, slices, gs, gpv, cpg;
};

// ok = 0 where the kernels do not take (C, G) at this element size: G does
// not divide C, a row is not whole vectors, a vector straddles groups
// unevenly, the vectors of a row neither divide nor fill whole blocks, or
// a slice's groups do not divide the block.
constexpr Plan make_plan(int C, int G, int esz) {
  Plan p{0, 16 / esz, 0, 0, 0, 0, 0, 0, 0, 0};
  if (G < 1 || C < 1 || C % G != 0 || C % p.vec != 0) return p;
  p.cg = C / G;
  if (p.cg % p.vec != 0 && p.vec % p.cg != 0) return p;
  p.vpr = C / p.vec;
  if (kThreads % p.vpr != 0 && p.vpr % kThreads != 0) return p;
  p.cs = p.vpr < kThreads ? p.vpr : kThreads;
  p.ry = kThreads / p.cs;
  p.slices = p.vpr / p.cs;
  if ((p.cs * p.vec) % p.cg != 0) return p;
  p.gs = p.cs * p.vec / p.cg;
  if (kThreads % p.gs != 0) return p;
  p.gpv = p.cg < p.vec ? p.vec / p.cg : 1;
  p.cpg = p.cg < p.vec ? 1 : p.cg / p.vec;
  p.ok = 1;
  return p;
}

// Row chunks of each (frame, slice): about `target` blocks in all, at most
// `cap`, and at least RY rows a chunk where N allows; every chunk but the
// last holds rows_per_chunk rows.
constexpr int chunk_rows(int B, int N, const Plan& p, int target, int cap) {
  const int per = B * p.slices;
  int n = (target + per - 1) / per;
  if (n > cap) n = cap;
  const int most = N / p.ry > 0 ? N / p.ry : 1;
  if (n > most) n = most;
  if (n < 1) n = 1;
  return (N + n - 1) / n;
}

constexpr int chunk_count(int N, int rows) { return (N + rows - 1) / rows; }

}  // namespace point_norm
