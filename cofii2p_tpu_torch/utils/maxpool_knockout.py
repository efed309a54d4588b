"""Time the banded maxpool's kernels and the k-NN threshold by part on the
card, with knock-out builds, and beside variants of their block plans: the
forward band max (kernels #3 and #8), the tie count (#12), the k-NN routing
(#15), the radius routings (#13 on static bands, #14 on dynamic windows)
and the banded k-NN threshold (#5, ``--kernel tau``).

    python -m cofii2p_tpu_torch.utils.maxpool_knockout [--tree DIR] [--kernel forward|count|route|radius|tau ...]
        [--path t7] [--path serve] [--reps 10] [--variant NAME=VALUE[,NAME=VALUE...] ...] [--cut]

``--tree`` is the root of a checkout of the port (default: this one); its
package is copied under ``build/knockout/`` of this checkout: as it is
(``full``), with the feature loads knocked out (``no_loads``), with the
membership tests knocked out (``no_member``) and once for each
``--variant``, which sets ``constexpr int`` constants of
``csrc/maxpool_plan.cuh`` (e.g. ``kPoolThreads=256,kPoolWalk=2``), each
built on its own.  ``--kernel tau`` has parts of its own, ``no_hist`` and
``no_d2``, and its variants set constants of ``csrc/knn_tau_plan.cuh``.  Each copy then replays the calls of the wrappers of the
``--kernel``s (default ``forward``) on the given paths with
``utils/kernel_bench.py --only`` (this checkout's, copied in), and the
per-path totals of each wrapper are printed side by side.  A copy patches
the source of every kernel named, so one build serves them all; a knocked
out kernel that is not timed only makes the replayed inputs wrong.

What each knock-out removes, by source:
 - ``csrc/maxpool_fwd.cu`` (the forward, and the tie count as its COUNT
   mode): no_loads drops the cp.async of feature rows into shared memory
   (the walk reads stale shared memory); no_member gives every query the
   first query's membership test (the test no longer depends on the
   query, so the compiler hoists it out of the query loop), and every
   query that query's bits, so the walk keeps its length.
 - ``csrc/maxpool_route.cu`` (the routing: #15 by tau, #13 by radius on
   static bands, #14 by radius in its window mode): no_loads drops the
   cp.async of the listed queries' out and gs slices (the walk reads stale
   shared memory); no_member tests only each tile's first query and gives
   every query of the tile its word, so every query of such a tile is
   listed (the walk grows).  A static block walks every tile of its window
   so; a window block its one tile.
 - ``csrc/knn_tau.cu`` (#5: d2 once into a slab of bits, ballot-counted
   bins): no_hist drops the five ballots of each counting step (a lane
   tests its own row's bits, so its count still estimates its bin's),
   keeping the walk, the candidate ballot and the popcounts; no_d2 makes
   the one d2 pass write the square of the row's distance to an index
   made from the query (``_ROW_VALUE``) instead of the coordinates'
   squared distance.  --cut adds builds whose queries stop after the d2
   walk (to_d2), after the first counting pass (to_pass1) and after the
   compaction into the list (to_compact), each writing a dummy tau: the
   time up to each phase.
The knocked-out builds compute wrong results: their times are the only
output.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)

# kernel -> (the wrappers kernel_bench --only replays, the source patched)
SOURCES = {
    "forward": ("banded_maxpool_fused,banded_maxpool_tau", "maxpool_fwd.cu"),
    "count": ("banded_maxpool_tie_count_fused", "maxpool_fwd.cu"),
    "route": ("banded_maxpool_backward_tau_fused", "maxpool_route.cu"),
    "radius": ("banded_maxpool_backward_fused,banded_maxpool_backward_dyn_fused", "maxpool_route.cu"),
    "tau": ("banded_knn_tau_kernel", "knn_tau.cu"),
}

PARTS = ("no_loads", "no_member")
TAU_PARTS = ("no_hist", "no_d2")
# --cut: builds of #5 whose queries stop after a phase (the d2 walk, the
# first counting pass, the compaction into the list) and write a dummy tau
TAU_CUTS = ("to_d2", "to_pass1", "to_compact")
# what each part's time difference is the cost of
PART_LABELS = {"no_loads": "loads", "no_member": "membership", "no_hist": "histogram", "no_d2": "d2",
               "to_d2": "after it", "to_pass1": "after it", "to_compact": "after it"}
_STOP = "if (lane == 0) tau[(long)b * M + m0 + q] = __uint_as_float(s.hi); __syncwarp(); continue;"


def parts_of(kernels, cut=False):
    """The knock-outs of the kernels timed together: tau's (with --cut, its
    cut-short builds too), or the maxpool's."""
    if "tau" in kernels and len(kernels) > 1:
        raise SystemExit("--kernel tau is timed on its own")
    if cut and "tau" not in kernels:
        raise SystemExit("--cut times --kernel tau")
    return (TAU_PARTS + (TAU_CUTS if cut else ())) if "tau" in kernels else PARTS


def plan_header(kernels):
    return "knn_tau_plan.cuh" if "tau" in kernels else "maxpool_plan.cuh"

# no_d2's stand-in for a query's d2 to row j: the square of j's distance to
# an index made from the query, so that the select meets ties and a spread
# of values as with real clouds, without the coordinates' loads and math
_ROW_VALUE = "__int2float_rn(j - (int)(__float_as_uint(qc[0]) & 255u))"

# (source, part) -> [(text, replacement)]; each text must occur once
KNOCKOUTS = {
    "maxpool_fwd.cu": {
        "no_loads": [("cofii2p::cp_async16(d, f + e * ESZ, 16);", "(void)e;")],
        "no_member": [("const float4 qq = q_s[32 * w + k];", "const float4 qq = q_s[0];")],
    },
    "maxpool_route.cu": {
        "no_loads": [("cofii2p::cp_async16(d, src, 16);", "(void)src;")],
        "no_member": [("for (int r = r_lo; r < r_hi; ++r) {", "for (int r = r_lo; r < (q == 0 ? r_hi : r_lo); ++r) {"),
                      ("return bits_s[jq];", "return bits_s[jq - jq % tile];")],
    },
    "knn_tau.cu": {
        "no_hist": [("for (int i = 0; i < 5; ++i) m &= __ballot_sync(kFull, (t & bit[i]) != 0u) ^ x[i];",
                     "for (int i = 0; i < 5; ++i) m &= ((t & bit[i]) != 0u ? kFull : 0u) ^ x[i];")],
        "no_d2": [("auto d2_once = [&](int j) { return d2_bits(j); };",
                   "auto d2_once = [&](int j) {\n      const float dj = " + _ROW_VALUE
                   + ";\n      return __float_as_uint(__fmul_rn(dj, dj));\n    };")],
        "to_d2": [("Range s{0u, __reduce_max_sync(kFull, mx), kk, band};",
                   "Range s{0u, __reduce_max_sync(kFull, mx), kk, band};\n    " + _STOP)],
        "to_pass1": [("      choose_bin(cnt, lane, kFirst, s);\n    }\n",
                      "      choose_bin(cnt, lane, kFirst, s);\n    }\n    " + _STOP + "\n")],
        "to_compact": [("      n = compact(band_walk, list, kList);\n",
                        "      n = compact(band_walk, list, kList);\n      " + _STOP + "\n")],
    },
}


def patch(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"knock-out pattern found {text.count(old)} times: {old!r}")
        text = text.replace(old, new)
    return text


def plan_edits(text: str, variant: str):
    """The edits that set the variant's ``NAME=VALUE`` constants of a plan
    header's text."""
    edits = []
    for item in variant.split(","):
        name, value = item.split("=")
        m = re.search(r"constexpr int " + name + r" = -?\d+;", text)
        if not m:
            raise RuntimeError(f"no constexpr int {name} in the plan header")
        edits.append((m.group(0), f"constexpr int {name} = {int(value)};"))
    return edits


def _rewrite(path: str, edit) -> None:
    with open(path) as fh:
        text = edit(fh.read())
    with open(path, "w") as fh:
        fh.write(text)


def make_copy(tree: str, variant: str, kernels=("forward",), cut=False) -> str:
    """This variant's copy of the tree's package, the sources of
    ``kernels`` patched; returns its root."""
    dst = os.path.join(_ROOT, "build", "knockout", re.sub(r"[^\w]", "_", variant))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "cofii2p_tpu_torch"), os.path.join(dst, "cofii2p_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    # a tree whose port has no kernel points of its own reads them from the
    # JAX package's path: give it this port's (byte-identical) copy there
    if not os.path.isdir(os.path.join(tree, "cofii2p_tpu_torch", "models", "dispositions")):
        shutil.copytree(os.path.join(_PKG, "models", "dispositions"),
                        os.path.join(dst, "cofii2p_tpu", "models", "dispositions"))
    shutil.copy(os.path.join(_PKG, "utils", "kernel_bench.py"), os.path.join(dst, "cofii2p_tpu_torch", "utils"))
    csrc = os.path.join(dst, "cofii2p_tpu_torch", "csrc")
    if variant in parts_of(kernels, cut):
        for src in dict.fromkeys(SOURCES[k][1] for k in kernels):
            _rewrite(os.path.join(csrc, src), lambda text, src=src: patch(text, KNOCKOUTS[src][variant]))
    elif variant != "full":
        _rewrite(os.path.join(csrc, plan_header(kernels)), lambda text: patch(text, plan_edits(text, variant)))
    return dst


def run(root: str, args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True, text=True)


def totals(out: str) -> dict:
    """kernel_bench's TOTAL lines: wrapper -> (calls, kernel ms, bound ms)."""
    got = {}
    for m in re.finditer(r"TOTAL (\S+)\s+(\d+) calls\s+kernel\s+([\d.]+) ms.*bound\s+([\d.]+) ms", out):
        got[m.group(1)] = (int(m.group(2)), float(m.group(3)), float(m.group(4)))
    return got


def main():
    ap = argparse.ArgumentParser(description="time kernels #3/#8, #12, #13/#14, #15 and #5 by part with knock-out builds")
    ap.add_argument("--tree", default=_ROOT, help="root of the checkout whose kernels are timed")
    ap.add_argument("--kernel", action="append", choices=sorted(SOURCES), help="kernels timed (default forward)")
    ap.add_argument("--path", action="append", choices=("serve", "train", "fast", "knn_train", "t7", "val"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variant", action="append", default=[], help="NAME=VALUE[,NAME=VALUE...] of the plan header")
    ap.add_argument("--cut", action="store_true", help="with --kernel tau: also builds cut short after each phase")
    args = ap.parse_args()
    kernels = args.kernel or ["forward"]
    paths = args.path or ["t7", "serve"]
    only = ",".join(SOURCES[k][0] for k in kernels)
    parts = parts_of(kernels, args.cut)
    variants = ("full", *parts, *args.variant)
    roots = {v: make_copy(os.path.abspath(args.tree), v, kernels, args.cut) for v in variants}
    build = ["-c", "from cofii2p_tpu_torch.ops import cuda_lib; cuda_lib.build()"]
    with ThreadPoolExecutor(len(variants)) as ex:
        for v, res in zip(variants, ex.map(lambda v: run(roots[v], build), variants)):
            if res.returncode:
                raise SystemExit(f"{v}: build failed\n{res.stdout}{res.stderr}")
    print(f"tree {os.path.abspath(args.tree)}, sources " + ", ".join(f"{k} {SOURCES[k][1]}" for k in kernels))
    for path in paths:
        row = {}
        for v in variants:
            res = run(roots[v], ["-m", "cofii2p_tpu_torch.utils.kernel_bench", "--path", path, "--only", only,
                                 "--reps", str(args.reps)])
            if res.returncode:
                raise SystemExit(f"{v} {path}: kernel_bench failed\n{res.stdout}{res.stderr}")
            row[v] = totals(res.stdout)
            last = res.stdout.strip().splitlines()[-1]
        for name in sorted(row["full"]):
            n, full, bound = row["full"][name]
            split = "".join(f", {p} {row[p][name][1]:.3f} ({PART_LABELS[p]} {full - row[p][name][1]:.3f})"
                            for p in parts)
            others = "".join(f", {v} {row[v][name][1]:.3f}" for v in args.variant)
            print(f"{path:9s} {name:33s} {n} calls: full {full:.3f} ms{split}{others}, bound {bound:.3f}")
        print(last)


if __name__ == "__main__":
    main()
