"""Share of the point branch's group-norm calls that ran on the CUDA
kernels (cofii2p_tpu_torch/ops/norm_kernel.py): the program's counters
``cofii2p.point_norm.fused`` and ``cofii2p.point_norm.plain``
(cofii2p_tpu_torch/utils/profiling.py), found through the loaded module
as ``ransac_graph_nodes.serve`` finds its counters.  Each call adds one,
so under graph replay they count the warm-up's and the capture's calls.
The reading is 100 * fused / (fused + plain); None in a program without
the counters or where no call was counted."""

import sys


def read(t):
    table = getattr(sys.modules.get("cofii2p_tpu_torch.utils.profiling"), "span_table", None)
    if t.get("kind") != "serve" or table is None:
        return None
    counters = table()
    fused = counters.get("cofii2p.point_norm.fused", {}).get("value", 0)
    plain = counters.get("cofii2p.point_norm.plain", {}).get("value", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
