"""Nodes of the RANSAC stage's captured CUDA graph: the program's
counters (cofii2p_tpu_torch/utils/profiling.py), found through the loaded
module as ``serve.launch_counts`` finds the kernel wrappers' counters.
``cofii2p.ransac.graph_nodes`` sums the driver's cuGraphGetNodes over the
captures ``cofii2p.ransac.captures`` counts; the reading is their mean, a
graph's nodes.  A count read at capture: no profiler swells it.  None in
a program without the counters or whose count failed."""

import sys


def read(t):
    table = getattr(sys.modules.get("cofii2p_tpu_torch.utils.profiling"), "span_table", None)
    if t.get("kind") != "serve" or table is None:
        return None
    counters = table()
    nodes = counters.get("cofii2p.ransac.graph_nodes", {}).get("value")
    captures = counters.get("cofii2p.ransac.captures", {}).get("value")
    return nodes / captures if nodes and captures else None
