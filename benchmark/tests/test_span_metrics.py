"""The reader of the program's counters, on a fake registry: the RANSAC
graph's nodes, as the mean over its captures; None in a cell of another
kind, where a counter is missing or zero, and where the program has no
registry (a program without counters)."""

import sys
import types

import pytest

from benchmark.harness import spec

COUNTERS = {"cofii2p.eval": {"n": 4, "host_ms": 400.0, "device_ms": 480.0},
            "cofii2p.ransac.graph_nodes": {"value": 42000},
            "cofii2p.ransac.captures": {"value": 2}}


def program(monkeypatch, table):
    """The program's profiling module in sys.modules with ``table``; None:
    the module without a registry."""
    mod = types.ModuleType("cofii2p_tpu_torch.utils.profiling")
    if table is not None:
        mod.span_table = lambda: {k: dict(v) for k, v in table.items()}
    monkeypatch.setitem(sys.modules, "cofii2p_tpu_torch.utils.profiling", mod)


def test_graph_nodes_reads_the_mean_over_captures(monkeypatch):
    read = spec.reader("ransac_graph_nodes.serve")
    program(monkeypatch, COUNTERS)
    assert read({"kind": "serve"}) == pytest.approx(21000)
    assert read({"kind": "train"}) is None


@pytest.mark.parametrize("table", [None, {}, {k: v for k, v in COUNTERS.items() if k != "cofii2p.ransac.captures"},
                                   {**COUNTERS, "cofii2p.ransac.captures": {"value": 0}}],
                         ids=["no-registry", "empty", "no-captures", "zero-captures"])
def test_graph_nodes_gives_no_reading_without_its_counters(monkeypatch, table):
    program(monkeypatch, table)
    assert spec.reader("ransac_graph_nodes.serve")({"kind": "serve"}) is None


def test_graph_nodes_gives_no_reading_without_the_program(monkeypatch):
    monkeypatch.delitem(sys.modules, "cofii2p_tpu_torch.utils.profiling", raising=False)
    assert spec.reader("ransac_graph_nodes.serve")({"kind": "serve"}) is None
