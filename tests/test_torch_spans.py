"""The port's spans and counters (utils/profiling.py): off they record
nothing and open no profiler range; under a torch profiler the tiny
configuration's eval request records the documented spans, in the chrome
trace and in the registry; every name the package records is listed in
SPAN_NAMES and in PERF.md; on the card, a span under CUDA graph capture
records no events and the RANSAC graph's node count is read at capture.
Imports no JAX: ``python -m pytest --noconftest tests/test_torch_spans.py``
runs the card test too."""

import ast
import collections
import contextlib
import json
import os
import re

import numpy as np
import pytest
import torch

import cofii2p_tpu_torch
from cofii2p_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(cofii2p_tpu_torch.__file__))
# the spans one request of the tiny configuration records on the CPU (the
# plain RANSAC runs there, outside the graph and its spans)
CPU_REQUEST = ("cofii2p.eval", "cofii2p.prep", "cofii2p.network", "cofii2p.pc_encoder", "cofii2p.img_encoder",
               "cofii2p.transformer", "cofii2p.transformer.0.self", "cofii2p.transformer.1.cross",
               "cofii2p.selection", "cofii2p.fine_match")


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def listed(name: str) -> bool:
    """Whether ``name`` is one of SPAN_NAMES, "<i>" matching an index and
    "<stage>" a graph stage's name."""
    return any(re.fullmatch(re.escape(p).replace("<i>", r"\d+").replace("<stage>", "[a-z_]+"), name)
               for p in profiling.SPAN_NAMES)


def test_span_off_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(*a, **kw):
        raise AssertionError("record_function opened with spans off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    with profiling.span("cofii2p.eval") as s:
        assert s is None
    assert profiling.span("cofii2p.prep") is profiling.span("cofii2p.network")  # one shared null context
    assert profiling.span_table() == {}


def test_recording_tabulates_spans_and_counters():
    with profiling.recording():
        for _ in range(3):
            with profiling.span("cofii2p.eval"), profiling.span("cofii2p.prep"):
                pass
    with profiling.span("cofii2p.eval"):  # off again
        pass
    profiling.counter("cofii2p.ransac.captures").add()
    profiling.counter("cofii2p.ransac.captures").add(2)
    profiling.counter("cofii2p.ransac.graph_nodes").set(7)
    table = profiling.span_table()
    assert table["cofii2p.eval"]["n"] == 3 and table["cofii2p.prep"]["n"] == 3
    assert table["cofii2p.eval"]["host_ms"] >= table["cofii2p.prep"]["host_ms"] > 0
    assert table["cofii2p.eval"]["device_ms"] is None  # no card: no events
    assert table["cofii2p.ransac.captures"] == {"value": 3}
    assert table["cofii2p.ransac.graph_nodes"] == {"value": 7}
    profiling.reset()
    assert profiling.span_table() == {}


def test_pending_events_resolve_on_exit_once_the_stream_has_passed_them(monkeypatch):
    """Under a long profiler no table is read: past ``_PENDING_MAX`` pairs
    a span's exit resolves those the stream has passed, without waiting."""

    class Event:
        done = True

        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def query(self):
            return Event.done

        def synchronize(self):
            Event.done = True

        def elapsed_time(self, end):
            return 0.5

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(profiling, "_PENDING_MAX", 4)
    with profiling.recording():
        for _ in range(10):
            with profiling.span("cofii2p.eval"):
                pass
        rec = profiling._spans["cofii2p.eval"]
        assert len(rec.pending) < 4 and rec.device_ms == 0.5 * (10 - len(rec.pending))
        Event.done = False  # the stream has not reached these: left for the table
        for _ in range(5):
            with profiling.span("cofii2p.eval"):
                pass
    assert len(rec.pending) >= 4
    assert profiling.span_table()["cofii2p.eval"] == {"n": 15, "host_ms": pytest.approx(rec.host_ns * 1e-6),
                                                       "device_ms": 7.5}


def fake_capture(monkeypatch):
    """torch.cuda's stream and graph calls as ``CudaGraphed`` makes them, for
    the CPU: a graph's replay only counts, so the outputs are the capture's."""

    class Fake:
        def __init__(self, *a, **kw):
            self.replays = 0

        def wait_stream(self, other):
            pass

        def capture_begin(self, pool=None, capture_error_mode="global"):
            pass

        def capture_end(self):
            pass

        def instantiate(self):
            pass

        def replay(self):
            self.replays += 1

    for name in ("Stream", "CUDAGraph", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, Fake)
    monkeypatch.setattr(torch.cuda, "stream", lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))


def test_node_counts_add_up_over_the_captured_shapes(monkeypatch):
    from cofii2p_tpu_torch.utils import cuda_graphs

    fake_capture(monkeypatch)
    monkeypatch.setattr(cuda_graphs, "graph_nodes", lambda graph: 7)
    Out = collections.namedtuple("Out", "y")
    graphed = cuda_graphs.CudaGraphed(lambda x: Out(x * 2), "cofii2p.ransac")
    for n in (3, 3, 5):
        (y,) = graphed(torch.ones(n))
        assert torch.equal(y, torch.full((n,), 2.0))
    assert [[g.replays for _, g in parts] for parts, _, _ in graphed.graphs.values()] == [[2], [1]]
    assert profiling.span_table() == {"cofii2p.ransac.graph_nodes": {"value": 14},
                                      "cofii2p.ransac.captures": {"value": 2}}


def test_a_failing_node_count_does_not_stop_the_request(monkeypatch):
    from cofii2p_tpu_torch.utils import cuda_graphs

    def refuse(graph):
        raise RuntimeError("cuGraphGetNodes failed with CUresult 1")

    fake_capture(monkeypatch)
    monkeypatch.setattr(cuda_graphs, "graph_nodes", refuse)
    Out = collections.namedtuple("Out", "y")
    (y,) = cuda_graphs.CudaGraphed(lambda x: Out(x + 1), "cofii2p.ransac")(torch.zeros(4))
    assert torch.equal(y, torch.ones(4))
    assert profiling.span_table() == {}  # uncounted: no reading rather than a wrong one


def test_tiny_eval_request_records_its_spans(tmp_path):
    """Under a CPU torch profiler, one request of the eval body: each span
    once in the registry and as a user_annotation range in the chrome
    trace; every name recorded is listed.  (torch.autograd.profiler's
    profile, the engine under torch.profiler's, spares the seconds the
    latter's first use takes in imports; test_trace_writes_a_chrome_trace
    holds trace() to its spans.json.)"""
    from cofii2p_tpu_torch.config import TinyConfig
    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset
    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
    from cofii2p_tpu_torch.models.network import CoFiI2P

    cfg = TinyConfig(ransac_refine_iters=0)  # fewer operations for the profiler to hold
    hb = _collate([SyntheticDataset(cfg, "val", length=1)[0]])
    hb.pop("index")
    torch.manual_seed(0)
    run = make_eval_body(cfg, CoFiI2P(cfg).eval())
    with torch.autograd.profiler.profile() as prof:
        run({k: torch.as_tensor(np.asarray(v)) for k, v in hb.items()}, torch.Generator().manual_seed(0))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        ranges = {e["name"] for e in json.load(fh)["traceEvents"] if e.get("cat") == "user_annotation"}
    table = profiling.span_table()
    n_layers = 2 * cfg.num_transformer_layers
    for name in CPU_REQUEST:
        assert name in ranges and table[name]["n"] == 1, name
    assert {n for n in table if n.startswith("cofii2p.transformer.")} == {
        f"cofii2p.transformer.{i}.{('self', 'cross')[i % 2]}" for i in range(n_layers)}
    assert all(listed(n) for n in table), sorted(n for n in table if not listed(n))
    assert table["cofii2p.eval"]["host_ms"] >= table["cofii2p.network"]["host_ms"] >= \
        table["cofii2p.transformer"]["host_ms"]


def test_every_recorded_name_is_listed_and_documented():
    """The string names passed to span() and counter() in the package,
    and those of each serving graph stage, are in SPAN_NAMES (a name built
    at run time is checked by the request above), and PERF.md names every
    entry of SPAN_NAMES."""
    from cofii2p_tpu_torch.utils.cuda_graphs import STAGES, stage_prefix

    found = set()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id in ("span", "counter") and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    found.add(node.args[0].value)
    staged = {stage_prefix(s) + x for s in STAGES for x in ("", ".replay", ".graph_nodes", ".captures")}
    assert [n for n in staged if not listed(n)] == []
    found |= staged & set(profiling.SPAN_NAMES)  # RANSAC's, named in full
    assert found - set(profiling.SPAN_NAMES) == set()
    patterns = [n for n in profiling.SPAN_NAMES if "<" in n]  # per layer or per graph stage
    assert len(found) >= len(profiling.SPAN_NAMES) - len(patterns)
    with open(os.path.join(ROOT, "PERF.md")) as fh:
        perf = fh.read()
    assert [n for n in profiling.SPAN_NAMES if f"`{n}`" not in perf] == []


@pytest.mark.gpu
def test_capture_records_no_events_and_counts_the_graphs_nodes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only on the card")
    from cofii2p_tpu_torch.utils.cuda_graphs import CudaGraphed

    Out = collections.namedtuple("Out", "y")  # CudaGraphed returns its fn's NamedTuple

    def fn(x):
        with profiling.span("test.inside"):  # once on the warm-up, once under capture
            for _ in range(5):
                x = x * 2 + 1
        return Out(x)

    x = torch.ones(64, device="cuda")
    graphed = CudaGraphed(fn, "cofii2p.ransac")
    with profiling.recording():
        (y,) = graphed(x)
        (y,) = graphed(x)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 63.0))
    inside = profiling._spans["test.inside"]
    assert inside.n == 2 and len(inside.pending) == 1  # the warm-up's events; none from the capture
    table = profiling.span_table()
    assert table["cofii2p.ransac.graph_nodes"]["value"] >= 5
    assert table["cofii2p.ransac.captures"]["value"] == 1
    for name in ("cofii2p.ransac", "cofii2p.ransac.replay"):
        assert table[name]["n"] == 2 and table[name]["device_ms"] > 0, name
