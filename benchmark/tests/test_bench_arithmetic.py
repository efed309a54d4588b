"""The yardstick's arithmetic against counts worked by hand."""

import json

import pytest
import torch

from benchmark.harness import stats, tracing, work


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_ms(3.35e12) == pytest.approx(1e3)
    assert work.bound_ms(0, ops16=989e12) == pytest.approx(1e3)
    assert work.bound_ms(0, ops32=67e9, ops_tf32x3=165e9) == pytest.approx(2.0)
    assert work.bound_ms(3.35e9, ops32=67e9) == pytest.approx(1.0)


def test_kpconv_work_by_hand():
    # B=1, 2 queries, 3 support rows, Cin 4, Cout 5, K 15, 6 in-reach pairs
    w = work.kpconv_work(1, 2, 3, 4, 5, 15, 6, 4, bf16=False)
    assert w["ops32"] == 6 * 15 * 15
    assert w["ops_tf32x3"] == 2 * 6 * 15 * 4 + 2 * 2 * 15 * 4 * 5
    assert w["nbytes"] == (2 + 3) * 12 + 3 * 4 * 4 + 15 * 4 * 5 * 4 + 2 * 6 * 4
    wb = work.kpconv_work(1, 2, 3, 4, 5, 15, 6, 2, bf16=True, backward=True)
    assert wb["ops32"] == 2 * 6 * 15 * 15
    assert wb["ops16"] == 2 * (2 * 6 * 15 * 4) + 2 * 2 * 15 * 4 * 5 + 4 * 2 * 15 * 4 * 5


def test_counter_counts_pairs_from_the_geometry():
    """One KPConv call on a band where every row lies within reach: the
    pairs are queries x band rows."""
    from benchmark.reference.ops import plain

    counter = work.Counter("float32", "full")
    q = torch.zeros(1, 4, 3)
    s = torch.zeros(1, 8, 3)
    s[0, :, 0] = torch.arange(8) * 1e-3
    feats = torch.ones(1, 8, 2)
    wts = torch.ones(15, 2, 3)

    def call():
        from benchmark.reference.models import kpconv as K

        K.banded_kpconv_fused_plain(feats, q, s, wts, 0.425, 0.2, 15, 4, 8)

    flops, bound, _ = counter.count(call)
    pairs = 4 * 8
    assert flops == pairs * 15 * 15 + 2 * pairs * 15 * 2 + 2 * 4 * 15 * 2 * 3
    assert bound > 0
    assert plain.banded_kpconv_fused_plain is not None


def test_attention_count_follows_the_fused_kernels_convention():
    from benchmark.reference.models import transformer as T

    q = torch.ones(1, 6, 2, 4)
    k = torch.ones(1, 5, 2, 4)
    for attention, extra in (("pallas", 5 * 2 * 6 * 5), ("full", 0)):
        counter = work.Counter("bfloat16", attention)
        flops, _, _ = counter.count(lambda: T.fused_attention_plain(q, k, k))
        assert flops == 2 * (2 * 2 * 6 * 5 * 4) + extra


def test_interval_union_and_gaps():
    busy, gaps = tracing.busy_and_gaps([(0, 4), (2, 6), (8, 9), (12, 20)], 1, 15)
    assert busy == (6 - 1) + (9 - 8) + (15 - 12)
    assert gaps == [(6, 8), (9, 12)]


def test_read_trace_on_a_synthetic_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 100, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.kpconv", "ts": 110, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 112, "dur": 5, "tid": 1,
         "args": {"Sequence number": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 113, "dur": 1, "tid": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 140, "dur": 1, "tid": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cpu_op", "name": "autograd::engine::evaluate_function: MmBackward0", "ts": 150,
         "dur": 10, "tid": 2, "args": {"Sequence number": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 151, "dur": 1, "tid": 2,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sleep", "ts": 170, "dur": 25, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 115, "dur": 10, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 120, "dur": 30, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 155, "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90, "dur": 15, "args": {}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = tracing.read_trace(str(path), "bench.window", ["bench.kpconv"])
    assert r["window_s"] == pytest.approx(100e-6)
    # device busy: [100,105) copy, [115,150) k1+k2, [155,160) k3
    assert r["busy_s"] == pytest.approx((5 + 35 + 5) * 1e-6)
    assert r["scoped_ms"]["bench.kpconv"] == pytest.approx(10e-3)
    assert r["device_ops"][0] == ["k2", pytest.approx(30e-6)]
    # the longest idle stretch, [160, 200), ran while the host slept
    assert r["idle_gaps"][0] == ["aten::sleep", pytest.approx(40e-6)]
    rb = tracing.read_trace(str(path), "bench.window", ["bench.kpconv"], backward=True)
    assert rb["scoped_ms"]["bench.kpconv"] == pytest.approx(15e-3)


def test_rate_and_p95_over_the_whole_window():
    lat = list(range(1, 101))
    assert stats.percentile(lat, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.rate(800, 40.0) == 20.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_the_check_sample_is_uniform_and_holds_only_its_requests():
    """The reservoir keeps k requests' outputs, whatever the window's
    length, each request equally likely, the same sample for one seed."""
    import collections

    from benchmark.harness.serve import Reservoir

    out = collections.namedtuple("Out", "R")
    seen = collections.Counter()
    for seed in range(2000):
        r = Reservoir(3, seed)
        for i in range(12):
            r.offer(i, out(i))
            assert len(r.kept) == min(i + 1, 3)
        assert all(v["R"] == k for k, v in r.kept.items())
        seen.update(list(r.kept))
    assert set(seen) == set(range(12))
    assert max(seen.values()) < 1.2 * 2000 * 3 / 12 and min(seen.values()) > 0.8 * 2000 * 3 / 12
    again = Reservoir(3, 7)
    for i in range(12):
        again.offer(i, out(i))
    first = Reservoir(3, 7)
    for i in range(12):
        first.offer(i, out(i))
    assert sorted(again.kept) == sorted(first.kept)


def test_serving_mfu_is_over_the_service_time():
    """An open loop's waits for arrivals do not count as the card's time."""
    from benchmark.harness import spec

    read = spec.reader("mfu.serve")
    t = {"kind": "serve", "traced_pools": [0, 1], "work": {0: {"flops": 1e12}, 1: {"flops": 3e12}},
         "traced_s": 10.0, "service_s": 2.0, "peak_flops": 1e15}
    assert read(t) == pytest.approx(100.0 * 4e12 / (2.0 * 1e15))
    assert read({**t, "service_s": 0.0}) is None
