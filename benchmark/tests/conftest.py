"""CPU tests of the benchmark harness (pytest benchmark/tests).  Tests that
need the card carry the ``gpu`` marker and skip here."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


import dataclasses  # noqa: E402

import pytest  # noqa: E402

# the fields that give a configuration its semantics, kept at tiny sizes
SEMANTICS = ("kpconv_impl", "kpconv_shared_influence", "fine_decode", "attention", "compute_dtype")


def tiny_cell(workload: str):
    """(BENCHMARK.json, its entry for ``workload``, the configuration, the
    traffic and the limits) with the configuration cut to TinyConfig's
    sizes and the traffic to 2 frames a request or step."""
    from benchmark.harness import spec
    from cofii2p_tpu_torch.config import TinyConfig

    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    conf = spec.config(wl["config"])
    traffic = spec.traffic(wl["traffic"])
    conf["model"] = {**dataclasses.asdict(TinyConfig()), **{k: v for k, v in conf["model"].items() if k in SEMANTICS}}
    for path in conf["paths"].values():
        path["fields"] = {k: v for k, v in path["fields"].items() if k in SEMANTICS}
    traffic.update(batch=2, pool_batches=2 if traffic["kind"] == "serve" else 3, warmup_requests=1, check_requests=2)
    return bench, wl, conf, traffic, spec.limits(workload)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
