"""One run of each cell on the card (skips without one)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, trace):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        workloads = [w["name"] for w in json.load(f)["workloads"]]
    for name in workloads:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", "5",
                              "--seconds", "2", "--trace", str(trace)], capture_output=True, text=True, cwd=ROOT,
                             timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
