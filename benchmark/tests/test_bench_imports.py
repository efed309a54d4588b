"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "cofii2p_tpu"}

SCRIPT = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(4)
from benchmark import run
from conftest import tiny_cell
bench, wl, conf, traffic, limits = tiny_cell("kitti_t7-serve-b8")
run.run_cell(bench, wl, conf, traffic, limits, 3, 0.2, False, time.perf_counter(), "cpu", log=lambda m: None)
print(run.forbidden_modules())
"""


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_a_run_loads_no_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT, tests=os.path.join(HERE, "tests"))],
                         capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout[-2000:]


def test_forbidden_names_are_compared_whole():
    import types

    import cofii2p_tpu_torch  # noqa: F401
    from benchmark import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    before = run.forbidden_modules()
    sys.modules["cofii2p_tpu.fake_for_test"] = types.ModuleType("fake")
    try:
        assert "cofii2p_tpu" in run.forbidden_modules()
    finally:
        del sys.modules["cofii2p_tpu.fake_for_test"]
    assert "cofii2p_tpu_torch" not in before


@pytest.mark.parametrize("sub", ["reference", "harness", "metrics"])
def test_sources_import_no_jax(sub):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, f))}
                assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
                if sub == "reference":
                    assert "cofii2p_tpu_torch" not in tops, f
