"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package; each kernel wrapper takes its plain version for a CPU tensor
(launch counter untouched) and raises, never falls back, for a tensor it
cannot launch on; off the CPU a wrapper refuses inputs that require grad
under grad mode (its output would carry no autograd history), so
gradients reach the kernels only through the autograd Functions;
chip_smoke.py fails without a card."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import cofii2p_tpu_torch
from cofii2p_tpu_torch.ops.attention_kernel import fused_attention
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    banded_kpconv_aggregate_fused,
    banded_kpconv_fused,
    banded_kpconv_transpose_fused,
)
from cofii2p_tpu_torch.ops.maxpool_kernel import (
    banded_maxpool_backward_fused,
    banded_maxpool_fused,
    banded_maxpool_tie_count_fused,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(cofii2p_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cofii2p_tpu")


def port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cofii2p_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'cofii2p_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 37  # 32 modules before training was ported


@pytest.mark.parametrize("path", sorted(port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def _inputs(device, dtype, grad):
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(1, 256, 3, generator=g) * 8).to(device)
    f = torch.randn(1, 256, 8, generator=g).to(device, dtype).requires_grad_(grad)
    return g, pts, f


def _kpconv(device, dtype=torch.float32, grad=False):
    g, pts, f = _inputs(device, dtype, grad)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_kpconv_fused(f, pts, pts, w, 0.85, 0.4, 15, 128, 64)


def _aggregate(device, dtype=torch.float32, grad=False):
    _, pts, f = _inputs(device, dtype, grad)
    return lambda: banded_kpconv_aggregate_fused(f, pts, pts, 0.85, 0.4, 15, 128, 64)


def _transpose(device, dtype=torch.float32, grad=False):
    g, pts, _ = _inputs(device, dtype, False)
    gw = torch.randn(1, 256, 15, 8, generator=g).to(device).requires_grad_(grad)
    return lambda: banded_kpconv_transpose_fused(gw, pts, pts, 0.85, 0.4, 15, 128, 64)


def _maxpool(device, dtype=torch.float32, grad=False):
    _, pts, f = _inputs(device, dtype, grad)
    return lambda: banded_maxpool_fused(f, pts, pts, 1.0, 128, 64)


def _pooled(device, dtype, grad):
    g, pts, f = _inputs(device, dtype, grad)
    out = torch.randn(1, 256, 8, generator=g).to(device, dtype)
    return g, pts, f, out


def _tie_count(device, dtype=torch.float32, grad=False):
    _, pts, f, out = _pooled(device, dtype, grad)
    return lambda: banded_maxpool_tie_count_fused(f, pts, pts, out, 1.0, 128, 64)


def _maxpool_bwd(device, dtype=torch.float32, grad=False):
    g, pts, f, out = _pooled(device, dtype, grad)
    gs = torch.randn(1, 256, 8, generator=g).to(device)
    return lambda: banded_maxpool_backward_fused(gs, f, pts, pts, out, 1.0, 128, 64)


def _attention(device, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 32, generator=g).to(device, dtype).requires_grad_(grad)
    return lambda: fused_attention(q, q, q)


WRAPPERS = {"kpconv": (banded_kpconv_fused, _kpconv), "maxpool": (banded_maxpool_fused, _maxpool),
            "attention": (fused_attention, _attention),
            "kpconv_aggregate": (banded_kpconv_aggregate_fused, _aggregate),
            "kpconv_transpose": (banded_kpconv_transpose_fused, _transpose),
            "maxpool_count": (banded_maxpool_tie_count_fused, _tie_count),
            "maxpool_bwd": (banded_maxpool_backward_fused, _maxpool_bwd)}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_tensor_takes_plain_version_and_counts_nothing(name):
    wrapper, make = WRAPPERS[name]
    wrapper.launches = 0
    out = make("cpu")()
    assert wrapper.launches == 0
    assert all(t.device.type == "cpu" for t in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_non_cpu_tensor_never_falls_back(name):
    """A tensor that is not on the CPU goes to the kernel path, which raises
    for anything it cannot launch on (here a meta tensor) instead of
    computing the plain version."""
    wrapper, make = WRAPPERS[name]
    wrapper.launches = 0
    with pytest.raises(ValueError):
        make("meta")()
    assert wrapper.launches == 0


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_non_cpu_tensor_requiring_grad_is_refused(name):
    """Off the CPU a wrapper's output carries no autograd history, so an
    input that requires grad under grad mode raises before any launch;
    with grad mode off the same call goes on to the launch checks.  The
    fused attention has no backward at all (the JAX package has none)."""
    wrapper, make = WRAPPERS[name]
    wrapper.launches = 0
    with pytest.raises(RuntimeError, match="no autograd history"):
        make("meta", grad=True)()
    with torch.no_grad(), pytest.raises(ValueError):
        make("meta", grad=True)()
    assert wrapper.launches == 0


def test_chip_smoke_fails_without_card_and_alone(tmp_path):
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
