"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package; each kernel wrapper takes its plain version for a CPU tensor
(launch counter untouched) and raises, never falls back, for a tensor it
cannot launch on; off the CPU a wrapper refuses inputs that require grad
under grad mode (its output would carry no autograd history), so
gradients reach the kernels only through the autograd Functions, and each
forward wrapper names the Function that differentiates through it; the
Functions, too, take the plain versions for CPU tensors and never fall
back for others; chip_smoke.py fails without a card; no source imports
OpenCV, and the package copied alone runs its host path; under
pytest-xdist the tests' PyTorch threads take each worker's share of the
cores."""

import ast
import ctypes
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import cofii2p_tpu_torch
from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.attention_kernel import fused_attention
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    BandedKPConvFn,
    BandedKPConvTauFn,
    banded_kpconv_aggregate_fused,
    banded_kpconv_aggregate_tau,
    banded_kpconv_apply,
    banded_kpconv_fused,
    banded_kpconv_fused_tau,
    banded_kpconv_tau_apply,
    banded_kpconv_transpose_dyn_fused,
    banded_kpconv_transpose_fused,
    banded_kpconv_transpose_tau_fused,
)
from cofii2p_tpu_torch.ops.maxpool_kernel import (
    BandedMaxpoolFn,
    BandedMaxpoolTauFn,
    banded_maxpool_apply,
    banded_maxpool_backward_dyn_fused,
    banded_maxpool_backward_fused,
    banded_maxpool_backward_tau_fused,
    banded_maxpool_fused,
    banded_maxpool_tau,
    banded_maxpool_tau_apply,
    banded_maxpool_tie_count_fused,
)
from cofii2p_tpu_torch.ops.norm_kernel import point_group_norm_fused
from cofii2p_tpu_torch.ops.residual_kernel import banded_residual_apply, banded_residual_fused
from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_kernel
from cofii2p_tpu_torch.ops.window_kernel import best_windows_fused
from cofii2p_tpu_torch.pose.ransac import ransac_pnp
from tests import torch_parity

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


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


# names of a JAX package __init__ that ROADMAP still lists as unported
STILL_UNPORTED = {"ops": set(), "models": set(), "data": set(), "pose": set()}


def _jax_all(package):
    tree = ast.parse(open(os.path.join(ROOT, "cofii2p_tpu", package, "__init__.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"cofii2p_tpu/{package}/__init__.py has no __all__")


@pytest.mark.parametrize("package", sorted(STILL_UNPORTED))
def test_package_exports_match_the_jax_package(package):
    """Every name of the JAX package's ``__all__`` (read by AST, without
    importing JAX) resolves on the port's twin package, as a user who
    swaps the package name imports it (F1)."""
    import importlib

    names = _jax_all(package)
    assert names
    mod = importlib.import_module(f"cofii2p_tpu_torch.{package}")
    missing = [n for n in names if not hasattr(mod, n) and n not in STILL_UNPORTED[package]]
    assert not missing, missing
    assert set(mod.__all__) >= set(names) - STILL_UNPORTED[package]


# public top-level names of a JAX module that its twin does not define,
# each on ROADMAP.md's "Not to port" list (every module file has a twin)
NOT_TO_PORT = {
    "train_lib.py": {"TrainState", "init_state"},
    "ops/attention_kernel.py": {"attention_available"},
    # the Pallas entry points: the port's wrappers are named after its kernels
    "ops/kpconv_kernel.py": {"banded_kpconv_aggregate_pallas", "banded_kpconv_aggregate_tau_pallas",
                             "banded_kpconv_fused_pallas", "banded_kpconv_fused_tau_pallas"},
    "ops/maxpool_kernel.py": {"banded_maxpool_pallas", "banded_maxpool_tau_pallas"},
    "ops/residual_kernel.py": {"banded_residual_fused_pallas"},
    "ops/tau_kernel.py": {"banded_knn_tau_pallas"},
    "evaluation/pipeline.py": {"make_eval_pipeline"},
    "models/layers.py": {"TorchLayerNorm", "torch_bias_init"},
    "models/resnet.py": {"Conv"},
    "native/__init__.py": {"available"},
}
JAX_PKG = os.path.join(ROOT, "cofii2p_tpu")


def _jax_modules():
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), JAX_PKG)


def _defined(path, public=True):
    """Top-level functions, classes and upper-case constants a module
    defines (and, of the port's, the names it imports)."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name) and (t.id.isupper() or not public))
        elif not public and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")} if public else names


def test_every_jax_module_has_a_twin():
    """Every module of the JAX package has a twin at the same path in the
    port: nothing of it is left to port."""
    missing = sorted(m for m in _jax_modules() if not os.path.exists(os.path.join(PKG, m)))
    assert not missing, missing


@pytest.mark.parametrize("module", sorted(_jax_modules()))
def test_every_public_name_has_a_twin_or_is_not_to_port(module):
    """Each public function, class and constant of a JAX module is defined
    (or imported) by its twin, or is on NOT_TO_PORT, and NOT_TO_PORT lists
    nothing the twin has."""
    twin = os.path.join(PKG, module)
    missing = _defined(os.path.join(JAX_PKG, module)) - _defined(twin, public=False)
    assert missing == NOT_TO_PORT.get(module, set())


def test_not_to_port_mirrors_the_roadmap():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    section = text[text.index("\nNot to port"):]
    section = section[:section.index("###")]
    absent = sorted(n for names in NOT_TO_PORT.values() for n in names if n not in section)
    assert not absent, absent


@pytest.mark.parametrize("first", ["cofii2p_tpu_torch.ops.banded", "cofii2p_tpu_torch.ops.kpconv_kernel",
                                   "cofii2p_tpu_torch.ops", "cofii2p_tpu_torch.models",
                                   "cofii2p_tpu_torch.models.kpconv", "cofii2p_tpu_torch.data"])
def test_a_package_imported_first_builds_nothing_and_cycles_nowhere(first):
    """Whichever module a fresh process imports first, the ops and models
    packages do not import each other into a half-initialised module, and
    nothing is built."""
    code = (
        f"import {first}\n"
        "import sys\n"
        "from cofii2p_tpu_torch.models import CoFiI2P\n"
        "from cofii2p_tpu_torch.data import prepare_samples, SyntheticDataset\n"
        "from cofii2p_tpu_torch.ops import knn, grid_subsample, radius_search\n"
        "cl = sys.modules.get('cofii2p_tpu_torch.ops.cuda_lib')\n"
        "assert cl is None or cl._lib is None\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    for name in _imported_names(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", sorted(port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_opencv(path):
    """The card's machine has no OpenCV: the loaders resize with their own
    numpy copy of its bilinear (data/kitti.py::resize_linear)."""
    assert not any(name.split(".")[0] == "cv2" for name in _imported_names(path))


def test_the_package_alone_runs_its_host_path(tmp_path):
    """A copy of cofii2p_tpu_torch/ alone, imported from a process whose
    cwd and sys.path hold that copy and nothing else of the repo, loads its
    kernel points, builds and calls its host ops and reads a fixture
    frame: the port reads no file of the JAX package."""
    shutil.copytree(PKG, tmp_path / "cofii2p_tpu_torch", ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        f"assert not any(p.startswith({ROOT!r}) for p in sys.path), sys.path\n"
        "import numpy as np\n"
        "import cofii2p_tpu_torch\n"
        f"assert cofii2p_tpu_torch.__file__.startswith({str(tmp_path)!r})\n"
        "from cofii2p_tpu_torch.models.kernel_points import load_kernel_points\n"
        "kp = load_kernel_points(1.0)\n"
        "assert kp.shape == (15, 3) and not kp[0].any()\n"
        "from cofii2p_tpu_torch import native\n"
        f"assert native.library_path().startswith({str(tmp_path)!r})\n"
        "pts, _ = native.voxel_downsample(np.random.RandomState(0).rand(500, 3).astype(np.float32), None, 0.25)\n"
        "assert 0 < len(pts) <= 64\n"
        "from cofii2p_tpu_torch.config import TinyConfig\n"
        "from cofii2p_tpu_torch.data.fixtures import write_kitti_tree\n"
        "from cofii2p_tpu_torch.data.kitti import KittiDataset\n"
        f"root = write_kitti_tree({str(tmp_path / 'kitti')!r}, 0, {{9: 1}}, points=3000)\n"
        "frame = KittiDataset(TinyConfig(data_path=root), 'val')[0]\n"
        "assert frame['img'].shape == (32, 64, 3) and frame['pc'].shape == (512, 3)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('cv2',)!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-I", "-c", code], cwd=tmp_path, capture_output=True, text=True, env=env)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    assert list((tmp_path / "build" / "cofii2p_tpu_torch").glob("libhost_ops_*.so"))


def _inputs(device, dtype, grad):
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(1, 256, 3, generator=g) * 8).to(device)
    f = torch.randn(1, 256, 8, generator=g).to(device, dtype).requires_grad_(grad)
    return g, pts, f


def _kpconv(device, dtype=torch.float32, grad=False):
    g, pts, f = _inputs(device, dtype, grad)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_kpconv_fused(f, pts, pts, w, 0.85, 0.4, 15, 128, 64)


def _kpconv_bf16(device, dtype=torch.bfloat16, grad=False):
    """bf16 compute on the widths of the tensor-core kernel (8 pads to 32)."""
    g, pts, f = _inputs(device, dtype, grad)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_kpconv_fused(f, pts, pts, w, 0.85, 0.4, 15, 128, 64, torch.bfloat16)


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


def _tau_args(device, dtype, grad):
    g, pts, f = _inputs(device, dtype, grad)
    tau = torch.rand(1, 256, generator=g).to(device)
    kp = torch.randn(15, 3, generator=g).to(device)
    return g, pts, f, tau, kp


def _knn_tau(device, dtype=torch.float32, grad=False):
    _, pts, _ = _inputs(device, dtype, False)
    return lambda: banded_knn_tau_kernel(pts, pts, 16, 128, 64)


def _kpconv_tau(device, dtype=torch.float32, grad=False):
    g, pts, f, tau, kp = _tau_args(device, dtype, grad)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_kpconv_fused_tau(f, pts, pts, w, tau, kp, 0.85, 0.4, 15, 128, 64)


def _aggregate_tau(device, dtype=torch.float32, grad=False):
    _, pts, f, tau, kp = _tau_args(device, dtype, grad)
    return lambda: banded_kpconv_aggregate_tau(f, pts, pts, tau, kp, 0.85, 0.4, 15, 128, 64)


def _maxpool_tau(device, dtype=torch.float32, grad=False):
    _, pts, f, tau, _ = _tau_args(device, dtype, grad)
    return lambda: banded_maxpool_tau(f, pts, pts, tau, 128, 64)


def _starts(device):
    return torch.zeros(1, 2, dtype=torch.int32).to(device)


def _transpose_dyn(device, dtype=torch.float32, grad=False):
    g, pts, _ = _inputs(device, dtype, False)
    gw = torch.randn(1, 256, 15, 8, generator=g).to(device).requires_grad_(grad)
    return lambda: banded_kpconv_transpose_dyn_fused(gw, pts, pts, _starts(device), 0.85, 0.4, 15, 128, 64)


def _transpose_tau(device, dtype=torch.float32, grad=False):
    g, pts, _, tau, kp = _tau_args(device, dtype, False)
    gw = torch.randn(1, 256, 15, 8, generator=g).to(device).requires_grad_(grad)
    return lambda: banded_kpconv_transpose_tau_fused(gw, pts, pts, tau, kp, 0.85, 0.4, 15, 128, 64)


def _tie_count_dyn(device, dtype=torch.float32, grad=False):
    _, pts, f, out = _pooled(device, dtype, grad)
    return lambda: banded_maxpool_tie_count_fused(f, pts, pts, out, 1.0, 128, 64, _starts(device))


def _tie_count_tau(device, dtype=torch.float32, grad=False):
    _, pts, f, tau, _ = _tau_args(device, dtype, grad)
    out = torch.randn(1, 256, 8, generator=torch.Generator().manual_seed(1)).to(device, dtype)
    return lambda: banded_maxpool_tie_count_fused(f, pts, pts, out, 0.0, 128, 64, tau=tau)


def _maxpool_bwd_dyn(device, dtype=torch.float32, grad=False):
    g, pts, f, out = _pooled(device, dtype, grad)
    gs = torch.randn(1, 256, 8, generator=g).to(device)
    return lambda: banded_maxpool_backward_dyn_fused(gs, f, pts, pts, out, _starts(device), 1.0, 128, 64)


def _maxpool_bwd_tau(device, dtype=torch.float32, grad=False):
    g, pts, f, tau, _ = _tau_args(device, dtype, grad)
    out = torch.randn(1, 256, 8, generator=g).to(device, dtype)
    gs = torch.randn(1, 256, 8, generator=g).to(device)
    return lambda: banded_maxpool_backward_tau_fused(gs, f, pts, pts, out, tau, 128, 64)


def _residual(device, dtype=torch.float32, grad=False):
    g, pts, f = _inputs(device, dtype, grad)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_residual_fused(f, f, w, pts, pts, 0.85, 0.4, 15, 128, 64)


def _residual_bf16(device, dtype=torch.bfloat16, grad=False):
    g, pts, f = _inputs(device, dtype, grad)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_residual_fused(f, f, w, pts, pts, 0.85, 0.4, 15, 128, 64, torch.bfloat16)


def _attention(device, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 32, generator=g).to(device, dtype).requires_grad_(grad)
    return lambda: fused_attention(q, q, q)


def _ransac(device, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(0)
    gumbel = torch.randn(2, 8, 16, generator=g).to(device).requires_grad_(grad)
    obj = (torch.randn(2, 16, 3, generator=g) + torch.tensor([0.0, 0.0, 5.0])).to(device)
    uv = (torch.rand(2, 16, 2, generator=g) * 64).to(device)
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]).expand(2, 3, 3).to(device)
    mask = torch.ones(2, 16).to(device)
    return lambda: ransac_pnp(gumbel, obj, uv, K, mask)


def _point_norm(device, dtype=torch.float32, grad=False, residual=False):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 64, generator=g).to(device, dtype).requires_grad_(grad)
    r = torch.randn(2, 64, 64, generator=g).to(device, dtype) if residual else None
    w, b = torch.ones(64).to(device), torch.zeros(64).to(device)
    return lambda: point_group_norm_fused(x, w, b, 32, relu=True, residual=r)


def _window_starts(device, dtype=torch.float32, grad=False, per_query=False):
    _, pts, _ = _inputs(device, dtype, False)
    thr = torch.rand(1, 256, generator=torch.Generator().manual_seed(1)).to(device) if per_query else 1.0
    return lambda: best_windows_fused(pts, pts, thr, 128, 64, 2)


WRAPPERS = {"kpconv": (banded_kpconv_fused, _kpconv), "maxpool": (banded_maxpool_fused, _maxpool),
            "attention": (fused_attention, _attention),
            "kpconv_aggregate": (banded_kpconv_aggregate_fused, _aggregate),
            "kpconv_transpose": (banded_kpconv_transpose_fused, _transpose),
            "maxpool_count": (banded_maxpool_tie_count_fused, _tie_count),
            "maxpool_bwd": (banded_maxpool_backward_fused, _maxpool_bwd),
            "knn_tau": (banded_knn_tau_kernel, _knn_tau), "kpconv_tau": (banded_kpconv_fused_tau, _kpconv_tau),
            "kpconv_aggregate_tau": (banded_kpconv_aggregate_tau, _aggregate_tau),
            "maxpool_tau": (banded_maxpool_tau, _maxpool_tau),
            "kpconv_transpose_dyn": (banded_kpconv_transpose_dyn_fused, _transpose_dyn),
            "kpconv_transpose_tau": (banded_kpconv_transpose_tau_fused, _transpose_tau),
            "maxpool_count_dyn": (banded_maxpool_tie_count_fused, _tie_count_dyn),
            "maxpool_count_tau": (banded_maxpool_tie_count_fused, _tie_count_tau),
            "maxpool_bwd_dyn": (banded_maxpool_backward_dyn_fused, _maxpool_bwd_dyn),
            "maxpool_bwd_tau": (banded_maxpool_backward_tau_fused, _maxpool_bwd_tau),
            "residual_fused": (banded_residual_fused, _residual),
            "kpconv_bf16": (banded_kpconv_fused, _kpconv_bf16),
            "residual_fused_bf16": (banded_residual_fused, _residual_bf16),
            "attention_bf16": (fused_attention, lambda device, grad=False: _attention(device, torch.bfloat16, grad)),
            "ransac_pnp": (ransac_pnp, _ransac),
            "point_norm": (point_group_norm_fused, _point_norm),
            "point_norm_bf16_residual": (point_group_norm_fused, lambda device, grad=False: _point_norm(
                device, torch.bfloat16, grad, residual=True)),
            "window_starts": (best_windows_fused, _window_starts),
            "window_starts_per_query": (best_windows_fused, lambda device, grad=False: _window_starts(
                device, per_query=True))}
# tau and the window starts are functions of coordinates only, with no
# gradient: they have no input to refuse
GRAD_WRAPPERS = sorted(set(WRAPPERS) - {"knn_tau", "window_starts", "window_starts_per_query"})
# the k-NN forward wrappers and the autograd Function each names
TAU_BACKWARDS = {"kpconv_tau": "BandedKPConvTauFn", "kpconv_aggregate_tau": "BandedKPConvTauFn",
                 "maxpool_tau": "BandedMaxpoolTauFn"}


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


@pytest.mark.parametrize("name", GRAD_WRAPPERS)
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


@pytest.mark.parametrize("name", sorted(TAU_BACKWARDS))
def test_tau_wrappers_name_their_missing_backward(name):
    """The k-NN forward wrappers refuse an input that requires grad and
    name the autograd Function that differentiates through them."""
    wrapper, make = WRAPPERS[name]
    with pytest.raises(RuntimeError, match=TAU_BACKWARDS[name]):
        make("meta", grad=True)()
    assert wrapper.launches == 0


def _c_launchers() -> dict:
    """Each ``extern "C"`` launcher of csrc/*.cu: its parameter list."""
    found = {}
    for f in sorted(os.listdir(cuda_lib.CSRC)):
        if f.endswith(".cu"):
            src = open(os.path.join(cuda_lib.CSRC, f)).read()
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
                found[m.group(1)] = [" ".join(a.split()) for a in m.group(2).split(",")]
    return found


def test_every_launcher_has_a_signature():
    assert set(_c_launchers()) == set(cuda_lib.SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_lib.SIGNATURES))
def test_launcher_signature_matches_its_c_source(name):
    """ctypes passes each argument as SIGNATURES types it: a pointer (and
    the stream) as a void pointer, an int as an int, a float as a float,
    so a launcher whose parameters changed in C fails here, not on the
    card with a cut pointer."""
    params = _c_launchers()[name]
    sig = cuda_lib.SIGNATURES[name]
    assert len(params) == len(sig)
    for p, t in zip(params, sig):
        want = ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float") else ctypes.c_int
        assert t is want, f"{name}: {p!r} bound as {t.__name__}"


def _fn_kpconv(device):
    g, pts, f = _inputs(device, torch.float32, True)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_kpconv_apply(f, pts, pts, w, 0.85, 0.4, 15, 128, 64)


def _fn_kpconv_dyn(device):
    g, pts, f = _inputs(device, torch.float32, True)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_kpconv_apply(f, pts, pts, w, 0.85, 0.4, 15, 128, 64, starts=_starts(device))


def _fn_kpconv_tau(device):
    g, pts, f, tau, kp = _tau_args(device, torch.float32, True)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_kpconv_tau_apply(f, pts, pts, w, tau, kp, 0.85, 0.4, 15, 128, 64)


def _fn_maxpool(device):
    _, pts, f = _inputs(device, torch.float32, True)
    return lambda: banded_maxpool_apply(f, pts, pts, 1.0, 128, 64, _starts(device))


def _fn_maxpool_tau(device):
    _, pts, f, tau, _ = _tau_args(device, torch.float32, True)
    return lambda: banded_maxpool_tau_apply(f, pts, pts, tau, 128, 64)


def _fn_residual(device):
    g, pts, f = _inputs(device, torch.float32, True)
    w = torch.randn(15, 8, 8, generator=g).to(device)
    return lambda: banded_residual_apply(f, f, w, pts, pts, 0.85, 0.4, 15, 128, 64)


FUNCTIONS = {"kpconv": (BandedKPConvFn, _fn_kpconv), "kpconv_dyn": (BandedKPConvFn, _fn_kpconv_dyn),
             "kpconv_tau": (BandedKPConvTauFn, _fn_kpconv_tau), "maxpool_dyn": (BandedMaxpoolFn, _fn_maxpool),
             "maxpool_tau": (BandedMaxpoolTauFn, _fn_maxpool_tau), "residual": (BandedKPConvFn, _fn_residual)}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functions_take_plain_versions_on_cpu_and_never_fall_back(name):
    """Differentiated, the model's dispatchers go through the autograd
    Functions: on CPU tensors their forward and backward run the plain
    versions (every launch counter stays 0); on a tensor that is not on the
    CPU (a meta tensor) the forward goes to the kernel path, which raises."""
    fn, make = FUNCTIONS[name]
    wrappers = [w for w, _ in WRAPPERS.values()]
    for w in wrappers:
        w.launches = 0
    res = make("cpu")()
    out = res[0] if isinstance(res, tuple) else res
    assert out.grad_fn.name().startswith(fn.__name__)
    out.sum().backward()
    assert all(w.launches == 0 for w in wrappers)
    with pytest.raises(ValueError):
        make("meta")()
    assert all(w.launches == 0 for w in wrappers)


def test_chip_smoke_fails_without_card_and_alone(tmp_path):
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout


@pytest.mark.parametrize("workers,cores,threads", [(6, 8, 1), (2, 8, 4), (8, 4, 1), (None, 8, None), ("running", None, None)],
                         ids=["6_workers_8_cores", "2_workers_8_cores", "8_workers_4_cores", "no_xdist", "this_process"])
def test_each_xdist_worker_takes_its_share_of_the_cores(workers, cores, threads):
    """tests/torch_parity.py's thread budget: an equal share of the cores
    for each xdist worker, at least one thread, and PyTorch's default left
    alone outside xdist; the running process's pool keeps within it."""
    if workers == "running":
        workers = torch_parity.xdist_workers() or 1
        assert torch.get_num_threads() * workers <= max(torch_parity.usable_cores(), workers)
    else:
        assert torch_parity.cpu_threads(workers, cores) == threads
