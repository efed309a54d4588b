"""Kernel #19, the dynamic windows' placement (csrc/window_starts.cu,
ops/window_kernel.py), against its plain version ops/banded.py::
_best_windows.

On the CPU: the dispatcher takes the plain version for a CPU tensor and
counts it in ``cofii2p.windows.plain``; tests/window_starts_host.cc builds
the kernel's steps (csrc/window_starts.cuh) with the host compiler behind
the launcher's C entry point, and its starts are bit-equal to the plain
version's at strides 1, 2 and 4, an N the stride does not divide, one and
per-query thresholds, duplicated points, windows tied for the most pairs, tiles with no in-reach row and
starts clamped at both edges; the wrapper's limits are the header's.

On the card (marked ``gpu``, skipped without one; the file imports no
JAX: ``python -m pytest --noconftest tests/test_torch_window_starts.py``):
the kernel's starts bit-equal to the plain version's on the five serving
pairs at B = 8 and 1 (KITTI-shaped pyramids with and without duplicated
points, radius and per-query thresholds), at the CPU cases' shapes, the
same starts from a CUDA graph's replay as eagerly, the dispatcher's
counter, and a refusal of inputs it does not take.
"""

import ctypes
import importlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops import window_kernel as wk
from cofii2p_tpu_torch.ops.banded import _best_windows, dynamic_band_starts, dynamic_knn_starts, kernel_reach
from cofii2p_tpu_torch.ops.pyramid import morton_order
from cofii2p_tpu_torch.utils.profiling import counter

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
R0, S0 = 0.425, 0.2  # KITTIConfig's init_radius and init_sigma
SIZES = (20480, 10240, 5120, 2560, 1280)  # KITTIConfig's pyramid_sizes
# the serving plan's windowed pairs (kpconv_dynamic_plan (0, 192, 192, 192,
# 0), self (0, 0, 192, 192, 0)): query level, support level, radius scale;
# the model's stride N // 2560 samples 2560 rows of each
SERVE_PAIRS = ((2, 1, 2), (2, 2, 4), (3, 2, 4), (3, 3, 8), (4, 3, 8))
SERVE_WIDTH = 192


def cloud(b, n, gen, extent=(80.0, 4.0, 80.0), dup=0):
    """(b, n, 3) Morton-ordered clouds of KITTI extent; ``dup`` > 0 makes
    one row in ``dup`` a copy of another, so that window counts tie."""
    out = []
    for _ in range(b):
        u = torch.rand(n, 3, generator=gen)
        pts = torch.stack([u[:, 0] * extent[0] - extent[0] / 2, u[:, 1] * extent[1] - extent[1] / 2,
                           u[:, 2] * extent[2]], -1)
        if dup:
            copies = n // dup
            pts[n - copies:] = pts[torch.randint(0, n - copies, (copies,), generator=gen)]
        out.append(pts[morton_order(pts, ordering="xz")])
    return torch.stack(out)


def far_tiles(q, s, tiles, tile):
    """q with the given tiles moved far beyond every support point, so that
    no sampled row is in reach and the static start is taken."""
    q = q.clone()
    for t in tiles:
        q[:, t * tile:(t + 1) * tile] += 1000.0
    return q


# (name, b, m, n, tile, width, stride, kind): kind "radius" (one threshold)
# or "tau" (one a query), "dup" for duplicated points, "twins" for two
# windows holding the most pairs, "far" for tiles with no in-reach row,
# "edge" for starts clamped at 0 and N - width
CASES = [
    ("stride1", 2, 512, 1000, 128, 64, 1, "radius"),
    ("stride2_odd_n", 2, 512, 1001, 128, 64, 2, "radius"),
    ("stride4_odd_n", 2, 384, 2050, 128, 192, 4, "radius"),
    ("tau_stride1", 2, 512, 1000, 128, 64, 1, "tau"),
    ("tau_stride4", 1, 256, 4099, 128, 256, 4, "tau"),
    ("dup_ties", 2, 512, 1024, 128, 64, 2, "dup"),
    ("twin_windows", 2, 128, 1000, 128, 128, 1, "twins"),
    ("far_tiles", 2, 512, 1000, 128, 64, 1, "far"),
    ("edges", 2, 512, 1001, 128, 256, 2, "edge"),
    ("tile_100", 1, 100, 700, 128, 96, 1, "radius"),
    ("tile_64", 2, 192, 513, 64, 40, 3, "radius"),
    ("width_is_n", 1, 256, 300, 128, 400, 1, "radius"),
    ("width_below_stride", 1, 256, 900, 128, 3, 4, "radius"),
    ("rows_over_threads", 1, 256, 3001, 128, 600, 1, "tau"),
]


def case_inputs(kind, b, m, n, tile, gen):
    """(q, s, threshold) of a case on the CPU."""
    ext = (8.0, 2.0, 8.0)
    if kind == "dup":
        s = cloud(b, n, gen, ext, dup=2)
        q = s[:, torch.randperm(n, generator=gen)[:m].sort().values]
    else:
        s = cloud(b, n, gen, ext)
        q = cloud(b, m, gen, ext)
    if kind == "far":
        q = far_tiles(q, s, (0, 2), tile)
    if kind == "edge":
        # the first tile out of reach, where the static start is negative;
        # the last tile's queries at the last row, the only member, whose
        # first window starts past N - width at a stride of 2
        q = far_tiles(q, s, (0,), tile)
        q[:, -tile:] = s[:, -1:] + 1e-3 * torch.rand(b, tile, 3, generator=gen)
        return q, s, 1e-4
    if kind == "twins":
        # one cluster of 100 points at rows 300-399 and again at 700-799,
        # the other rows far away, the queries on the cluster: the windows
        # at 272-300 and 672-700 all hold every pair, and the first wins
        s = s.clone() + 1000.0
        s[:, 300:400] = torch.rand(b, 100, 3, generator=gen) * 0.1
        s[:, 700:800] = s[:, 300:400]
        q = s[:, 300:400][:, torch.arange(m) % 100]
        return q, s, 1.0
    if kind == "tau":
        return q, s, (torch.rand(b, m, generator=gen) * 2.0).contiguous()
    return q, s, float(kernel_reach(0.5, 0.25)) ** 2


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("window_host") / "window_host.so")
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's steps for the CPU"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", cuda_lib.CSRC, "-o", out,
                    os.path.join(HERE, "window_starts_host.cc")], check=True)
    lib = ctypes.CDLL(out)
    lib.window_starts_launch.argtypes = cuda_lib.SIGNATURES["window_starts_launch"]
    lib.window_starts_launch.restype = ctypes.c_int
    return lib


def host_starts(lib, q, s, threshold, tile, width, stride):
    tile, num_tiles = wk._dyn_tile(q.shape[1], tile)
    out = torch.empty(q.shape[0], num_tiles, dtype=torch.int32)
    per_query = isinstance(threshold, torch.Tensor)
    err = lib.window_starts_launch(q.data_ptr(), s.data_ptr(), threshold.data_ptr() if per_query else None,
                                   0.0 if per_query else threshold, out.data_ptr(), q.shape[0], q.shape[1],
                                   s.shape[1], tile, stride, width, None)
    assert err == 0
    return out


@pytest.mark.parametrize("name, b, m, n, tile, width, stride, kind", CASES, ids=[c[0] for c in CASES])
def test_host_build_of_the_kernel_matches_the_plain_version(host_lib, name, b, m, n, tile, width, stride, kind):
    gen = torch.Generator().manual_seed(m * 7 + n)
    q, s, thr = case_inputs(kind, b, m, n, tile, gen)
    want = _best_windows(q, s, thr, tile, width, stride)
    got = host_starts(host_lib, q, s, thr, tile, width, stride)
    assert torch.equal(got, want), (got, want)
    static = ((2 * torch.arange(want.shape[1]) * min(tile, m) + min(tile, m)) * n) // (2 * m) - min(width, n) // 2
    if kind == "far":  # the far tiles take the static start
        assert torch.equal(want[:, [0, 2]], static[[0, 2]].clamp(0, n - min(width, n)).int().expand(b, 2))
    if kind == "edge":
        assert (want[:, 0] == 0).all() and (want[:, -1] == n - min(width, n)).all()
    if kind == "twins":
        assert (want == 272).all()


@pytest.mark.parametrize("kind", ["radius", "tau"])
def test_cpu_dispatch_takes_the_plain_version_and_counts_it(kind):
    gen = torch.Generator().manual_seed(3)
    q, s, thr = case_inputs(kind, 2, 512, 1000, 128, gen)
    plain, kernel = counter("cofii2p.windows.plain"), counter("cofii2p.windows.kernel")
    before = (plain.value, kernel.value, wk.best_windows_fused.launches)
    if kind == "tau":
        got = dynamic_knn_starts(q, s, thr, 128, 64, 2)
    else:
        r_act = kernel_reach(0.5, 0.25)
        got = dynamic_band_starts(q, s, r_act, 128, 64, "best", 2)
        thr = float(np.float32(np.float32(r_act * r_act) * np.float32(1.0001)))
    assert (plain.value, kernel.value, wk.best_windows_fused.launches) == (before[0] + 1, before[1], before[2])
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    assert torch.equal(got, _best_windows(q, s, thr, 128, 64, 2))


def test_wrapper_limits_are_the_headers():
    src = open(os.path.join(cuda_lib.CSRC, "window_starts.cuh")).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kMaxTile"]), int(consts["kMaxRows"])) == (wk.MAX_TILE, wk.MAX_ROWS)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def serving_pyramid(b, seed, device, dup):
    """The KITTI pyramid's levels at B = b: chip_smoke.py's duplicated-point
    pyramid (each level a subset of the one before, one row in 8 a copy),
    or independent clouds per level."""
    gen = torch.Generator().manual_seed(seed)
    if dup:
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        levels, _ = importlib.import_module("chip_smoke").pyramid_with_duplicates(SIZES, b, gen, device)
        return levels
    return [cloud(b, n, gen).to(device) for n in SIZES]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 1])
@pytest.mark.parametrize("dup", [True, False], ids=["duplicates", "distinct"])
@pytest.mark.parametrize("kind", ["radius", "tau"])
def test_kernel_matches_plain_on_the_serving_pairs(cuda_device, b, dup, kind):
    levels = serving_pyramid(b, 11 + b, cuda_device, dup)
    gen = torch.Generator().manual_seed(b)
    for ql, sl, scale in SERVE_PAIRS:
        q, s = levels[ql], levels[sl]
        stride = max(1, s.shape[1] // 2560)
        r_act = kernel_reach(R0 * scale, S0 * scale)
        if kind == "tau":
            thr = (torch.rand(q.shape[:2], generator=gen) * 2 * r_act * r_act).to(cuda_device)
        else:
            thr = float(r_act * r_act * 1.0001)
        got = wk.best_windows_fused(q, s, thr, 128, SERVE_WIDTH, stride)
        want = _best_windows(q, s, thr, 128, SERVE_WIDTH, stride)
        assert got.dtype == torch.int32 and got.shape == (b, q.shape[1] // 128)
        assert torch.equal(got, want), (ql, sl, (got != want).sum().item())
        assert torch.equal(wk.best_windows_fused(q, s, thr, 128, SERVE_WIDTH, stride), got)


@pytest.mark.gpu
@pytest.mark.parametrize("name, b, m, n, tile, width, stride, kind", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_at_the_cpu_cases(cuda_device, name, b, m, n, tile, width, stride, kind):
    gen = torch.Generator().manual_seed(m * 7 + n)
    q, s, thr = case_inputs(kind, b, m, n, tile, gen)
    q, s = q.to(cuda_device), s.to(cuda_device)
    thr = thr.to(cuda_device) if isinstance(thr, torch.Tensor) else thr
    got = wk.best_windows_fused(q, s, thr, tile, width, stride)
    assert torch.equal(got, _best_windows(q, s, thr, tile, width, stride))


@pytest.mark.gpu
def test_graph_replay_equals_eager(cuda_device):
    levels = serving_pyramid(8, 3, cuda_device, True)
    q, s = levels[2], levels[1]
    thr = float(kernel_reach(R0 * 2, S0 * 2)) ** 2
    eager = wk.best_windows_fused(q, s, thr, 128, SERVE_WIDTH, 4)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wk.best_windows_fused(q, s, thr, 128, SERVE_WIDTH, 4)
    out.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
def test_dispatch_on_the_card_counts_the_kernel(cuda_device):
    q, s = (x.to(cuda_device) for x in serving_pyramid(1, 4, cuda_device, False)[2:4])
    plain, kernel = counter("cofii2p.windows.plain"), counter("cofii2p.windows.kernel")
    before = (plain.value, kernel.value, wk.best_windows_fused.launches)
    got = dynamic_band_starts(q, s, kernel_reach(R0 * 4, S0 * 4), 128, SERVE_WIDTH, "best", 2)
    assert (plain.value, kernel.value, wk.best_windows_fused.launches) == (before[0], before[1] + 1, before[2] + 1)
    assert got.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["fp64", "bf16_tau", "cpu_s", "strided_q", "tau_shape"])
def test_kernel_refuses_inputs_it_does_not_take(cuda_device, fault):
    gen = torch.Generator().manual_seed(2)
    q, s = cloud(1, 256, gen).to(cuda_device), cloud(1, 512, gen).to(cuda_device)
    thr = torch.rand(1, 256, generator=gen).to(cuda_device)
    if fault == "fp64":
        q = q.double()
    elif fault == "bf16_tau":
        thr = thr.bfloat16()
    elif fault == "cpu_s":
        s = s.cpu()
    elif fault == "strided_q":
        q = cloud(1, 512, gen).to(cuda_device)[:, ::2]
    else:
        thr = thr[:, :128]
    launches = wk.best_windows_fused.launches
    with pytest.raises(ValueError):
        wk.best_windows_fused(q, s, thr, 128, 64, 1)
    assert wk.best_windows_fused.launches == launches
