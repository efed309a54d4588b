"""The arithmetic of EPnP-RANSAC's CUDA kernels (csrc/ransac_pnp.cuh) on
the CPU: tests/ransac_pnp_host.cc builds the same header with the host
compiler behind the kernels' two C entry points, and
pose/ransac.py::run_kernels drives it through the refinement's phases and
the plain version's own sums, as on the card.  Against the plain version
on the CPU: the same samples, and, since the CPU's matrix products sum in
other orders than cuBLAS (whose orders the card's run takes,
dot_orders), the hypothesis counts on nearly every hypothesis, the same
inlier counts, and poses within 1e-4 on scenes of known pose.  Besides:
the kept summation orders serve only the kernels' own sources and sites,
and ieee_fp32_products restores the caller's TF32 setting.  The card's
bit-for-bit checks are in tests/test_torch_cuda_kernels.py."""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.pose import ransac as rs
from torch_kernel_inputs import ransac_degenerate, ransac_scene

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ransac_host") / "ransac_host.so")
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernels' arithmetic for the CPU"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", cuda_lib.CSRC, "-o", out,
                    os.path.join(HERE, "ransac_pnp_host.cc")], check=True)
    lib = ctypes.CDLL(out)
    for name in ("ransac_hyp_launch", "ransac_refine_launch"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


CHAIN = (tuple([rs.CHAIN] * len(rs.SITES)),) * 2


@pytest.mark.parametrize("kind, b, h, n", [("scene", 2, 32, 200), ("scene", 1, 48, 77), ("degenerate", 3, 32, 40)])
def test_host_build_of_the_kernels_matches_the_plain_version(host_lib, kind, b, h, n):
    gen = torch.Generator().manual_seed(b * 1000 + n)
    obj, uv, K, mask = (ransac_scene if kind == "scene" else ransac_degenerate)(b, n, gen)
    gumbel = rs.gumbel_noise((b, h, n), gen, "cpu")
    got, hyp = rs.run_kernels(host_lib, None, gumbel, obj, uv, K, mask, 8.0, 2, CHAIN)
    want_hyp = rs.ransac_hypotheses_plain(gumbel, obj, uv, K, mask)
    want = rs.ransac_pnp_plain(gumbel, obj, uv, K, mask)
    assert torch.equal(hyp.samples.long(), want_hyp.samples)
    assert torch.equal(torch.isnan(hyp.R), torch.isnan(want_hyp.R))
    assert (hyp.counts.long() == want_hyp.counts).float().mean() >= 0.9
    assert torch.equal(got.num_inliers, want.num_inliers)
    assert torch.equal(got.success, want.success)
    # (the collinear frame's Gauss-Newton system overflows: whether its pose
    # ends NaN or inf turns on rounding, which the CPU's products do not share)
    if kind == "scene":
        assert torch.equal(torch.isnan(got.R), torch.isnan(want.R))
        assert torch.equal(got.inlier_mask, want.inlier_mask)
        assert (got.R - want.R).abs().max() <= 1e-4
        assert ((got.t - want.t).abs() / want.t.abs().amax(-1, keepdim=True).clamp(min=1)).max() <= 1e-4


def test_refinement_rounds_and_steps_follow_the_arguments(host_lib):
    """refine_iters = 0 returns the best hypothesis's pose as it is; the
    inlier threshold reaches every count."""
    gen = torch.Generator().manual_seed(5)
    obj, uv, K, mask = ransac_scene(2, 120, gen)
    gumbel = rs.gumbel_noise((2, 16, 120), gen, "cpu")
    got, hyp = rs.run_kernels(host_lib, None, gumbel, obj, uv, K, mask, 8.0, 0, CHAIN)
    best = hyp.counts.argmax(-1)
    assert torch.equal(got.R, hyp.R[torch.arange(2), best])
    tight, _ = rs.run_kernels(host_lib, None, gumbel, obj, uv, K, mask, 0.5, 2, CHAIN)
    assert (tight.num_inliers < got.num_inliers).all()


def test_kept_orders_serve_only_the_same_sites_and_sources(tmp_path, monkeypatch):
    """The orders file is named after the kernel library (a hash of the
    kernels' sources), the key holds the sites, and an entry that does not
    hold an order for every site is found anew, never read."""
    import json

    assert rs._orders_file() == cuda_lib.library_path()[:-len(".so")] + ".orders.json"
    path = str(tmp_path / "orders.json")
    found = []

    def find(b, h, n, device):
        found.append((b, h, n))
        return [[rs.CHAIN] * len(rs.SITES), [rs.SEQ] * len(rs.SITES)]

    monkeypatch.setattr(rs, "_orders_file", lambda: path)
    monkeypatch.setattr(rs, "_find_orders", find)
    monkeypatch.setattr(rs, "_orders_cache", {})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")
    key = rs._orders_key(8, 512, 1280, "cuda")
    with open(path, "w") as fh:
        json.dump({key: [[rs.CHAIN] * (len(rs.SITES) - 1)] * 2}, fh)
    assert rs.dot_orders(8, 512, 1280, "cuda")[1] == (rs.SEQ,) * len(rs.SITES)
    assert found == [(8, 512, 1280)]
    with open(path) as fh:
        assert rs._valid_orders(json.load(fh)[key])
    monkeypatch.setattr(rs, "_orders_cache", {})
    rs.dot_orders(8, 512, 1280, "cuda")  # kept: read, not found again
    assert found == [(8, 512, 1280)]
    monkeypatch.setattr(rs, "SITES", rs.SITES[:-1])
    assert rs._orders_key(8, 512, 1280, "cuda") != key


TF32_SCRIPT = """
import json, torch
from cofii2p_tpu_torch.pose.ransac import ieee_fp32_products
m = torch.backends.cuda.matmul
out = []
for set_tf32, read in ((lambda: torch.set_float32_matmul_precision("high"), torch.get_float32_matmul_precision),
                       (lambda: setattr(m, "allow_tf32", True), lambda: m.allow_tf32),
                       (lambda: setattr(m, "fp32_precision", "tf32"), lambda: m.fp32_precision)):
    set_tf32()
    before = read()
    with ieee_fp32_products():
        inside = m.fp32_precision
    out.append([before, inside, read()])
    if len(out) < 3:
        torch.set_float32_matmul_precision("highest")
print(json.dumps(out))
"""


def test_ieee_fp32_products_turns_tf32_off_and_restores_the_callers_setting():
    """Under each API a caller may turn TF32 on by (the per-backend one
    last: after it the legacy reads raise), IEEE inside, the caller's
    setting after."""
    import json
    import sys

    res = subprocess.run([sys.executable, "-c", TF32_SCRIPT], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(HERE))
    assert json.loads(res.stdout) == [["high", "ieee", "high"], [True, "ieee", True], ["tf32", "ieee", "tf32"]]
