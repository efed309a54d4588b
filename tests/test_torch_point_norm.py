"""The point branch's GroupNorm chain (ops/norm_kernel.py) on the CPU: the
plain version is the point blocks' former arithmetic bit for bit (the
group norm, then LeakyReLU(0.1), or the norm, the shortcut's add and the
LeakyReLU); the blocks take the plain version under autograd and with
``kernel='xla'``, try the kernels off the CPU otherwise, and count which
path each call took; the state dict keeps the reference's keys; every
site of the KITTI FPN fits the kernels' block plan, and
ops/norm_kernel.py's copy of that plan agrees with
csrc/point_norm_plan.cuh.  Seconds in all; the kernels themselves are
tested on the card (tests/test_torch_cuda_kernels.py)."""

import shutil
import subprocess

import pytest
import torch

from cofii2p_tpu_torch.models.kpconv import KPConvFPN, ResidualBlock, UnaryBlock
from cofii2p_tpu_torch.models.layers import GroupNormWrapper, norm_chain
from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops import norm_kernel as nk
from cofii2p_tpu_torch.utils.profiling import counter

GROUPS = 32
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def former_group_norm(x, weight, bias, g, eps=1e-5):
    """PointGroupNorm.forward as the point blocks ran it before the chain."""
    xg = x.float().reshape(*x.shape[:-1], g, x.shape[-1] // g)
    mean = xg.mean(dim=(-3, -1), keepdim=True)
    var = xg.var(dim=(-3, -1), keepdim=True, unbiased=False)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (out * weight + bias).to(x.dtype)


def former_leaky_relu(x, negative_slope=0.1):
    return torch.where(x >= 0, x, negative_slope * x)


def former_chain(x, weight, bias, g, chain, residual):
    out = former_group_norm(x, weight, bias, g)
    if chain == "norm":
        return out
    if chain == "relu":
        return former_leaky_relu(out)
    return former_leaky_relu(out + residual)


def features(shape, dtype, seed):
    """Features with a spread of per-channel offsets and scales, both signs."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, generator=g) * torch.linspace(0.5, 4.0, c) + torch.linspace(-3.0, 5.0, c)
    return x.to(dtype)


def bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("chain", ["norm", "relu", "residual"])
@pytest.mark.parametrize("cg", [1, 4, 16, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_chain_is_the_former_arithmetic(dtype, cg, chain):
    """point_group_norm_plain, and the group norm module through
    norm_chain, give the former GroupNorm -> LeakyReLU and GroupNorm ->
    add -> LeakyReLU bit for bit."""
    dt = DTYPES[dtype]
    c = GROUPS * cg
    x = features((2, 96, c), dt, cg)
    g = torch.Generator().manual_seed(100 + cg)
    weight, bias = torch.randn(c, generator=g), torch.randn(c, generator=g)
    residual = features((2, 96, c), dt, 200 + cg) if chain == "residual" else None
    want = former_chain(x, weight, bias, GROUPS, chain, residual)
    relu = chain != "norm"
    got = nk.point_group_norm_plain(x, weight, bias, GROUPS, relu=relu, residual=residual)
    norm = GroupNormWrapper(GROUPS, c)
    with torch.no_grad():
        norm.norm.weight.copy_(weight)
        norm.norm.bias.copy_(bias)
        via_module = norm_chain(norm, x, relu, residual)
    assert got.dtype == dt and via_module.dtype == dt
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(via_module), bits(want))


def conv_stub(c, seed):
    """A stand-in for a block's KPConv: a fixed linear map of its input."""
    w = torch.randn(c, c, generator=torch.Generator().manual_seed(seed)) / c**0.5

    def forward(x, *args, **kwargs):
        return (x.float() @ w).to(x.dtype)

    return forward


def residual_block(dtype, kernel="auto"):
    """A self block with unary1, unary_shortcut and a stubbed KPConv: 64 in,
    128 out, 32 mid (one channel a group), four group norms."""
    torch.manual_seed(0)
    block = ResidualBlock(64, 128, 15, 0.85, 0.4, group_norm=GROUPS, dtype=dtype, kernel=kernel)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if "norm" in name:
                p.copy_(torch.randn_like(p))
    block.KPConv.forward = conv_stub(32, 1)
    return block


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_residual_block_keeps_its_former_output(dtype):
    """The shortcut is computed before unary2 now, so that unary2's norm,
    the add and the LeakyReLU run as one chain: the block's output is its
    former composition's, bit for bit."""
    dt = DTYPES[dtype]
    block = residual_block(dt)
    s_feats = features((2, 80, 64), dt, 3)
    pts = torch.zeros(2, 80, 3)

    def gn(x, wrapper):
        return former_group_norm(x, wrapper.norm.weight, wrapper.norm.bias, GROUPS)

    def unary(x, mod, relu):
        out = gn(mod.mlp(x), mod.norm)
        return former_leaky_relu(out) if relu else out

    with torch.no_grad():
        got = block(s_feats, pts, pts)
        x = unary(s_feats, block.unary1, True)
        x = former_leaky_relu(gn(block.KPConv(x, pts, pts), block.norm_conv))
        x = unary(x, block.unary2, False)
        want = former_leaky_relu(x + unary(s_feats, block.unary_shortcut, False))
    assert got.dtype == want.dtype
    assert torch.equal(bits(got), bits(want))


def counts():
    return counter("cofii2p.point_norm.fused").value, counter("cofii2p.point_norm.plain").value


@pytest.mark.parametrize("case", ["cpu", "cpu_autograd", "xla"])
def test_the_blocks_take_the_plain_version_and_count_it(case):
    """On the CPU, under autograd and with kernel='xla' every group norm of
    a block runs its plain version: the plain counter gains one a call,
    the fused one nothing, and no wrapper launches."""
    block = residual_block(torch.float32, kernel="xla" if case == "xla" else "auto")
    s_feats = features((2, 40, 64), torch.float32, 5).requires_grad_(case == "cpu_autograd")
    pts = torch.zeros(2, 40, 3)
    nk.point_group_norm_fused.launches = 0
    fused, plain = counts()
    with torch.set_grad_enabled(case == "cpu_autograd"):
        out = block(s_feats, pts, pts)
    assert counts() == (fused, plain + 4)
    assert nk.point_group_norm_fused.launches == 0
    assert out.requires_grad == (case == "cpu_autograd")


@pytest.mark.parametrize("case", ["no_grad", "no_grad_misfit", "autograd", "params_autograd", "xla"])
def test_off_the_cpu_the_kernels_are_tried_unless_autograd_records(case):
    """Off the CPU (a meta tensor: no card here) the chain goes to the
    kernels' wrapper, which refuses a tensor it cannot launch on, unless
    autograd records through x or the parameters, or kernel='xla': then
    the plain version runs and says so.  A call the kernels do not fit
    (here a residual of another dtype) goes to the wrapper too: the plain
    version never stands in for the kernels off the CPU."""
    x = torch.empty(2, 64, 128, device="meta", requires_grad=case == "autograd")
    w = torch.empty(128, device="meta", requires_grad=case == "params_autograd")
    b = torch.empty(128, device="meta")
    residual = torch.empty(2, 64, 128, device="meta", dtype=torch.bfloat16) if case == "no_grad_misfit" else None
    assert (residual is None) == nk.fused_fits(x, GROUPS, residual)
    fused, plain = counts()
    kernel = "xla" if case == "xla" else "auto"
    with torch.set_grad_enabled(not case.startswith("no_grad")):
        if case.startswith("no_grad"):
            with pytest.raises(ValueError, match="CUDA tensor"):
                nk.point_group_norm(x, w, b, GROUPS, relu=True, residual=residual, kernel=kernel)
            assert counts() == (fused + 1, plain)
        else:
            out = nk.point_group_norm(x, w, b, GROUPS, relu=True, kernel=kernel)
            assert out.shape == x.shape and out.device.type == "meta"
            assert counts() == (fused, plain + 1)


def test_unary_block_without_norm_adds_the_residual_and_activates():
    """A UnaryBlock with no norm (the FPN's last decoder) keeps its plain
    Linear; given a residual it adds it and applies the LeakyReLU."""
    torch.manual_seed(0)
    mod = UnaryBlock(16, 32, norm=None)
    x, r = torch.randn(2, 10, 16), torch.randn(2, 10, 32)
    with torch.no_grad():
        assert torch.equal(mod(x), mod.mlp(x))
        assert torch.equal(mod(x, residual=r), former_leaky_relu(mod.mlp(x) + r))


def test_state_dict_keeps_the_reference_layout():
    """The FPN's state dict loads strictly into the benchmark's plain
    reference FPN (the reference's module layout) and back."""
    from benchmark.reference.models.kpconv import KPConvFPN as ReferenceFPN

    torch.manual_seed(0)
    port = KPConvFPN(init_dim=16, group_norm=8)
    ref = ReferenceFPN(init_dim=16, group_norm=8)
    ref.load_state_dict(port.state_dict(), strict=True)
    fresh = KPConvFPN(init_dim=16, group_norm=8)
    fresh.load_state_dict(ref.state_dict(), strict=True)
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in fresh.state_dict().items())


def test_every_fpn_site_fits_the_kernels():
    """The 47 group norms of the KITTI FPN (published widths, 32 groups)
    fit the kernels' plan in bf16 and in fp32."""
    with torch.device("meta"):
        fpn = KPConvFPN(init_dim=64, group_norm=GROUPS)
    widths = [m.norm.weight.shape[0] for m in fpn.modules() if isinstance(m, GroupNormWrapper)]
    assert len(widths) == 47
    for esz in (2, 4):
        assert all(nk.norm_plan(c, GROUPS, esz) is not None for c in widths), esz
    assert nk.norm_plan(2048, GROUPS, 4) == 2 and nk.norm_plan(2048, GROUPS, 2) == 1


PLAN_DUMP = r"""
#include <cstdio>
#include "point_norm_plan.cuh"
int main() {
  std::printf("const %d %d\n", point_norm::kThreads, point_norm::kMaxChunks);
  const int groups[] = {1, 2, 3, 4, 8, 16, 32, 64, 128};
  for (int esz = 2; esz <= 4; esz += 2)
    for (int g : groups)
      for (int c = 1; c <= 4608; ++c) {
        const point_norm::Plan p = point_norm::make_plan(c, g, esz);
        if (p.ok) std::printf("plan %d %d %d %d\n", c, g, esz, p.slices);
      }
  return 0;
}
"""


def test_plan_copy_matches_the_header(tmp_path):
    """ops/norm_kernel.py's norm_plan and constants are the header's:
    the host compiler evaluates make_plan over widths 1..4608, nine group
    counts and both element sizes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler evaluates the plan header"
    src, exe = tmp_path / "plan.cc", tmp_path / "plan"
    src.write_text(PLAN_DUMP)
    res = subprocess.run([cxx, "-std=c++17", "-I", cuda_lib.CSRC, "-o", str(exe), str(src)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.splitlines()
    assert out[0].split()[1:] == [str(v) for v in (nk.THREADS, nk.MAX_CHUNKS)]
    built = {tuple(int(v) for v in line.split()[1:4]): int(line.split()[4]) for line in out[1:]}
    mine = {(c, g, esz): nk.norm_plan(c, g, esz) for esz in (2, 4)
            for g in (1, 2, 3, 4, 8, 16, 32, 64, 128) for c in range(1, 4609)}
    assert {k: v for k, v in mine.items() if v is not None} == built
    assert len(built) > 100

