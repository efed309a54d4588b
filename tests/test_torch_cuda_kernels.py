"""The port's CUDA kernels and autograd Functions against their plain
PyTorch versions, on the card.  Every test here is marked ``gpu`` and skips without a CUDA
device.  The file imports no JAX, so it also runs on a machine that has
only PyTorch (the repo's conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: fp32 KPConv rel <= 1e-3 (rms-floored, summation order
differs) with equal counts; bf16 KPConv rel <= 5e-2 against the fp32
plain version; maxpool bit-equal (a select); attention fp32 <= 1e-5 abs,
bf16 <= 2e-2 abs with the output in q's dtype.  Training kernels, fp32:
the aggregate rel <= 1e-3 with equal counts, the transposed aggregate
rel <= 1e-4, tie counts bit-equal, the maxpool backward rel <= 1e-5, and
the autograd Functions' gradients against autograd of the plain versions
rel <= 1e-4 (KPConv) and 1e-5 (maxpool).
"""

import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.ops.attention_kernel import fused_attention, fused_attention_plain
from cofii2p_tpu_torch.ops.banded import dynamic_band_starts, kernel_reach
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    banded_kpconv_aggregate_fused,
    banded_kpconv_aggregate_plain,
    banded_kpconv_apply,
    banded_kpconv_fused,
    banded_kpconv_fused_plain,
    banded_kpconv_transpose_fused,
    banded_kpconv_transpose_plain,
)
from cofii2p_tpu_torch.ops.maxpool_kernel import (
    banded_maxpool_apply,
    banded_maxpool_backward_fused,
    banded_maxpool_fused,
    banded_maxpool_plain,
    banded_maxpool_route_plain,
    banded_maxpool_tie_count_fused,
    banded_maxpool_tie_count_plain,
)
from cofii2p_tpu_torch.ops.pyramid import morton_order

R, S = 1.7, 0.8  # the level-2 radius and sigma of the KITTI FPN
R_ACT = kernel_reach(R, S)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def rel_err(a, ref) -> float:
    a, ref = a.double(), ref.double()
    rms = ref.pow(2).mean().sqrt().item() + 1e-30
    return ((a - ref).abs() / ref.abs().clamp(min=rms)).max().item()


def clouds(m, n, device, seed=0, lone=0):
    """Morton-ordered ground-plane clouds (B=2); the queries are a subset of
    the support plus ``lone`` far points whose neighbourhoods are empty."""
    rng = np.random.default_rng(seed)

    def ordered(x):
        return x[morton_order(torch.as_tensor(x), ordering="xz").numpy()]

    far = (500.0 + 40.0 * np.arange(lone, dtype=np.float32))[:, None].repeat(3, 1)
    s_pts, q_pts = [], []
    for _ in range(2):
        s = ordered(rng.uniform([-12, -2, 0], [12, 2, 24], (n, 3)).astype(np.float32))
        s_pts.append(s)
        q_pts.append(ordered(np.concatenate([s[rng.choice(n, m - lone, replace=False)], far])))
    return (torch.as_tensor(np.stack(x), device=device) for x in (q_pts, s_pts))


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,dynamic", [(64, 64, False), (64, 64, True), (4, 64, False), (512, 512, False)])
def test_kpconv_kernel_matches_plain(cuda_device, cin, cout, dynamic):
    q, s = clouds(1024, 2048, cuda_device)
    g = torch.Generator().manual_seed(0)
    f = torch.randn(2, 2048, cin, generator=g).to(cuda_device)
    w = (torch.randn(15, cin, cout, generator=g) / cin**0.5).to(cuda_device)
    width, starts = 256, None
    if dynamic:
        width = 192
        starts = dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1)
    ref, ref_cnt = banded_kpconv_fused_plain(f, q, s, w, R, S, 15, 128, width, torch.float32, starts)
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        out, cnt = banded_kpconv_fused(f.to(dtype), q, s, w, R, S, 15, 128, width, dtype, starts)
        torch.cuda.synchronize()
        assert torch.equal(cnt, ref_cnt)
        assert rel_err(out, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dynamic", [False, True])
def test_maxpool_kernel_bitequal_to_plain(cuda_device, dynamic):
    q, s = clouds(1024, 2048, cuda_device, lone=8)
    width, starts = 256, None
    if dynamic:
        width = 192
        starts = dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1)
    f32 = torch.randn(2, 2048, 256, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        f = f32.to(dtype)
        out = banded_maxpool_fused(f, q, s, R_ACT, 128, width, starts)
        ref = banded_maxpool_plain(f, q, s, R_ACT, 128, width, starts)
        assert out.dtype == dtype
        assert torch.equal(out, ref)
        assert (out == 0).all(-1).any()  # the lone queries' empty neighbourhoods


@pytest.mark.gpu
def test_attention_kernel_matches_plain(cuda_device):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 1280, 4, 32, generator=g).to(cuda_device) for _ in range(3))
    q = q / q.norm(dim=1, keepdim=True)  # the sequence-axis normalised query
    ref = fused_attention_plain(q, k, v)
    assert (fused_attention(q, k, v) - ref).abs().max().item() <= 1e-5
    out = fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() <= 2e-2


def tied_features(s, c, device, seed=0):
    """Features on support clouds whose rows 0, 2, 4, ... are copied onto
    the next row (points and features), so maxima tie."""
    g = torch.Generator().manual_seed(seed)
    s = s.clone()
    s[:, 1::2] = s[:, 0::2]
    f = torch.randn(s.shape[0], s.shape[1], c, generator=g).to(device)
    f[:, 1::2] = f[:, 0::2]
    return s, f


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,c", [(1024, 2048, 32), (2048, 2048, 64), (1024, 1024, 512)])
def test_training_kpconv_kernels_match_plain(cuda_device, m, n, c):
    q, s = clouds(m, n, cuda_device)
    g = torch.Generator().manual_seed(1)
    f = torch.randn(2, n, c, generator=g).to(cuda_device)
    ref, ref_cnt = banded_kpconv_aggregate_plain(f, q, s, R, S, 15, 128, 256)
    out, cnt = banded_kpconv_aggregate_fused(f, q, s, R, S, 15, 128, 256)
    torch.cuda.synchronize()
    assert torch.equal(cnt, ref_cnt)
    assert rel_err(out, ref) <= 1e-3
    gw = torch.randn(2, m, 15, c, generator=g).to(cuda_device)
    got = banded_kpconv_transpose_fused(gw, q, s, R, S, 15, 128, 256)
    assert rel_err(got, banded_kpconv_transpose_plain(gw, q, s, R, S, 15, 128, 256)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("c", [128, 1024])
def test_maxpool_backward_kernels_match_plain(cuda_device, c):
    q, s = clouds(512, 2048, cuda_device)
    s, f = tied_features(s, c, cuda_device)
    out = banded_maxpool_fused(f, q, s, R_ACT, 128, 256)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, 256)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, R_ACT, 128, 256))
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(cuda_device) / cnt.clamp(min=1)
    got = banded_maxpool_backward_fused(gs, f, q, s, out, R_ACT, 128, 256)
    assert rel_err(got, banded_maxpool_route_plain(gs, f, q, s, out, R_ACT, 128, 256)) <= 1e-5


@pytest.mark.gpu
def test_autograd_functions_match_plain_autograd(cuda_device):
    """BandedKPConvFn and BandedMaxpoolFn through the kernels against
    autograd of the plain versions, with tied maxima in the pooled cloud."""
    q, s = clouds(1024, 2048, cuda_device)
    s, f0 = tied_features(s, 64, cuda_device)
    w0 = (torch.randn(15, 64, 64, generator=torch.Generator().manual_seed(3)) / 8).to(cuda_device)
    g = torch.randn(2, 1024, 64, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    grads = []
    for conv, pool in ((banded_kpconv_apply, banded_maxpool_apply), (banded_kpconv_fused_plain, banded_maxpool_plain)):
        f, w = f0.clone().requires_grad_(), w0.clone().requires_grad_()
        out, cnt = conv(f, q, s, w, R, S, 15, 128, 256)
        (out / cnt[..., None]).backward(g)
        fp = f0.clone().requires_grad_()
        pool(fp, q, s, R_ACT, 128, 256).backward(g)
        grads.append((f.grad, w.grad, fp.grad))
    torch.cuda.synchronize()
    assert rel_err(grads[0][0], grads[1][0]) <= 1e-4
    assert rel_err(grads[0][1], grads[1][1]) <= 1e-4
    assert rel_err(grads[0][2], grads[1][2]) <= 1e-5
