"""The port's CUDA kernels and autograd Functions against their plain
PyTorch versions, on the card.  Every test here is marked ``gpu`` and skips without a CUDA
device.  The file imports no JAX, so it also runs on a machine that has
only PyTorch (the repo's conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: fp32 KPConv rel <= 1e-3 (rms-floored, summation order
differs) with equal counts; bf16 KPConv rel <= 5e-2 against the fp32
plain version; maxpool bit-equal (a select); attention fp32 <= 1e-5 abs,
bf16 <= 2e-2 abs with the output in q's dtype, also at ragged shapes on
the tensor-core body, where each element also lies within bf16's rounding
(2^-8 relative) of the fp32 plain version on the same bf16 inputs plus
5e-4, with serving's normalised and with randn queries; the bf16 KPConv (tensor cores) at every width of the
KITTI FPN on static bands, windows and two membership segments.  Training kernels, fp32:
the aggregate (tensor cores, 3xTF32) rel <= 1e-3 with equal counts, also
on 2176-, 2304- and 3200-row bands and w256 windows, and in bf16 rel <=
5e-2 against the fp32 plain version; the transposed aggregate
rel <= 1e-4, tie counts bit-equal, the maxpool backward rel <= 1e-5, and
the autograd Functions' gradients against autograd of the plain versions
rel <= 1e-4 (KPConv) and 1e-5 (maxpool).  The k-NN (tau) kernels: tau and
the k-NN maxpool bit-equal (exact order statistics; a select), the tau
KPConvs (tensor cores, fp32 by 3xTF32) with equal active-row counts and
fp32 rel <= 1e-4, bf16 <= 5e-2, at every width of the `.t7` FPN and on
bands over 2048 and over 3072 rows.
The backward kernels of the dynamic windows (#10, #14) and of the k-NN
semantics (#11, #15) and the tie count's window and tau modes (#12): tie
counts bit-equal, #10/#11 rel <= 1e-4 (#11 on the tensor cores, also at
C = 512 on a 2304-row band, in bf16 rel <= 1e-3 against the plain
version's bf16 rounding points, the same bits on two launches), #14/#15
rel <= 1e-5, and the window scatter bit-equal to its plain version on the
kernel's own stack.
The fused residual band pass (#16): counts equal and shortcuts bit-equal
to the plain version and to the pair it fuses (#1, #3), the conv
bit-equal to #1's (the same kernel code at the same block size) and
within #1's tolerances of the plain version.
"""

import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.ops.attention_kernel import fused_attention, fused_attention_plain
from cofii2p_tpu_torch.ops.banded import _load_kernel_points, dynamic_band_starts, dynamic_knn_starts, kernel_reach
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    band_scatter_plain,
    banded_kpconv_aggregate_fused,
    banded_kpconv_aggregate_plain,
    banded_kpconv_aggregate_tau,
    banded_kpconv_aggregate_tau_plain,
    banded_kpconv_apply,
    banded_kpconv_fused,
    banded_kpconv_fused_plain,
    banded_kpconv_fused_tau,
    banded_kpconv_fused_tau_plain,
    banded_kpconv_tau_apply,
    banded_kpconv_transpose_dyn_fused,
    banded_kpconv_transpose_dyn_plain,
    banded_kpconv_transpose_fused,
    banded_kpconv_transpose_plain,
    banded_kpconv_transpose_tau_fused,
    banded_kpconv_transpose_tau_plain,
    transpose_dyn_with_stack,
)
from cofii2p_tpu_torch.ops.maxpool_kernel import (
    banded_maxpool_apply,
    banded_maxpool_backward_dyn_fused,
    banded_maxpool_backward_fused,
    banded_maxpool_backward_tau_fused,
    banded_maxpool_fused,
    banded_maxpool_plain,
    banded_maxpool_route_dyn_plain,
    banded_maxpool_route_plain,
    banded_maxpool_route_tau_plain,
    banded_maxpool_tau,
    banded_maxpool_tau_apply,
    banded_maxpool_tau_plain,
    banded_maxpool_tie_count_fused,
    banded_maxpool_tie_count_plain,
    route_dyn_with_stack,
)
from cofii2p_tpu_torch.ops.pyramid import morton_order
from cofii2p_tpu_torch.ops.residual_kernel import banded_residual_fused, banded_residual_fused_plain
from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_kernel, banded_knn_tau_plain
from cofii2p_tpu_torch.utils.convert import jittered_kernel_points

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


def bf16_excess(out, ref) -> float:
    """How far a bf16 output lies beyond bf16's rounding of an fp32 result:
    max(|out - ref| - 2^-8 |ref|), 2^-8 being bf16's unit roundoff."""
    ref = ref.double()
    return ((out.double() - ref).abs() - ref.abs() * 2.0**-8).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("queries", ["normalised", "randn"])
@pytest.mark.parametrize("b,l,s_len", [(2, 1, 1280), (2, 1000, 1100), (2, 1280, 40), (8, 1280, 1280)])
def test_attention_tensor_core_kernel_matches_plain(cuda_device, b, l, s_len, queries):
    """The bf16 tensor-core body at ragged shapes (one query, tails of L
    and S, S under one 64-key chunk) and at the serving shape, with
    serving's sequence-normalised queries (logits near 0, a near-uniform
    softmax) and with plain randn queries (logit std ~1): abs <= 2e-2
    against the fp32 plain version and each element within bf16's rounding
    of the fp32 plain version on the same bf16 inputs plus 5e-4, output
    bf16.  A kernel that dropped Q K^T, the 1/sqrt(D) or P V errs by more
    than 4e-3."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(b, l, 4, 32, generator=g).to(cuda_device)
    if queries == "normalised":
        q = q / q.norm(dim=1, keepdim=True)
    k, v = (torch.randn(b, s_len, 4, 32, generator=g).to(cuda_device) for _ in range(2))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref = fused_attention_plain(qb.float(), kb.float(), vb.float())
    out = fused_attention(qb, kb, vb)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == qb.shape
    assert (out.float() - fused_attention_plain(q, k, v)).abs().max().item() <= 2e-2
    assert bf16_excess(out, ref) <= 5e-4


@pytest.mark.gpu
def test_attention_refuses_unaligned_bf16_inputs(cuda_device):
    """The bf16 body reads k and v in 16-byte copies: a contiguous view that
    starts off a 16-byte boundary is refused, not faulted on."""
    base = torch.randn(1 + 64 * 4 * 32, device=cuda_device).bfloat16()
    q = base[1:].view(1, 64, 4, 32)
    ok = base[:-1].view(1, 64, 4, 32)
    assert q.is_contiguous() and q.data_ptr() % 16
    for args in ((q, ok, ok), (ok, q, ok), (ok, ok, q)):
        with pytest.raises(ValueError, match="16-byte"):
            fused_attention(*args)
    assert fused_attention(ok, ok, ok).dtype == torch.bfloat16


MMA_MODES = {"static": (1024, 2048, 256, False), "w192": (1024, 2048, 192, True),
             "two_segments": (512, 4096, 1024, False)}  # a 3072-row band


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MMA_MODES))
@pytest.mark.parametrize("cin,cout", [(4, 64), (32, 32), (64, 64), (128, 128), (256, 256), (512, 512),
                                      (32, 64), (512, 32), (64, 256)])
def test_kpconv_tensor_core_kernel_matches_plain(cuda_device, cin, cout, mode):
    """Kernel #1 in bf16 (csrc/kpconv_mma.cuh) at every (Cin, Cout) of the
    KITTI FPN and three pairs outside it, on static bands, w192 windows and
    a band of two membership segments: counts bit-equal to the plain
    version, rel <= 5e-2 against the fp32 plain version.  Cin = 4 gets fp32
    features, as encoder1_1 does in serving."""
    m, n, width, dynamic = MMA_MODES[mode]
    q, s = clouds(m, n, cuda_device, lone=4)
    g = torch.Generator().manual_seed(cin)
    f = torch.randn(2, n, cin, generator=g).to(cuda_device)
    w = (torch.randn(15, cin, cout, generator=g) / cin**0.5).to(cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1) if dynamic else None
    ref, ref_cnt = banded_kpconv_fused_plain(f, q, s, w, R, S, 15, 128, width, torch.float32, starts)
    fb = f if cin == 4 else f.bfloat16()
    out, cnt = banded_kpconv_fused(fb, q, s, w, R, S, 15, 128, width, torch.bfloat16, starts)
    torch.cuda.synchronize()
    assert torch.equal(cnt, ref_cnt)
    assert rel_err(out, ref) <= 5e-2


def tied_features(s, c, device, seed=0):
    """Features on support clouds whose rows 0, 2, 4, ... are copied onto
    the next row (points and features), so maxima tie."""
    g = torch.Generator().manual_seed(seed)
    s = s.clone()
    s[:, 1::2] = s[:, 0::2]
    f = torch.randn(s.shape[0], s.shape[1], c, generator=g).to(device)
    f[:, 1::2] = f[:, 0::2]
    return s, f


# the aggregate (#2) on the tensor cores: (m, n, C, band width, mode);
# static bands of 768 rows, of encoder4_2's 2176 and encoder5_1's 2304, and
# of 3200 (walked in two slices of kept membership bits), w256 windows,
# bf16 compute; the transpose (#9) beside it on the static bands
AGG_MODES = {"band768": (1024, 2048, 32, 256, "static"), "band768_c64": (2048, 2048, 64, 256, "static"),
             "band768_c512": (1024, 1024, 512, 256, "static"), "band2176": (2560, 2560, 256, 1024, "static"),
             "band2304": (1280, 2560, 256, 1024, "static"), "band3200": (3328, 3328, 32, 1536, "static"),
             "w256": (1024, 2048, 64, 256, "window"), "bf16": (2048, 2048, 64, 256, "bf16")}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(AGG_MODES))
def test_training_kpconv_kernels_match_plain(cuda_device, mode):
    """Kernel #2 (csrc/kpconv_tau_mma.cuh under radius membership) against
    the plain version: counts bit-equal, fp32 (3xTF32) rel <= 1e-3 on
    static bands of one and of two membership slices and on windows; bf16
    compute on bf16 features rel <= 5e-2 against the fp32 plain version,
    the repo's bf16 KPConv gate (its influence, fp32 in the kernel and
    float64 in the plain version, rounds to another bf16 value where the
    two straddle a rounding boundary, so no fp32-sized bound holds against
    the plain version's bf16 either); #9 beside it on static bands, rel <=
    1e-4."""
    m, n, c, bw, kind = AGG_MODES[mode]
    q, s = clouds(m, n, cuda_device)
    if mode == "band2304":
        q = s[:, ::2].contiguous()  # a Morton subset, as the pyramid's next level
    g = torch.Generator().manual_seed(1)
    f = torch.randn(2, n, c, generator=g).to(cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, bw, "best", 1) if kind == "window" else None
    dtype, tol = (torch.bfloat16, 5e-2) if kind == "bf16" else (torch.float32, 1e-3)
    ref, ref_cnt = banded_kpconv_aggregate_plain(f, q, s, R, S, 15, 128, bw, torch.float32, starts)
    out, cnt = banded_kpconv_aggregate_fused(f.to(dtype), q, s, R, S, 15, 128, bw, dtype, starts)
    torch.cuda.synchronize()
    assert torch.equal(cnt, ref_cnt)
    assert rel_err(out, ref) <= tol
    if kind == "static":
        gw = torch.randn(2, m, 15, c, generator=g).to(cuda_device)
        got = banded_kpconv_transpose_fused(gw, q, s, R, S, 15, 128, bw)
        assert rel_err(got, banded_kpconv_transpose_plain(gw, q, s, R, S, 15, 128, bw)) <= 1e-4


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


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,width,windowed", [
    (1024, 2048, 128, 256, False), (1024, 2048, 16, 256, True), (2048, 2048, 128, 2304, False),
    (128, 128, 128, 256, False),
])
def test_knn_tau_kernel_bitequal_to_plain(cuda_device, m, n, k, width, windowed):
    """Static bands, windows, a band of the whole level with k = band, and
    duplicated points whose k-th and (k+1)-th distances tie."""
    q, s = clouds(m, n, cuda_device)
    s, _ = tied_features(s, 1, cuda_device)
    if m == n:
        q = s
    starts = None
    if windowed:
        starts = dynamic_knn_starts(q, s, banded_knn_tau_plain(q, s, k, 128, 2 * width), 128, width, 1)
    ref = banded_knn_tau_plain(q, s, k, 128, width, starts)
    got = banded_knn_tau_kernel(q, s, k, 128, width, starts)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
def test_maxpool_tau_kernel_bitequal_to_plain(cuda_device):
    q, s = clouds(1024, 2048, cuda_device, lone=8)
    s, f32 = tied_features(s, 256, cuda_device)
    tau = banded_knn_tau_plain(q, s, 16, 128, 256)
    for dtype in (torch.float32, torch.bfloat16):
        f = f32.to(dtype)
        out = banded_maxpool_tau(f, q, s, tau, 128, 256)
        assert out.dtype == dtype
        assert torch.equal(out, banded_maxpool_tau_plain(f, q, s, tau, 128, 256))


# (M, N, band width, k): a 768-row band; encoder4_2's self band of 128 +
# 2 * 1024 = 2176 rows and encoder5_1's 256 + 2048 = 2304 (lvl4 <- lvl3),
# both over 2048 rows, as the `.t7` FPN has them; and a band of 128 + 2 *
# 1536 = 3200 rows, over the 3072 a block keeps membership bits of at once
TAU_MODES = {"band768": (1024, 2048, 256, 32), "band2176": (2560, 2560, 1024, 128),
             "band2304": (1280, 2560, 1024, 128), "band3200": (3328, 3328, 1536, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(TAU_MODES))
@pytest.mark.parametrize("cin,cout", [(4, 64), (32, 32), (64, 64), (128, 128), (256, 256), (512, 512)])
def test_kpconv_tau_kernels_match_plain(cuda_device, cin, cout, mode):
    """Kernels #7 and #6 (csrc/kpconv_tau_mma.cuh) at every width of the
    `.t7` FPN, on a band of one membership segment, on two of over 2048
    rows, and on one walked in two slices of kept membership bits, with
    per-layer kernel points and duplicated support points, so that k-th and
    (k+1)-th distances tie at tau; features of both signs, so the
    active-row count differs from the in-tau count.  Counts equal to the
    plain version's, fp32 (3xTF32) rel <= 1e-4, bf16 rel <= 5e-2 against
    the fp32 plain version, on bf16 features and, at Cin = 4, also on fp32
    features, as encoder1_1 takes them."""
    m, n, width, k = TAU_MODES[mode]
    q, s = clouds(m, n, cuda_device, lone=4)
    s, _ = tied_features(s, 1, cuda_device)
    if m == n:
        q = s
    elif mode == "band2304":
        q = s[:, ::2].contiguous()  # a Morton subset, as the pyramid's next level
    g = torch.Generator().manual_seed(5)
    f = torch.randn(2, n, cin, generator=g).to(cuda_device)
    f[:, 1::2] = f[:, 0::2]
    w = (torch.randn(15, cin, cout, generator=g) / cin**0.5).to(cuda_device)
    kp = jittered_kernel_points(torch.tensor(_load_kernel_points(R, 15), dtype=torch.float32), g).to(cuda_device)
    tau = banded_knn_tau_plain(q, s, k, 128, width)
    ref, _ = banded_kpconv_fused_tau_plain(f, q, s, w, tau, kp, R, S, 15, 128, width)
    ref_w, _ = banded_kpconv_aggregate_tau_plain(f, q, s, tau, kp, R, S, 15, 128, width)
    runs = [(f, torch.float32, 1e-4), (f.bfloat16(), torch.bfloat16, 5e-2)]
    if cin == 4:
        runs.append((f, torch.bfloat16, 5e-2))
    for fd, dtype, tol in runs:
        # the active rows are those of the features as given, rounded or not
        want_cnt = banded_kpconv_fused_tau_plain(fd, q, s, w, tau, kp, R, S, 15, 128, width, dtype)[1]
        out, cnt = banded_kpconv_fused_tau(fd, q, s, w, tau, kp, R, S, 15, 128, width, dtype)
        got_w, cnt_w = banded_kpconv_aggregate_tau(fd, q, s, tau, kp, R, S, 15, 128, width, dtype)
        torch.cuda.synchronize()
        assert torch.equal(cnt, want_cnt) and torch.equal(cnt_w, want_cnt)
        assert rel_err(out, ref) <= tol
        assert rel_err(got_w, ref_w) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,c", [(1024, 2048, 64), (2048, 2048, 256), (512, 1024, 512)])
def test_window_transpose_kernel_matches_plain(cuda_device, m, n, c):
    """Kernel #10 on w256 windows: rel <= 1e-4 against the plain version,
    and the scatter bit-equal to its plain version on the kernel's stack."""
    q, s = clouds(m, n, cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, 256, "best", 1)
    gw = torch.randn(2, m, 15, c, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    got = banded_kpconv_transpose_dyn_fused(gw, q, s, starts, R, S, 15, 128, 256)
    assert rel_err(got, banded_kpconv_transpose_dyn_plain(gw, q, s, starts, R, S, 15, 128, 256)) <= 1e-4
    out, stack = transpose_dyn_with_stack(gw, q, s, starts, R, S, 15, 128, 256)
    assert torch.equal(out, band_scatter_plain(stack, starts, n)) and torch.equal(out, got)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [128, 1024])
def test_window_maxpool_backward_kernels_match_plain(cuda_device, c):
    """The tie count in window mode bit-equal, kernel #14 rel <= 1e-5, its
    scatter bit-equal on its own stack; duplicated points tie."""
    q, s = clouds(512, 2048, cuda_device)
    s, f = tied_features(s, c, cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, 256, "best", 1)
    out = banded_maxpool_fused(f, q, s, R_ACT, 128, 256, starts)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, 256, starts)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, R_ACT, 128, 256, starts))
    assert (cnt > 1).any()
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(cuda_device) / cnt.clamp(min=1)
    got = banded_maxpool_backward_dyn_fused(gs, f, q, s, out, starts, R_ACT, 128, 256)
    assert rel_err(got, banded_maxpool_route_dyn_plain(gs, f, q, s, out, starts, R_ACT, 128, 256)) <= 1e-5
    g2, stack = route_dyn_with_stack(gs, f, q, s, out, starts, R_ACT, 128, 256)
    assert torch.equal(g2, band_scatter_plain(stack, starts, s.shape[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,c,bw,dtype", [(1024, 2048, 64, 256, "fp32"), (2048, 2048, 256, 1024, "fp32"),
                                            (1024, 1024, 512, 1024, "fp32"), (1280, 2560, 512, 1024, "fp32"),
                                            (2048, 2048, 64, 256, "bf16")])
def test_tau_transpose_kernel_matches_plain(cuda_device, m, n, c, bw, dtype):
    """Kernel #11 (csrc/kpconv_transpose_mma.cuh) with per-layer kernel
    points on duplicated points: fp32 (3xTF32) rel <= 1e-4, also at C = 512
    on encoder5_1's 2304-row band (two channel blocks); bf16 against the
    plain version's bf16 rounding points, rel <= 1e-3; the same bits on two
    launches."""
    q, s = clouds(m, n, cuda_device)
    s, _ = tied_features(s, 1, cuda_device)
    if m == n:
        q = s
    elif (m, n) == (1280, 2560):
        q = s[:, ::2].contiguous()  # a Morton subset, as the pyramid's next level: band 2304
    g = torch.Generator().manual_seed(8)
    kp = jittered_kernel_points(torch.tensor(_load_kernel_points(R, 15), dtype=torch.float32), g).to(cuda_device)
    tau = banded_knn_tau_plain(q, s, 32, 128, bw)
    gw = torch.randn(2, m, 15, c, generator=g).to(cuda_device)
    cd, tol = (torch.float32, 1e-4) if dtype == "fp32" else (torch.bfloat16, 1e-3)
    got = banded_kpconv_transpose_tau_fused(gw, q, s, tau, kp, R, S, 15, 128, bw, cd)
    again = banded_kpconv_transpose_tau_fused(gw, q, s, tau, kp, R, S, 15, 128, bw, cd)
    torch.cuda.synchronize()
    assert rel_err(got, banded_kpconv_transpose_tau_plain(gw, q, s, tau, kp, R, S, 15, 128, bw, cd)) <= tol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [128, 1024])
def test_tau_maxpool_backward_kernels_match_plain(cuda_device, c):
    """The tie count in tau mode bit-equal, kernel #15 rel <= 1e-5."""
    q, s = clouds(512, 2048, cuda_device)
    s, f = tied_features(s, c, cuda_device)
    tau = banded_knn_tau_plain(q, s, 16, 128, 256)
    out = banded_maxpool_tau(f, q, s, tau, 128, 256)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, 0.0, 128, 256, tau=tau)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, 0.0, 128, 256, tau=tau))
    assert (cnt > 1).any()
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)).to(cuda_device) / cnt.clamp(min=1)
    got = banded_maxpool_backward_tau_fused(gs, f, q, s, out, tau, 128, 256)
    assert rel_err(got, banded_maxpool_route_tau_plain(gs, f, q, s, out, tau, 128, 256)) <= 1e-5


@pytest.mark.gpu
def test_window_and_tau_functions_match_plain_autograd(cuda_device):
    """BandedKPConvFn and BandedMaxpoolFn on w256 windows, BandedKPConvTauFn
    and BandedMaxpoolTauFn with per-layer kernel points, through the kernels
    against autograd of the plain versions: rel <= 1e-4 (KPConv) and 1e-5
    (maxpool)."""
    q, s = clouds(1024, 2048, cuda_device)
    s, f0 = tied_features(s, 64, cuda_device)
    w0 = (torch.randn(15, 64, 64, generator=torch.Generator().manual_seed(10)) / 8).to(cuda_device)
    g = torch.randn(2, 1024, 64, generator=torch.Generator().manual_seed(11)).to(cuda_device)
    kp = jittered_kernel_points(torch.tensor(_load_kernel_points(R, 15), dtype=torch.float32),
                                torch.Generator().manual_seed(12)).to(cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, 256, "best", 1)
    tau = banded_knn_tau_plain(q, s, 32, 128, 256)
    cases = {
        "window": ((banded_kpconv_apply, banded_maxpool_apply), (banded_kpconv_fused_plain, banded_maxpool_plain),
                   lambda conv, f, w: conv(f, q, s, w, R, S, 15, 128, 256, starts=starts),
                   lambda pool, f: pool(f, q, s, R_ACT, 128, 256, starts)),
        "tau": ((banded_kpconv_tau_apply, banded_maxpool_tau_apply),
                (banded_kpconv_fused_tau_plain, banded_maxpool_tau_plain),
                lambda conv, f, w: conv(f, q, s, w, tau, kp, R, S, 15, 128, 256),
                lambda pool, f: pool(f, q, s, tau, 128, 256)),
    }
    for name, (kern, plain, call_conv, call_pool) in cases.items():
        grads = []
        for conv, pool in (kern, plain):
            f, w = f0.clone().requires_grad_(), w0.clone().requires_grad_()
            out, cnt = call_conv(conv, f, w)
            (out / cnt[..., None]).backward(g)
            fp = f0.clone().requires_grad_()
            call_pool(pool, fp).backward(g)
            grads.append((f.grad, w.grad, fp.grad))
        torch.cuda.synchronize()
        assert rel_err(grads[0][0], grads[1][0]) <= 1e-4, name
        assert rel_err(grads[0][1], grads[1][1]) <= 1e-4, name
        assert rel_err(grads[0][2], grads[1][2]) <= 1e-5, name


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,cin,cmid,width,dynamic", [
    (1024, 2048, 128, 32, 256, False),  # encoder2_1's widths, static band of 768 rows
    (1024, 2048, 1024, 256, 192, True),  # encoder5_1's widths on w192 windows
    (512, 4096, 256, 64, 1024, False),  # a 3072-row band: two membership segments
    (1024, 2048, 512, 128, 192, True),  # encoder4_1's widths on w192 windows
])
def test_residual_fused_kernel_matches_plain_and_the_pair(cuda_device, m, n, cin, cmid, width, dynamic):
    q, s = clouds(m, n, cuda_device, lone=8)
    g = torch.Generator().manual_seed(0)
    fm32 = torch.randn(2, n, cin, generator=g).to(cuda_device)
    fa32 = torch.randn(2, n, cmid, generator=g).to(cuda_device)
    w = (torch.randn(15, cmid, cmid, generator=g) / cmid**0.5).to(cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1) if dynamic else None
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        fm, fa = fm32.to(dtype), fa32.to(dtype)
        args = (fm, fa, w, q, s, R, S, 15, 128, width, dtype, starts)
        out, cnt, mp = banded_residual_fused(*args)
        ref, ref_cnt, ref_mp = banded_residual_fused_plain(*args)
        conv, conv_cnt = banded_kpconv_fused(fa, q, s, w, R, S, 15, 128, width, dtype, starts)
        pooled = banded_maxpool_fused(fm, q, s, R_ACT, 128, width, starts)
        torch.cuda.synchronize()
        assert torch.equal(cnt, ref_cnt) and torch.equal(cnt, conv_cnt)
        assert mp.dtype == dtype and torch.equal(mp, ref_mp) and torch.equal(mp, pooled)
        assert torch.equal(out, conv)
        assert rel_err(out, ref) <= tol
    assert (mp == 0).all(-1).any()  # the lone queries' empty neighbourhoods
