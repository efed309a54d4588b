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
counts bit-equal, #9/#10/#11 rel <= 1e-4 (all three on the tensor cores,
the same bits on two launches; #9 and #11 also at C = 512 on a 2304-row
band, #10 at C = 512 and on windows over 2048 rows, #11 in bf16 rel <=
1e-3 against the plain version's bf16 rounding points), #14/#15
rel <= 1e-5, and the window scatter bit-equal to its plain version on the
kernel's own stack.  The radius routings #13 and #14 (the routing
kernel's radius policy and window mode): rel <= 1e-5 and the same bits on
two launches, #13 also in bf16, at an N that 64 does not divide and on a
2304-row band, both on constant features (every member ties, at four
reaches), #14 on windows placed at row 0, an odd row and N - band.
The fused residual band pass (#16): counts equal and shortcuts bit-equal
to the plain version and to the pair it fuses (#1, #3), the conv
bit-equal to #1's (the same kernel code at the same block size) and
within #1's tolerances of the plain version, in fp32 also with tied
maxima.  #1 and #4 in fp32 (3xTF32 on the tensor cores): #1 at every
width of the FPN on static bands, windows and a 3200-row band, #4 at
ragged shapes with both query kinds, each the same bits on two launches.
EPnP-RANSAC (csrc/ransac_pnp.cu) against ransac_pnp_plain on the card at
serving sizes (B = 8 and 1, 512 hypotheses, 1280 correspondences) and at
32 hypotheses over 1000, on scenes of known pose, junk correspondences
and degenerate sets: the six sample indices bit-equal, hypothesis counts
equal on at least 99.9% (the share printed), inlier counts and success
flags equal on every frame, R and t within 1e-4 where finite and NaN
exactly where the plain version's are, the same bits on two launches;
with TF32 on, the same bits as with it off, and the setting kept.
"""

import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.ops.attention_kernel import fused_attention, fused_attention_plain
from cofii2p_tpu_torch.ops.banded import (
    _load_kernel_points,
    band_plan,
    banded_pair_count,
    dynamic_band_starts,
    dynamic_knn_starts,
    kernel_reach,
)
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
from cofii2p_tpu_torch.ops.tau_kernel import MAX_BAND, banded_knn_tau_kernel, banded_knn_tau_plain
from cofii2p_tpu_torch.pose.ransac import (gumbel_noise, ransac_hypotheses_plain, ransac_pnp, ransac_pnp_kernel,
                                         ransac_pnp_plain)
from cofii2p_tpu_torch.utils.convert import jittered_kernel_points
# by its bare name, as pytest puts tests/ on the path: on the card another
# installed package may be named ``tests``
from torch_kernel_inputs import (ENC1_1_BW, ENC1_1_R, ENC1_1_S, ENC1_1_SEEDS, enc1_1_tau_inputs, ransac_degenerate,
                                 ransac_junk, ransac_scene)

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


# the channel widths of the four strided shortcuts (encoder2_1 .. encoder5_1)
POOL_WIDTHS = [128, 256, 512, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("c", POOL_WIDTHS)
@pytest.mark.parametrize("dynamic", [False, True])
def test_maxpool_kernel_bitequal_to_plain(cuda_device, dynamic, c):
    q, s = clouds(1024, 2048, cuda_device, lone=8)
    width, starts = 256, None
    if dynamic:
        width = 192
        starts = dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1)
    f32 = torch.randn(2, 2048, c, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        f = f32.to(dtype)
        out = banded_maxpool_fused(f, q, s, R_ACT, 128, width, starts)
        ref = banded_maxpool_plain(f, q, s, R_ACT, 128, width, starts)
        assert out.dtype == dtype
        assert torch.equal(out, ref)
        assert (out == 0).all(-1).any()  # the lone queries' empty neighbourhoods
        assert torch.equal(out, banded_maxpool_fused(f, q, s, R_ACT, 128, width, starts))  # the same bits again


# the forward band max (csrc/maxpool_fwd.cu) on tied maxima: (M, N, band
# width, windows); "band3456": 256 + 2 * 1600 rows, over the 3072 a block
# keeps membership bits of at once, so it walks two segments; "tile96": a
# 96-query tile, fewer than the block's 128
POOL_MODES = {"band512": (1024, 2048, 256, False), "w192": (1024, 2048, 192, True),
              "band3456": (2048, 4096, 1600, False), "tile96": (96, 512, 128, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("tau", [False, True], ids=["radius", "tau"])
@pytest.mark.parametrize("mode,c", [(m, c) for m in sorted(POOL_MODES) for c in (128, 1024)] + [("band512", 20)])
def test_maxpool_kernels_bitequal_on_ties_windows_and_long_bands(cuda_device, mode, c, tau):
    """Kernels #3 (radius) and #8 (tau) bit-equal to their plain versions
    with duplicated points and features (maxima tie, and under tau the
    k-th and (k+1)-th distances), lone queries (empty neighbourhoods give
    0), window starts, a band over one membership segment, a tile under
    128 queries and a width that is no whole 16-byte piece (C = 20, element
    by element), fp32 and bf16, the same bits on two launches."""
    m, n, width, windowed = POOL_MODES[mode]
    q, s = clouds(m, n, cuda_device, lone=4)
    s, f32 = tied_features(s, c, cuda_device, seed=3)
    thr = banded_knn_tau_plain(q, s, 64, 128, width) if tau else None
    starts = None
    if windowed:
        starts = (dynamic_knn_starts(q, s, banded_knn_tau_plain(q, s, 64, 128, 2 * width), 128, width, 1) if tau
                  else dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1))
        if tau:
            thr = banded_knn_tau_plain(q, s, 64, 128, width, starts)
    for dtype in (torch.float32, torch.bfloat16):
        f = f32.to(dtype)
        if tau:
            run = lambda: banded_maxpool_tau(f, q, s, thr, 128, width, starts)  # noqa: E731
            ref = banded_maxpool_tau_plain(f, q, s, thr, 128, width, starts)
        else:
            run = lambda: banded_maxpool_fused(f, q, s, R_ACT, 128, width, starts)  # noqa: E731
            ref = banded_maxpool_plain(f, q, s, R_ACT, 128, width, starts)
        out = run()
        assert out.dtype == dtype
        assert torch.equal(out, ref)
        assert torch.equal(out, run())
        if not tau:
            assert (out == 0).all(-1).any()


# the tie count (#12, the forward's COUNT mode) at every shortcut width in
# fp32 on a 256-row band, in a band over one 3072-row membership segment
# and on w192 windows, and in bf16 at two widths of each
COUNT_CASES = ([("band512", c, "fp32") for c in POOL_WIDTHS] + [("band3456", c, "fp32") for c in (128, 1024)]
               + [("w192", c, "fp32") for c in (256, 512)]
               + [(m, c, "bf16") for m in ("band512", "band3456", "w192") for c in (128, 1024)])


@pytest.mark.gpu
@pytest.mark.parametrize("tau", [False, True], ids=["radius", "tau"])
@pytest.mark.parametrize("mode,c,dtype", COUNT_CASES)
def test_tie_count_over_the_new_forward_equals_plain(cuda_device, mode, c, dtype, tau):
    """#12's count over the forward kernel's output equals the plain count
    (the forward's output equal to the plain one first): the count walks
    exactly the rows the forward maxed over, by radius and by tau, on
    static bands (one and two membership segments) and windows, fp32 and
    bf16 (compared in fp32: +0 == -0), ties present, the same bits on two
    launches."""
    m, n, width, windowed = POOL_MODES[mode]
    q, s = clouds(m, n, cuda_device, lone=4)
    s, f = tied_features(s, c, cuda_device, seed=4)
    f = f.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    f[:, 4::16, 1] = 0.0  # signed zeros, equal in fp32
    f[:, 5::16, 1] = -0.0
    starts = None
    if windowed:
        starts = (dynamic_knn_starts(q, s, banded_knn_tau_plain(q, s, 64, 128, 2 * width), 128, width, 1) if tau
                  else dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1))
    thr = banded_knn_tau_plain(q, s, 128, 128, width, starts) if tau else None
    if tau:
        out = banded_maxpool_tau(f, q, s, thr, 128, width, starts)
        assert torch.equal(out, banded_maxpool_tau_plain(f, q, s, thr, 128, width, starts))
    else:
        out = banded_maxpool_fused(f, q, s, R_ACT, 128, width, starts)
        assert torch.equal(out, banded_maxpool_plain(f, q, s, R_ACT, 128, width, starts))
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, width, starts, tau=thr)
    again = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, width, starts, tau=thr)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, R_ACT, 128, width, starts, tau=thr))
    assert torch.equal(cnt, again)
    assert (cnt > 1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 13])
def test_tie_count_masks_the_walks_padding(cuda_device, k, dtype):
    """On features equal in every row each member ties with the max, so
    the count is the number of members: k-NN thresholds of k = 1, 3 (fewer
    members than one 4-row walk step), 4, 8 (whole steps) and 13 give
    nearly every query exactly k members on distinct points, and the
    walk's repeats of the last member past the end must add nothing."""
    q, s = clouds(1024, 2048, cuda_device)
    thr = banded_knn_tau_plain(q, s, k, 128, 256)
    members = banded_pair_count(q, s, None, 128, 256, None, thr)
    assert (members == k).float().mean() > 0.99  # more only where the k-th and (k+1)-th d2 tie
    f = torch.full((2, 2048, 20), 0.5, device=cuda_device).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    out = banded_maxpool_tau(f, q, s, thr, 128, 256)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, 0.0, 128, 256, tau=thr)
    assert torch.equal(cnt, members[..., None].float().expand_as(cnt))
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, 0.0, 128, 256, tau=thr))


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
@pytest.mark.parametrize("queries", ["normalised", "randn"])
@pytest.mark.parametrize("b,l,s_len", [(2, 1, 1280), (2, 1000, 1100), (2, 1280, 40), (8, 1280, 1280)])
def test_attention_fp32_tensor_core_kernel_matches_plain(cuda_device, b, l, s_len, queries):
    """The fp32 body (3xTF32 on the tensor cores) at the same ragged shapes
    and at the `.t7` path's, with both query kinds: abs <= 1e-5 against the
    plain version, output fp32, the same bits on two launches."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(b, l, 4, 32, generator=g).to(cuda_device)
    if queries == "normalised":
        q = q / q.norm(dim=1, keepdim=True)
    k, v = (torch.randn(b, s_len, 4, 32, generator=g).to(cuda_device) for _ in range(2))
    out, again = fused_attention(q, k, v), fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert (out - fused_attention_plain(q, k, v)).abs().max().item() <= 1e-5
    assert torch.equal(out, again)


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


# kernel #1 in fp32 (3xTF32): a static band, w192 windows, and a band of
# 3200 rows, over the fp32 plan's 3072-row membership segment
F32_MODES = {"static": (1024, 2048, 256, False), "w192": (1024, 2048, 192, True),
             "band3200": (512, 4096, 1536, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(F32_MODES))
@pytest.mark.parametrize("cin,cout", [(4, 64), (32, 32), (32, 64), (64, 64), (128, 128), (256, 256), (512, 512)])
def test_kpconv_fp32_tensor_core_kernel_matches_plain(cuda_device, cin, cout, mode):
    """Kernel #1 in fp32 (csrc/kpconv_mma.cuh by 3xTF32) at every (Cin,
    Cout) of the KITTI FPN (Cin = 4 on fp32 features, as encoder1_1), on a
    static band, w192 windows and a 3200-row band: counts bit-equal to the
    plain version, rel <= 1e-3 (about 1e-6 expected, as the tau kernel
    gives), the same bits on two launches; at Cin = 64 also on bf16
    features."""
    m, n, width, dynamic = F32_MODES[mode]
    q, s = clouds(m, n, cuda_device, lone=4)
    g = torch.Generator().manual_seed(cin + cout)
    f32 = torch.randn(2, n, cin, generator=g).to(cuda_device)
    w = (torch.randn(15, cin, cout, generator=g) / cin**0.5).to(cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1) if dynamic else None
    for f in (f32, f32.bfloat16()) if cin == 64 else (f32,):
        args = (f, q, s, w, R, S, 15, 128, width, torch.float32, starts)
        ref, ref_cnt = banded_kpconv_fused_plain(*args)
        out, cnt = banded_kpconv_fused(*args)
        again, _ = banded_kpconv_fused(*args)
        torch.cuda.synchronize()
        assert torch.equal(cnt, ref_cnt)
        assert rel_err(out, ref) <= 1e-3
        assert torch.equal(out, again)


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
# static bands of 768 rows, of encoder4_2's 2176 and encoder5_1's 2304
# (also at C = 512, two channel blocks of the transpose), and of 3200
# (walked in two slices of kept membership bits), w256 windows, bf16
# compute; the transpose (#9) beside it on the static bands
AGG_MODES = {"band768": (1024, 2048, 32, 256, "static"), "band768_c64": (2048, 2048, 64, 256, "static"),
             "band768_c512": (1024, 1024, 512, 256, "static"), "band2176": (2560, 2560, 256, 1024, "static"),
             "band2304": (1280, 2560, 256, 1024, "static"), "band2304_c512": (1280, 2560, 512, 1024, "static"),
             "band3200": (3328, 3328, 32, 1536, "static"), "w256": (1024, 2048, 64, 256, "window"),
             "bf16": (2048, 2048, 64, 256, "bf16")}


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
    the plain version's bf16 either); #9 (the tensor-core transposed
    kernel under radius membership, 3xTF32) beside it on static bands, rel
    <= 1e-4 and the same bits on two launches."""
    m, n, c, bw, kind = AGG_MODES[mode]
    q, s = clouds(m, n, cuda_device)
    if mode.startswith("band2304"):
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
        again = banded_kpconv_transpose_fused(gw, q, s, R, S, 15, 128, bw)
        torch.cuda.synchronize()
        assert rel_err(got, banded_kpconv_transpose_plain(gw, q, s, R, S, 15, 128, bw)) <= 1e-4
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("c", POOL_WIDTHS)
def test_maxpool_backward_kernels_match_plain(cuda_device, c):
    """The tie count on static bands bit-equal and the same on two
    launches, kernel #13 rel <= 1e-5 and the same bits on two launches, at
    every shortcut width."""
    q, s = clouds(512, 2048, cuda_device)
    s, f = tied_features(s, c, cuda_device)
    out = banded_maxpool_fused(f, q, s, R_ACT, 128, 256)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, 256)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, R_ACT, 128, 256))
    assert torch.equal(cnt, banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, 256))
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(cuda_device) / cnt.clamp(min=1)
    got = banded_maxpool_backward_fused(gs, f, q, s, out, R_ACT, 128, 256)
    again = banded_maxpool_backward_fused(gs, f, q, s, out, R_ACT, 128, 256)
    torch.cuda.synchronize()
    assert rel_err(got, banded_maxpool_route_plain(gs, f, q, s, out, R_ACT, 128, 256)) <= 1e-5
    assert torch.equal(got, again)


# kernel #13 (csrc/maxpool_route.cu, radius policy): (M, N, C, band width,
# dtype); bf16 at one width, N = 2080 (32 * 65), where the wrapper plans
# 32-row support tiles under the kernel's 64, and encoder5_1's 2304-row
# band (the whole query level in one window)
RADIUS_ROUTE_CASES = [(512, 2048, 256, 256, "bf16"), (1024, 2080, 128, 256, "fp32"), (1280, 2560, 256, 1024, "fp32")]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,c,bw,dtype", RADIUS_ROUTE_CASES)
def test_radius_maxpool_backward_kernel_matches_plain(cuda_device, m, n, c, bw, dtype):
    """Kernel #13 on duplicated points in bf16, with support tiles under 64
    rows and on a 2304-row band: the tie count bit-equal, rel <= 1e-5
    against the plain version, the same bits on two launches."""
    q, s = clouds(m, n, cuda_device)
    s, f = tied_features(s, c, cuda_device, seed=5)
    if (m, n) == (1280, 2560):
        q = s[:, ::2].contiguous()  # a Morton subset, as the pyramid's next level: band 2304
    f = f.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    out = banded_maxpool_fused(f, q, s, R_ACT, 128, bw)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, bw)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, R_ACT, 128, bw))
    assert (cnt > 1).any()
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(13)).to(cuda_device) / cnt.clamp(min=1)
    got = banded_maxpool_backward_fused(gs, f, q, s, out, R_ACT, 128, bw)
    again = banded_maxpool_backward_fused(gs, f, q, s, out, R_ACT, 128, bw)
    torch.cuda.synchronize()
    assert rel_err(got, banded_maxpool_route_plain(gs, f, q, s, out, R_ACT, 128, bw)) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("windowed", [False, True], ids=["static", "w256"])
@pytest.mark.parametrize("scale", [0.25, 0.5, 1.0, 2.0])
def test_radius_routing_on_constant_features(cuda_device, scale, windowed):
    """On features equal in every row each member ties with the max, so the
    tie count is the number of members and each member row gets every
    holding query's g / count: kernels #13 (static bands) and #14 (w256
    windows) at reaches of 0.25 to 2 times the level-2 one (a few members
    a query to some hundred; lone queries none), rel <= 1e-5 against the
    plain version, the same bits on two launches.  A pair whose membership
    differed from the forward's would leave a member without its share."""
    q, s = clouds(1024, 2048, cuda_device, lone=4)
    ra = R_ACT * scale
    starts = dynamic_band_starts(q, s, ra, 128, 256, "best", 1) if windowed else None
    f = torch.full((2, 2048, 128), 0.5, device=cuda_device)
    out = banded_maxpool_fused(f, q, s, ra, 128, 256, starts)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, ra, 128, 256, starts)
    members = banded_pair_count(q, s, ra, 128, 256, starts)
    assert torch.equal(cnt, members[..., None].float().expand_as(cnt))
    assert (members == 0).any() and (members > 1).any()
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(14)).to(cuda_device) / cnt.clamp(min=1)
    if windowed:
        run = lambda: banded_maxpool_backward_dyn_fused(gs, f, q, s, out, starts, ra, 128, 256)  # noqa: E731
        ref = banded_maxpool_route_dyn_plain(gs, f, q, s, out, starts, ra, 128, 256)
    else:
        run = lambda: banded_maxpool_backward_fused(gs, f, q, s, out, ra, 128, 256)  # noqa: E731
        ref = banded_maxpool_route_plain(gs, f, q, s, out, ra, 128, 256)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert rel_err(got, ref) <= 1e-5
    assert torch.equal(got, again)


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
    (128, 128, 128, 256, False), (256, 16384, 128, 8192, False), (1024, 1024, 128, 192, "constant"),
    (384, 384, 16, 128, "constant"),
])
def test_knn_tau_kernel_bitequal_to_plain(cuda_device, m, n, k, width, windowed):
    """Static bands, windows, a band of the whole level with k = band, a
    band of MAX_BAND rows (the kernel's mode that recomputes d2 on every
    walk), constant points (every d2 +0 ties: tau 1e-12), and duplicated
    points whose k-th and (k+1)-th distances tie; the same bits on two
    launches."""
    q, s = clouds(m, n, cuda_device)
    s, _ = tied_features(s, 1, cuda_device)
    if m == n:
        q = s
    if windowed == "constant":
        q = s = torch.full_like(s, 3.25)
    starts = None
    if windowed is True:
        starts = dynamic_knn_starts(q, s, banded_knn_tau_plain(q, s, k, 128, 2 * width), 128, width, 1)
    ref = banded_knn_tau_plain(q, s, k, 128, width, starts)
    got = banded_knn_tau_kernel(q, s, k, 128, width, starts)
    again = banded_knn_tau_kernel(q, s, k, 128, width, starts)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if n == 16384:
        assert band_plan(m, n, 128, width)[2] == MAX_BAND
    if windowed == "constant":
        assert (ref == torch.tensor(1e-12, dtype=torch.float32)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("c", POOL_WIDTHS)
def test_maxpool_tau_kernel_bitequal_to_plain(cuda_device, c):
    q, s = clouds(1024, 2048, cuda_device, lone=8)
    s, f32 = tied_features(s, c, cuda_device)
    tau = banded_knn_tau_plain(q, s, 16, 128, 256)
    for dtype in (torch.float32, torch.bfloat16):
        f = f32.to(dtype)
        out = banded_maxpool_tau(f, q, s, tau, 128, 256)
        assert out.dtype == dtype
        assert torch.equal(out, banded_maxpool_tau_plain(f, q, s, tau, 128, 256))
        assert torch.equal(out, banded_maxpool_tau(f, q, s, tau, 128, 256))  # the same bits again


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
@pytest.mark.parametrize("m,n,c,w", [(1024, 2048, 64, 256), (2048, 2048, 256, 256), (512, 1024, 512, 256),
                                     (2560, 5120, 64, 2304), (1024, 2048, 128, 160)])
def test_window_transpose_kernel_matches_plain(cuda_device, m, n, c, w):
    """Kernel #10 (the tensor-core transposed kernel's window mode, 3xTF32)
    on w256 windows, at C = 512 (two channel blocks), on w2304 windows
    (over 2048 rows) and on w160 (blocks of 32 rows): rel <= 1e-4 against
    the plain version, the scatter bit-equal to its plain version on the
    kernel's stack, and the same bits on two launches."""
    q, s = clouds(m, n, cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, w, "best", 1)
    gw = torch.randn(2, m, 15, c, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    got = banded_kpconv_transpose_dyn_fused(gw, q, s, starts, R, S, 15, 128, w)
    assert rel_err(got, banded_kpconv_transpose_dyn_plain(gw, q, s, starts, R, S, 15, 128, w)) <= 1e-4
    out, stack = transpose_dyn_with_stack(gw, q, s, starts, R, S, 15, 128, w)
    torch.cuda.synchronize()
    assert torch.equal(out, band_scatter_plain(stack, starts, n)) and torch.equal(out, got)


@pytest.mark.gpu
@pytest.mark.parametrize("c", POOL_WIDTHS)
def test_window_maxpool_backward_kernels_match_plain(cuda_device, c):
    """The tie count in window mode bit-equal and the same on two launches,
    kernel #14 rel <= 1e-5, its scatter bit-equal on its own stack;
    duplicated points tie; every shortcut width."""
    q, s = clouds(512, 2048, cuda_device)
    s, f = tied_features(s, c, cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, 256, "best", 1)
    out = banded_maxpool_fused(f, q, s, R_ACT, 128, 256, starts)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, 256, starts)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, R_ACT, 128, 256, starts))
    assert torch.equal(cnt, banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, 256, starts))
    assert (cnt > 1).any()
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(cuda_device) / cnt.clamp(min=1)
    got = banded_maxpool_backward_dyn_fused(gs, f, q, s, out, starts, R_ACT, 128, 256)
    assert rel_err(got, banded_maxpool_route_dyn_plain(gs, f, q, s, out, starts, R_ACT, 128, 256)) <= 1e-5
    g2, stack = route_dyn_with_stack(gs, f, q, s, out, starts, R_ACT, 128, 256)
    g3, stack2 = route_dyn_with_stack(gs, f, q, s, out, starts, R_ACT, 128, 256)
    torch.cuda.synchronize()
    assert torch.equal(g2, band_scatter_plain(stack, starts, s.shape[1]))
    assert torch.equal(stack, stack2) and torch.equal(g2, g3) and torch.equal(got, g2)  # the same bits twice


@pytest.mark.gpu
@pytest.mark.parametrize("w,dtype", [(256, "fp32"), (160, "fp32"), (256, "bf16")])
def test_window_maxpool_backward_at_the_support_edges(cuda_device, w, dtype):
    """Kernel #14 on windows placed by hand: tile 0's at row 0, tile 1's at
    an odd row, tiles 3 and 7 at N - w (the last rows; tile 3's queries lie
    elsewhere and hold few of them), so a block's first row, starts[b, t]
    + its offset read on the device, reaches the support's end; w160 slices
    each window into 32-row blocks (TS < 64); fp32 and bf16.  The stack's
    scatter bit-equal to its plain version, rel <= 1e-5, the same bits on
    two launches."""
    q, s = clouds(1024, 2048, cuda_device)
    s, f = tied_features(s, 128, cuda_device, seed=6)
    f = f.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    n = s.shape[1]
    starts = dynamic_band_starts(q, s, R_ACT, 128, w, "best", 1).to(torch.int32).clone()
    starts[:, 0], starts[:, 1], starts[:, 3], starts[:, 7] = 0, 37, n - w, n - w
    out = banded_maxpool_fused(f, q, s, R_ACT, 128, w, starts)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, R_ACT, 128, w, starts)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, R_ACT, 128, w, starts))
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(15)).to(cuda_device) / cnt.clamp(min=1)
    args = (gs, f, q, s, out, starts, R_ACT, 128, w)
    got, stack = route_dyn_with_stack(*args)
    again, stack2 = route_dyn_with_stack(*args)
    torch.cuda.synchronize()
    assert rel_err(got, banded_maxpool_route_dyn_plain(*args)) <= 1e-5
    assert torch.equal(got, band_scatter_plain(stack, starts, n))
    assert torch.equal(stack, stack2) and torch.equal(got, again)
    assert stack[:, 7].abs().sum() > 0  # the last rows took gradient


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


# kernel #15 (csrc/maxpool_route.cu): (M, N, C, band width, dtype); every
# shortcut width on 512-row bands, encoder5_1's 2304-row band (the whole
# query level in one window), bf16, and N = 2080 (32 * 65), where the
# wrapper plans 32-row support tiles, under the kernel's 64
ROUTE_CASES = [(512, 2048, c, 256, "fp32") for c in POOL_WIDTHS] + [
    (1280, 2560, 256, 1024, "fp32"), (512, 2048, 256, 256, "bf16"), (1024, 2080, 128, 256, "fp32")]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,c,bw,dtype", ROUTE_CASES)
def test_tau_maxpool_backward_kernels_match_plain(cuda_device, m, n, c, bw, dtype):
    """The tie count in tau mode bit-equal, kernel #15 rel <= 1e-5 against
    its plain version; both the same bits on two launches."""
    q, s = clouds(m, n, cuda_device)
    s, f = tied_features(s, c, cuda_device)
    if (m, n) == (1280, 2560):
        q = s[:, ::2].contiguous()  # a Morton subset, as the pyramid's next level: band 2304
    f = f.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    tau = banded_knn_tau_plain(q, s, 16, 128, bw)
    out = banded_maxpool_tau(f, q, s, tau, 128, bw)
    cnt = banded_maxpool_tie_count_fused(f, q, s, out, 0.0, 128, bw, tau=tau)
    assert torch.equal(cnt, banded_maxpool_tie_count_plain(f, q, s, out, 0.0, 128, bw, tau=tau))
    assert torch.equal(cnt, banded_maxpool_tie_count_fused(f, q, s, out, 0.0, 128, bw, tau=tau))
    assert (cnt > 1).any()
    gs = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)).to(cuda_device) / cnt.clamp(min=1)
    got = banded_maxpool_backward_tau_fused(gs, f, q, s, out, tau, 128, bw)
    again = banded_maxpool_backward_tau_fused(gs, f, q, s, out, tau, 128, bw)
    torch.cuda.synchronize()
    assert rel_err(got, banded_maxpool_route_tau_plain(gs, f, q, s, out, tau, 128, bw)) <= 1e-5
    assert torch.equal(got, again)


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


@pytest.mark.gpu
@pytest.mark.parametrize("width,dynamic", [(256, False), (192, True)])
def test_residual_fused_fp32_kernel_ties_match_plain_and_the_pair(cuda_device, width, dynamic):
    """#16 in fp32 (#1's tensor-core kernel in POOL mode, 3xTF32) at
    encoder3_1's widths on clouds whose shortcut maxima tie: counts equal,
    the shortcut bit-equal to the plain version and to #3, the conv
    bit-equal to #1's and within 1e-3 of the plain version, the same bits
    on two launches."""
    q, s = clouds(1024, 2048, cuda_device, lone=8)
    s, fm = tied_features(s, 256, cuda_device)
    q = s[:, ::2].contiguous()
    fa = torch.randn(2, 2048, 64, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    w = (torch.randn(15, 64, 64, generator=torch.Generator().manual_seed(4)) / 8.0).to(cuda_device)
    starts = dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1) if dynamic else None
    args = (fm, fa, w, q, s, R, S, 15, 128, width, torch.float32, starts)
    out, cnt, mp = banded_residual_fused(*args)
    again, _, mp_again = banded_residual_fused(*args)
    ref, ref_cnt, ref_mp = banded_residual_fused_plain(*args)
    conv, conv_cnt = banded_kpconv_fused(fa, q, s, w, R, S, 15, 128, width, torch.float32, starts)
    pooled = banded_maxpool_fused(fm, q, s, R_ACT, 128, width, starts)
    torch.cuda.synchronize()
    assert torch.equal(cnt, ref_cnt) and torch.equal(cnt, conv_cnt)
    assert mp.dtype == torch.float32 and torch.equal(mp, ref_mp) and torch.equal(mp, pooled)
    assert torch.equal(out, conv) and rel_err(out, ref) <= 1e-3
    assert torch.equal(out, again) and torch.equal(mp, mp_again)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", ENC1_1_SEEDS)
def test_kpconv_tau_bf16_error_at_cin4_tracks_the_plain_version(cuda_device, seed):
    """Kernel #7 in bf16 at encoder1_1 (Cin = 4 -> 64) over the seeds on
    which tests/test_torch_tau_bf16_error.py reads the JAX reference's bf16
    error: against one fp32 truth (the fp32 plain version) the kernel errs
    as the plain bf16 version does, whose error is the reference's (over
    5e-2 on one of these draws, 8.8e-2, as the reference's own).  The
    kernel rounds at the plain version's points but sums in another order,
    so an element may round to the neighbouring bf16 value (2^-8
    relative): its error lies within 1e-3 of the plain one's, and it is
    within 5e-3 of the plain bf16 output itself (2.4e-4 at most over these
    draws on an H100)."""
    f, s, w, tau, kp = (torch.as_tensor(x).to(cuda_device) for x in enc1_1_tau_inputs(seed))
    args = (s, s, w, tau, kp, ENC1_1_R, ENC1_1_S, 15, 128, ENC1_1_BW)
    truth, _ = banded_kpconv_fused_tau_plain(f, *args)
    for fk in (f.bfloat16(), f):  # bf16 features, and fp32 ones as encoder1_1 takes them
        plain, plain_cnt = banded_kpconv_fused_tau_plain(fk, *args, torch.bfloat16)
        out, cnt = banded_kpconv_fused_tau(fk, *args, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(cnt, plain_cnt)
        e_kernel, e_plain, apart = rel_err(out, truth), rel_err(plain, truth), rel_err(out, plain)
        print(f"encoder1_1 seed {seed} {fk.dtype}: kernel {e_kernel:.4e}, plain {e_plain:.4e}, apart {apart:.3e}")
        assert abs(e_kernel - e_plain) <= 1e-3, (e_kernel, e_plain)
        assert apart <= 5e-3


RANSAC_INPUTS = {"scene": ransac_scene, "junk": ransac_junk, "degenerate": ransac_degenerate}


def _same_bits(a, b):
    view = torch.int32 if a.is_floating_point() else torch.uint8 if a.dtype == torch.bool else a.dtype
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.gpu
@pytest.mark.parametrize("kind, b, h, n", [("scene", 8, 512, 1280), ("scene", 1, 512, 1280), ("junk", 8, 512, 1280),
                                           ("junk", 1, 512, 1280), ("scene", 2, 32, 1000), ("junk", 2, 32, 1000),
                                           ("degenerate", 3, 32, 1000)])
def test_ransac_kernels_match_the_plain_version(cuda_device, kind, b, h, n):
    gen = torch.Generator().manual_seed(b * 7919 + h * 31 + n)
    data = [x.to(cuda_device) for x in RANSAC_INPUTS[kind](b, n, gen)]
    gumbel = gumbel_noise((b, h, n), gen, "cpu").to(cuda_device)
    got, hyp = ransac_pnp_kernel(gumbel, *data)
    again, hyp_again = ransac_pnp_kernel(gumbel, *data)
    want_hyp = ransac_hypotheses_plain(gumbel, *data)
    want = ransac_pnp_plain(gumbel, *data)
    assert all(_same_bits(x, y) for x, y in zip((*got, *hyp), (*again, *hyp_again)))
    assert torch.equal(hyp.samples.long(), want_hyp.samples)
    share = (hyp.counts.long() == want_hyp.counts).float().mean().item()
    print(f"ransac {kind} B={b} H={h} N={n}: hypothesis counts equal on {share:.5f}")
    assert share >= 0.999
    assert torch.equal(got.num_inliers, want.num_inliers)
    assert torch.equal(got.success, want.success)
    for x, y in ((got.R.flatten(1), want.R.flatten(1)), (got.t, want.t)):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        fin = torch.isfinite(x) & torch.isfinite(y)
        scale = y.nan_to_num(0, 0, 0).abs().amax(-1, keepdim=True).clamp(min=1).expand_as(y)
        assert ((x - y).abs() / scale)[fin].max().item() <= 1e-4 if fin.any() else True


@pytest.mark.gpu
def test_ransac_pnp_launches_the_kernels_and_refuses_other_samples(cuda_device):
    gen = torch.Generator().manual_seed(3)
    data = [x.to(cuda_device) for x in ransac_scene(2, 200, gen)]
    gumbel = gumbel_noise((2, 32, 200), gen, "cpu").to(cuda_device)
    ransac_pnp.launches = 0
    res = ransac_pnp(gumbel, *data)
    assert ransac_pnp.launches == 1 and res.R.is_cuda
    with pytest.raises(ValueError, match="sample_size"):
        ransac_pnp(gumbel, *data, sample_size=5)
    assert ransac_pnp.launches == 1


@pytest.mark.gpu
def test_ransac_pnp_computes_in_fp32_with_tf32_on(cuda_device):
    """TF32 products would round the plain version's sums' operands, which
    no fp32 order repeats: the kernels' products stay IEEE fp32 and give the
    bits they give with TF32 off, and the caller's setting survives."""
    gen = torch.Generator().manual_seed(11)
    data = [x.to(cuda_device) for x in ransac_junk(8, 1280, gen)]
    gumbel = gumbel_noise((8, 512, 1280), gen, "cpu").to(cuda_device)
    want = ransac_pnp(gumbel, *data)
    torch.set_float32_matmul_precision("high")
    try:
        got = ransac_pnp(gumbel, *data)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert all(_same_bits(x, y) for x, y in zip(got, want))
