"""The strided ResidualBlock's fused band pass (kernel #16): the port's plain
version, dispatch rule and block against the JAX package's
banded_residual_fused_pallas (interpret mode on the CPU), its
residual_fused_fits and its flax ResidualBlock with kernel='pallas'.

Tolerances: counts and shortcuts exact (a select over the same
membership); the conv 1e-4 relative (rms-floored) with fp32 sums, as the
KPConv's own tests hold it.  With a bf16 compute dtype the two sides round
different fp32 influences (JAX's matmul identity on tile-centred
coordinates, the port's float64 offsets) to bf16, so single products move
by a bf16 ulp: the conv is held to 5e-3 there.  The block's forward and
its VJP (features and every parameter) 1e-4.  The CUDA kernel is held
against the plain version on the card in test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.models.kpconv import ResidualBlock as JResidualBlock
from cofii2p_tpu.ops.banded import dynamic_band_starts, kernel_reach
from cofii2p_tpu.ops.residual_kernel import banded_residual_fused_pallas
from cofii2p_tpu.ops.residual_kernel import residual_fused_fits as j_residual_fused_fits
from cofii2p_tpu_torch.models.kpconv import ResidualBlock
from cofii2p_tpu_torch.ops.residual_kernel import (
    banded_residual_apply,
    banded_residual_fused,
    banded_residual_fused_plain,
    residual_fused_fits,
)
from tests.torch_parity import lidar_cloud, ordered, rel_err

R, S = 1.7, 0.8  # the level-2 radius and sigma of the KITTI FPN
TILE = 128


def setup(m=256, n=512, cin=16, cmid=8, seed=0):
    rng = np.random.default_rng(seed)
    s_pts = np.stack([ordered(lidar_cloud(n, rng, extent=12.0)) for _ in range(2)])
    # strided queries: a subset of the support, as the pyramid subsamples
    q_pts = np.stack([ordered(s[rng.choice(n, m, replace=False)]) for s in s_pts])
    fm = rng.normal(size=(2, n, cin)).astype(np.float32)
    fa = rng.normal(size=(2, n, cmid)).astype(np.float32)
    w = (rng.normal(size=(15, cmid, cmid)) / np.sqrt(cmid)).astype(np.float32)
    return fm, fa, w, q_pts, s_pts


def window_starts(q_pts, s_pts, width):
    r_act = kernel_reach(R, S)
    return np.asarray(jax.vmap(lambda q, s: dynamic_band_starts(q, s, r_act, TILE, width, "best", 1))(
        jnp.asarray(q_pts), jnp.asarray(s_pts)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [0, 192])
def test_plain_matches_pallas(width, dtype):
    """Static band (64 rows either side) or w192 windows; features in
    ``dtype``, the conv summed in fp32, then (bf16) in the bf16 compute
    dtype of serving."""
    fm, fa, w, q_pts, s_pts = setup()
    starts = window_starts(q_pts, s_pts, width) if width else None
    bw = width or 64
    jfm, jfa = jnp.asarray(fm).astype(dtype), jnp.asarray(fa).astype(dtype)
    tdt = getattr(torch, dtype)
    tfm = torch.as_tensor(np.asarray(jfm.astype(jnp.float32))).to(tdt)
    tfa = torch.as_tensor(np.asarray(jfa.astype(jnp.float32))).to(tdt)
    geo = (jnp.asarray(q_pts), jnp.asarray(s_pts), R, S, 15, TILE, bw)
    tgeo = (torch.as_tensor(q_pts), torch.as_tensor(s_pts), R, S, 15, TILE, bw)
    jst = None if starts is None else jnp.asarray(starts)
    tst = None if starts is None else torch.as_tensor(starts)
    computes = [("float32", 1e-4)] + ([("bfloat16", 5e-3)] if dtype == "bfloat16" else [])
    for compute, tol in computes:
        j_out, j_cnt, j_mp = banded_residual_fused_pallas(jfm, jfa, jnp.asarray(w), *geo, jnp.dtype(compute), True,
                                                          jst)
        t_out, t_cnt, t_mp = banded_residual_fused_plain(tfm, tfa, torch.as_tensor(w), *tgeo,
                                                         getattr(torch, compute), tst)
        assert t_out.dtype == torch.float32 and t_cnt.dtype == torch.int32 and t_mp.dtype == tdt
        np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
        np.testing.assert_array_equal(t_mp.float().numpy(), np.asarray(j_mp.astype(jnp.float32)))
        assert rel_err(t_out, j_out) <= tol, compute
    assert int(t_cnt.max()) > 1  # neighbourhoods with several members


# (Cmid, Dout, Cin, band, wbytes, fbytes): the four strided blocks of the
# KITTI FPN in bf16 serving (w192 windows on support levels 1-3, the static
# 512-row band on level 0) and on the fp32 static plan (bands 512, 768,
# 1536, 2304), and a sweep around them
KITTI_TUPLES = [
    (32, 32, 128, 512, 2, 2), (64, 64, 256, 192, 2, 2), (128, 128, 512, 192, 2, 2), (256, 256, 1024, 192, 2, 2),
    (32, 32, 128, 512, 4, 4), (64, 64, 256, 768, 4, 4), (128, 128, 512, 1536, 4, 4), (256, 256, 1024, 2304, 4, 4),
]


def test_residual_fused_fits_is_the_jax_rule():
    grid = KITTI_TUPLES + [
        (cmid, cmid, cin, band, wb, fb)
        for cmid in (8, 32, 64, 128, 256)
        for cin in (16, 96, 128, 256, 512, 1024)
        for band in (64, 192, 256, 320, 512, 768, 1536, 2304, 2560)
        for wb, fb in ((2, 2), (4, 4), (2, 4), (4, 2))
    ]
    for t in grid:
        k, args = 15, t[:4] + (TILE,) + t[4:]
        assert residual_fused_fits(k, *args) == j_residual_fused_fits(k, *args), t
    fits = [residual_fused_fits(15, *t[:4], TILE, *t[4:]) for t in KITTI_TUPLES]
    assert fits == [True] * 4 + [True, True, True, False]


def test_kitti_fpn_fuses_the_strided_blocks_the_jax_rule_admits():
    """The bands the port's KITTI FPN gives its strided blocks: all four
    fuse in bf16 serving, encoder2_1-4_1 on the fp32 static plan."""
    from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig
    from cofii2p_tpu_torch.models.kpconv import KPConvFPN
    from cofii2p_tpu_torch.ops.banded import _band_geometry

    cfg = KITTIConfig()
    sizes = cfg.pyramid_sizes
    for plan, dtype, want in (((SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF), torch.bfloat16, [True] * 4),
                              ((None, None), torch.float32, [True, True, True, False])):
        fpn = KPConvFPN(init_dim=cfg.kpconv_init_dim, band_plan=cfg.kpconv_band_plan, dtype=dtype,
                        dynamic_plan=plan[0], dynamic_plan_self=plan[1], residual_fused=True)
        got = []
        for stage in range(2, 6):
            blk = getattr(fpn, f"encoder{stage}_1")
            conv = blk.KPConv
            m, n = sizes[stage - 1], sizes[stage - 2]
            # a window's width, else the static band (kpconv.py:323-329)
            windowed = fpn.dyn_w(stage - 2, False) > 0
            band = min(blk.band_width, n) if windowed else _band_geometry(m, n, TILE, blk.band_width)[2]
            cmid, dout = conv.weights.shape[1:]
            cin = blk.unary1.mlp.in_features
            args = (15, cmid, dout, cin, band, TILE, conv.wbytes, conv.wbytes)
            assert blk.residual_fused and conv.fused
            assert residual_fused_fits(*args) == j_residual_fused_fits(*args)
            got.append(residual_fused_fits(*args))
        assert got == want


def _block_state(params, with_shortcut):
    """The port block's state dict from the flax block's parameters."""
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    sd = {}

    def unary(f, t):
        sd[f"{t}.mlp.weight"] = p[f]["mlp"]["Dense_0"]["kernel"].T
        sd[f"{t}.mlp.bias"] = p[f]["mlp"]["Dense_0"]["bias"]
        sd[f"{t}.norm.norm.weight"] = p[f]["PointGroupNorm_0"]["scale"]
        sd[f"{t}.norm.norm.bias"] = p[f]["PointGroupNorm_0"]["bias"]

    unary("unary1", "unary1")
    unary("unary2", "unary2")
    if with_shortcut:
        unary("unary_shortcut", "unary_shortcut")
    for nm in ("weights", "kernel_points", "bias"):
        sd[f"KPConv.{nm}"] = p["KPConv"][nm]
    sd["norm_conv.norm.weight"] = p["PointGroupNorm_0"]["scale"]
    sd["norm_conv.norm.bias"] = p["PointGroupNorm_0"]["bias"]
    return {k: torch.tensor(np.array(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("width", [0, 192])
def test_strided_block_matches_flax(width):
    """A strided ResidualBlock (Cin 16, Cout 32, Cmid 8) with
    residual_fused=True against the flax block with kernel='pallas', whose
    KPConv takes the fused Pallas pass: the forward without grad through
    banded_residual_fused, and the VJP of features and every parameter
    through BandedKPConvFn + BandedMaxpoolFn against jax.vjp, which JAX
    takes through the unfused pair."""
    fm, _, _, q_pts, s_pts = setup()
    starts = window_starts(q_pts, s_pts, width) if width else None
    bw = width or 64
    kw = dict(in_channels=16, out_channels=32, kernel_size=15, radius=R, sigma=S, strided=True, tile=TILE,
              band_width=bw, group_norm=4, residual_fused=True)
    jblk = JResidualBlock(impl="banded", kernel="pallas", **kw)
    jq, js = jnp.asarray(q_pts), jnp.asarray(s_pts)
    jst = None if starts is None else jnp.asarray(starts)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(fm), jq, js, starts=jst)
    # perturb the norms so a mis-mapped scale or bias shows
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']") else x, params)
    g = np.random.default_rng(2).normal(size=(2, q_pts.shape[1], 32)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x: jblk.apply(p, x, jq, js, starts=jst), params, jnp.asarray(fm))
    g_params, g_feats = vjp(jnp.asarray(g))

    tblk = ResidualBlock(kernel="auto", impl="banded", **kw)
    tblk.load_state_dict(_block_state(params, with_shortcut=True))
    tq, ts = torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    tst = None if starts is None else torch.as_tensor(starts)
    assert tblk.residual_fused
    with torch.no_grad():
        got = tblk(torch.as_tensor(fm), tq, ts, tst)
    assert rel_err(got, want) <= 1e-4

    tf = torch.as_tensor(fm).requires_grad_()
    out = tblk(tf, tq, ts, tst)
    assert rel_err(out, want) <= 1e-4
    out.backward(torch.as_tensor(g))
    assert rel_err(tf.grad, g_feats) <= 1e-4
    want_grads = _block_state(g_params, with_shortcut=True)
    for name, p in tblk.named_parameters():
        assert rel_err(p.grad, want_grads[name]) <= 1e-4, name


def test_apply_differentiates_through_the_unfused_functions():
    """Under grad the fused pass is the pair BandedKPConvFn +
    BandedMaxpoolFn, with the fused wrapper's values; without grad it is
    the wrapper (its plain version on the CPU, no launch counted)."""
    fm, fa, w, q_pts, s_pts = setup()
    tq, ts = torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    args = (tq, ts, R, S, 15, TILE, 64)
    banded_residual_fused.launches = 0
    ref = banded_residual_fused(torch.as_tensor(fm), torch.as_tensor(fa), torch.as_tensor(w), *args)
    assert banded_residual_fused.launches == 0
    tfm, tfa, tw = (torch.as_tensor(x).requires_grad_() for x in (fm, fa, w))
    out, cnt, mp = banded_residual_apply(tfm, tfa, tw, *args)
    assert out.grad_fn.name().startswith("BandedKPConvFn") and mp.grad_fn.name().startswith("BandedMaxpoolFn")
    for a, b in zip((out, cnt, mp), ref):
        assert torch.equal(a.detach(), b)
    (out.sum() + mp.sum()).backward()
    assert all(t.grad is not None for t in (tfm, tfa, tw))
    with torch.no_grad():
        for a, b in zip(banded_residual_apply(tfm, tfa, tw, *args), ref):
            assert a.grad_fn is None and torch.equal(a, b)
