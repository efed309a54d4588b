"""Banded KPConv: the port's plain versions and its autograd Functions
against the JAX package's Pallas kernels (interpret mode on the CPU) and
their ``custom_vjp``s, static bands, dynamic ``starts`` and the k-NN (tau)
semantics; the CUDA kernels are held against the plain versions on the
card in test_torch_cuda_kernels.py.  Tolerances: fp32 rel 1e-4
(rms-floored), counts equal; the feature gradient on dynamic windows
2e-4, as the JAX package's own test holds its windowed backward
(tests/test_dynamic_starts.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.ops.banded import dynamic_band_starts, kernel_reach
from cofii2p_tpu.ops.kpconv_kernel import _bwd_geometry as j_bwd_geometry
from cofii2p_tpu.ops.kpconv_kernel import (
    banded_kpconv_aggregate_pallas,
    banded_kpconv_aggregate_tau_pallas,
    banded_kpconv_fused_pallas,
    banded_kpconv_fused_tau_pallas,
)
from cofii2p_tpu_torch.ops.banded import _band_geometry, _band_starts_np, _load_kernel_points, banded_knn_tau, bwd_geometry
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    BandedKPConvFn,
    banded_kpconv_aggregate_fused,
    banded_kpconv_aggregate_plain,
    banded_kpconv_apply,
    banded_kpconv_fused,
    banded_kpconv_fused_plain,
    banded_kpconv_tau_apply,
    banded_kpconv_transpose_dyn_fused,
    banded_kpconv_transpose_dyn_plain,
    banded_kpconv_transpose_fused,
    banded_kpconv_transpose_plain,
    banded_kpconv_transpose_tau_fused,
    banded_kpconv_transpose_tau_plain,
)
from cofii2p_tpu_torch.utils.convert import jittered_kernel_points
from tests.torch_parity import lidar_cloud, ordered, ordered_idx, rel_err

R, S = 1.7, 0.8  # the level-2 radius and sigma of the KITTI FPN


def setup(m, n, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    s_pts = np.stack([ordered(lidar_cloud(n, rng, extent=12.0)) for _ in range(2)])
    q_pts = s_pts if m == n else np.stack([ordered(s[rng.choice(n, m, replace=False)]) for s in s_pts])
    feats = rng.normal(size=(2, n, cin)).astype(np.float32)
    w = (rng.normal(size=(15, cin, cout)) / np.sqrt(cin)).astype(np.float32)
    return feats, q_pts, s_pts, w


@pytest.mark.parametrize("m,n,cin,cout,bw,width", [
    (512, 512, 16, 24, 64, 0),
    (256, 512, 8, 16, 48, 0),
    (512, 512, 16, 24, 0, 160),
    (256, 512, 8, 16, 0, 192),
])
def test_plain_matches_pallas(m, n, cin, cout, bw, width):
    feats, q_pts, s_pts, w = setup(m, n, cin, cout)
    starts = None
    if width:
        r_act = kernel_reach(R, S)
        starts = np.asarray(jax.vmap(
            lambda q, s: dynamic_band_starts(q, s, r_act, 128, width, "best", 1)
        )(jnp.asarray(q_pts), jnp.asarray(s_pts)))
    band_width = width or bw
    j_out, j_cnt = banded_kpconv_fused_pallas(
        jnp.asarray(feats), jnp.asarray(q_pts), jnp.asarray(s_pts), jnp.asarray(w),
        R, S, 15, 128, band_width, jnp.float32, None if starts is None else jnp.asarray(starts),
    )
    t_out, t_cnt = banded_kpconv_fused_plain(
        torch.as_tensor(feats), torch.as_tensor(q_pts), torch.as_tensor(s_pts), torch.as_tensor(w),
        R, S, 15, 128, band_width, torch.float32, None if starts is None else torch.as_tensor(starts),
    )
    assert t_out.dtype == torch.float32 and t_cnt.dtype == torch.int32
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    assert rel_err(t_out, j_out) <= 1e-4


def test_cpu_wrapper_takes_plain_version():
    feats, q_pts, s_pts, w = setup(256, 512, 8, 16)
    args = [torch.as_tensor(x) for x in (feats, q_pts, s_pts, w)]
    before = banded_kpconv_fused.launches
    out, cnt = banded_kpconv_fused(*args, R, S, 15, 128, 48)
    ref, ref_cnt = banded_kpconv_fused_plain(*args, R, S, 15, 128, 48)
    assert banded_kpconv_fused.launches == before == 0
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(cnt, ref_cnt, rtol=0, atol=0)


STATIC = [(512, 512, 16, 24, 64), (256, 512, 8, 16, 48), (256, 512, 32, 32, 256)]


@pytest.mark.parametrize("m,n,cin,cout,bw", STATIC)
def test_aggregate_plain_matches_pallas(m, n, cin, cout, bw):
    feats, q_pts, s_pts, _ = setup(m, n, cin, cout)
    j_w, j_cnt = banded_kpconv_aggregate_pallas(
        jnp.asarray(feats), jnp.asarray(q_pts), jnp.asarray(s_pts), R, S, 15, 128, bw, jnp.float32,
    )
    t_w, t_cnt = banded_kpconv_aggregate_plain(
        torch.as_tensor(feats), torch.as_tensor(q_pts), torch.as_tensor(s_pts), R, S, 15, 128, bw,
    )
    assert t_w.shape == j_w.shape and t_w.dtype == torch.float32
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    assert rel_err(t_w, j_w) <= 1e-4


@pytest.mark.parametrize("m,n,cin,cout,bw", STATIC)
def test_transpose_plain_matches_pallas_vjp(m, n, cin, cout, bw):
    """The plain transposed aggregation is the Pallas aggregate's VJP
    (_transpose_agg, kernel #9) applied to the same cotangent."""
    feats, q_pts, s_pts, _ = setup(m, n, cin, cout)
    g = np.random.default_rng(1).normal(size=(2, m, 15, cin)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f: banded_kpconv_aggregate_pallas(f, jnp.asarray(q_pts), jnp.asarray(s_pts), R, S, 15, 128, bw,
                                                 jnp.float32)[0],
        jnp.asarray(feats),
    )
    (want,) = vjp(jnp.asarray(g))
    got = banded_kpconv_transpose_plain(torch.as_tensor(g), torch.as_tensor(q_pts), torch.as_tensor(s_pts),
                                        R, S, 15, 128, bw)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m,n,cin,cout,bw", STATIC)
def test_autograd_function_matches_jax_grad(m, n, cin, cout, bw, fused):
    """BandedKPConvFn's value and gradients (features and W) against
    jax.grad through the fused kernel's custom_vjp (_fused_fwd/_fused_bwd)
    and through the aggregate kernel + einsum (the Cin = 512 fp32 path)."""
    feats, q_pts, s_pts, w = setup(m, n, cin, cout)
    g_out = np.random.default_rng(2).normal(size=(2, m, cout)).astype(np.float32)
    jq, js = jnp.asarray(q_pts), jnp.asarray(s_pts)

    def j_out(f, wt):
        if fused:
            return banded_kpconv_fused_pallas(f, jq, js, wt, R, S, 15, 128, bw, jnp.float32)[0]
        weighted, _ = banded_kpconv_aggregate_pallas(f, jq, js, R, S, 15, 128, bw, jnp.float32)
        return jnp.einsum("bmkc,kcd->bmd", weighted, wt, preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(j_out, jnp.asarray(feats), jnp.asarray(w))
    want_gf, want_gw = vjp(jnp.asarray(g_out))

    tf = torch.as_tensor(feats).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    out, cnt = banded_kpconv_apply(tf, torch.as_tensor(q_pts), torch.as_tensor(s_pts), tw, R, S, 15, 128, bw,
                                   fused=fused)
    assert out.grad_fn is not None and out.grad_fn.name().startswith("BandedKPConvFn")
    assert not cnt.requires_grad
    out.backward(torch.as_tensor(g_out))
    assert rel_err(out, want) <= 1e-4
    assert rel_err(tf.grad, want_gf) <= 1e-4
    assert rel_err(tw.grad, want_gw) <= 1e-4


def test_autograd_function_skips_feature_gradient_when_not_needed():
    """encoder1_1's input carries no gradient: only dW is formed and the
    transposed pass does not run."""
    feats, q_pts, s_pts, w = setup(256, 512, 8, 16)
    tw = torch.as_tensor(w).requires_grad_()
    calls = []
    orig = BandedKPConvFn.backward

    def spy(ctx, g, gc):
        res = orig(ctx, g, gc)
        calls.append(res[0])
        return res

    BandedKPConvFn.backward = staticmethod(spy)
    try:
        out, _ = banded_kpconv_apply(torch.as_tensor(feats), torch.as_tensor(q_pts), torch.as_tensor(s_pts), tw,
                                     R, S, 15, 128, 48)
        out.sum().backward()
    finally:
        BandedKPConvFn.backward = staticmethod(orig)
    assert calls == [None] and tw.grad is not None


def test_dynamic_windows_refuse_differentiation():
    """Only k-NN window starts still refuse differentiation, as JAX's
    _tau_fwd does; radius windows differentiate through BandedKPConvFn."""
    feats, q_pts, s_pts, w = setup(256, 512, 8, 16)
    starts = torch.zeros(2, 2, dtype=torch.int32)
    tf, tq, ts, tw = (torch.as_tensor(x) for x in (feats, q_pts, s_pts, w))
    tau = banded_knn_tau(tq, ts, 16, 128, 192)
    kp = torch.as_tensor(_load_kernel_points(R, 15), dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="forward-only"):
        banded_kpconv_tau_apply(tf.clone().requires_grad_(), tq, ts, tw, tau, kp, R, S, 15, 128, 192, starts=starts)
    out, _ = banded_kpconv_apply(tf.clone().requires_grad_(), tq, ts, tw, R, S, 15, 128, 192, starts=starts)
    assert out.grad_fn.name().startswith("BandedKPConvFn")


def setup_dup(m, n, cin, cout, seed=0):
    """As setup, but a quarter of the support rows repeat another row
    (coordinates and features), as resample_fixed pads a cloud."""
    rng = np.random.default_rng(seed)
    s_pts, feats = [], []
    for _ in range(2):
        base = lidar_cloud(n - n // 4, rng, extent=12.0)
        dup = rng.choice(len(base), n // 4)
        f = rng.normal(size=(len(base), cin))
        pts, f = np.concatenate([base, base[dup]]), np.concatenate([f, f[dup]])
        order = ordered_idx(pts)
        s_pts.append(pts[order])
        feats.append(f[order])
    s_pts = np.stack(s_pts).astype(np.float32)
    q_pts = s_pts if m == n else np.stack([ordered(s[rng.choice(n, m, replace=False)]) for s in s_pts])
    w = (rng.normal(size=(15, cin, cout)) / np.sqrt(cin)).astype(np.float32)
    return np.stack(feats).astype(np.float32), q_pts, s_pts, w


def jax_starts(q_pts, s_pts, width):
    r_act = kernel_reach(R, S)
    return np.asarray(jax.vmap(
        lambda q, s: dynamic_band_starts(q, s, r_act, 128, width, "best", 1)
    )(jnp.asarray(q_pts), jnp.asarray(s_pts)))


# windows of 128 rows, narrower than their 512-row support level
DYN = [(512, 512, 16, 128), (256, 512, 8, 128)]


@pytest.mark.parametrize("m,n,c,width", DYN)
def test_dynamic_transpose_plain_matches_pallas_vjp(m, n, c, width):
    """The plain transposed aggregation over dynamic windows against the
    VJP of the Pallas aggregate with the same starts (_transpose_agg_dyn,
    kernel #10's JAX body, interpreted), on clouds with duplicated rows;
    the windows drop in-reach pairs, so this is not the static plan."""
    feats, q_pts, s_pts, _ = setup_dup(m, n, c, c)
    starts = jax_starts(q_pts, s_pts, width)
    g = np.random.default_rng(1).normal(size=(2, m, 15, c)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f: banded_kpconv_aggregate_pallas(f, jnp.asarray(q_pts), jnp.asarray(s_pts), R, S, 15, 128, width,
                                                 jnp.float32, jnp.asarray(starts))[0],
        jnp.asarray(feats),
    )
    (want,) = vjp(jnp.asarray(g))
    tf, tq, ts, tst = (torch.as_tensor(x) for x in (feats, q_pts, s_pts, starts))
    got = banded_kpconv_transpose_dyn_plain(torch.as_tensor(g), tq, ts, tst, R, S, 15, 128, width)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 2e-4
    _, c_win = banded_kpconv_aggregate_plain(tf, tq, ts, R, S, 15, 128, width, starts=tst)
    _, c_all = banded_kpconv_aggregate_plain(tf, tq, ts, R, S, 15, 128, n)
    assert (c_win < c_all).any() and (c_win <= c_all).all()


@pytest.mark.parametrize("fused", [True, False])
def test_autograd_function_on_windows_matches_jax_grad(fused):
    """BandedKPConvFn with dynamic starts against jax.vjp through the
    fused kernel's and the aggregate kernel's custom_vjp with the same
    starts: value 1e-4, feature gradient 2e-4, weight gradient 1e-4."""
    m, n, c, width = DYN[1]
    feats, q_pts, s_pts, w = setup_dup(m, n, c, 16)
    starts = jax_starts(q_pts, s_pts, width)
    g_out = np.random.default_rng(2).normal(size=(2, m, 16)).astype(np.float32)
    jq, js, jst = jnp.asarray(q_pts), jnp.asarray(s_pts), jnp.asarray(starts)

    def j_out(f, wt):
        if fused:
            return banded_kpconv_fused_pallas(f, jq, js, wt, R, S, 15, 128, width, jnp.float32, jst)[0]
        weighted, _ = banded_kpconv_aggregate_pallas(f, jq, js, R, S, 15, 128, width, jnp.float32, jst)
        return jnp.einsum("bmkc,kcd->bmd", weighted, wt, preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(j_out, jnp.asarray(feats), jnp.asarray(w))
    want_gf, want_gw = vjp(jnp.asarray(g_out))
    tf = torch.as_tensor(feats).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    out, _ = banded_kpconv_apply(tf, torch.as_tensor(q_pts), torch.as_tensor(s_pts), tw, R, S, 15, 128, width,
                                 starts=torch.as_tensor(starts), fused=fused)
    assert out.grad_fn.name().startswith("BandedKPConvFn")
    out.backward(torch.as_tensor(g_out))
    assert rel_err(out, want) <= 1e-4
    assert rel_err(tf.grad, want_gf) <= 2e-4
    assert rel_err(tw.grad, want_gw) <= 1e-4


def tau_inputs(m, n, c, bw, seed=0):
    """Clouds with duplicated rows, the port's tau (k = 16) over the static
    band, and kernel points rotated and jittered as one layer's."""
    feats, q_pts, s_pts, w = setup_dup(m, n, c, 16, seed)
    tau = banded_knn_tau(torch.as_tensor(q_pts), torch.as_tensor(s_pts), 16, 128, bw).numpy()
    kp = jittered_kernel_points(torch.tensor(_load_kernel_points(R, 15), dtype=torch.float32),
                                torch.Generator().manual_seed(seed + 7)).numpy()
    return feats, q_pts, s_pts, w, tau, kp


TAU = [(512, 512, 16, 64), (256, 512, 8, 48)]


@pytest.mark.parametrize("m,n,c,bw", TAU)
def test_tau_transpose_plain_matches_pallas_vjp(m, n, c, bw):
    """The plain transposed aggregation under k-NN semantics against the
    VJP of banded_kpconv_aggregate_tau_pallas (_transpose_agg_tau, kernel
    #11's JAX body, interpreted) with the layer's own kernel points."""
    feats, q_pts, s_pts, _, tau, kp = tau_inputs(m, n, c, bw)
    g = np.random.default_rng(3).normal(size=(2, m, 15, c)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f: banded_kpconv_aggregate_tau_pallas(f, jnp.asarray(q_pts), jnp.asarray(s_pts), jnp.asarray(tau),
                                                     jnp.asarray(kp), R, S, 15, 128, bw, jnp.float32)[0],
        jnp.asarray(feats),
    )
    (want,) = vjp(jnp.asarray(g))
    args = [torch.as_tensor(x) for x in (g, q_pts, s_pts, tau, kp)]
    got = banded_kpconv_transpose_tau_plain(*args, R, S, 15, 128, bw)
    assert rel_err(got, want) <= 1e-4
    # the layer's kernel points matter: the canonical ones give another gradient
    canon = torch.as_tensor(_load_kernel_points(R, 15), dtype=torch.float32)
    assert rel_err(banded_kpconv_transpose_tau_plain(*args[:4], canon, R, S, 15, 128, bw), want) > 1e-2


@pytest.mark.parametrize("fused", [True, False])
def test_tau_autograd_function_matches_jax_grad(fused):
    """BandedKPConvTauFn against jax.vjp through banded_kpconv_fused_tau_pallas
    (_fused_tau_fwd/_fused_tau_bwd) and through the aggregate tau kernel
    plus einsum: value and both gradients 1e-4, counts equal."""
    m, n, c, bw = TAU[1]
    feats, q_pts, s_pts, w, tau, kp = tau_inputs(m, n, c, bw, seed=1)
    g_out = np.random.default_rng(4).normal(size=(2, m, 16)).astype(np.float32)
    jq, js, jt, jk = (jnp.asarray(x) for x in (q_pts, s_pts, tau, kp))

    def j_out(f, wt):
        if fused:
            return banded_kpconv_fused_tau_pallas(f, jq, js, wt, jt, jk, R, S, 15, 128, bw, jnp.float32)
        weighted, cnt = banded_kpconv_aggregate_tau_pallas(f, jq, js, jt, jk, R, S, 15, 128, bw, jnp.float32)
        return jnp.einsum("bmkc,kcd->bmd", weighted, wt, preferred_element_type=jnp.float32), cnt

    (want, want_cnt), vjp = jax.vjp(j_out, jnp.asarray(feats), jnp.asarray(w))
    want_gf, want_gw = vjp((jnp.asarray(g_out), np.zeros(want_cnt.shape, jax.dtypes.float0)))
    tf = torch.as_tensor(feats).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    out, cnt = banded_kpconv_tau_apply(tf, torch.as_tensor(q_pts), torch.as_tensor(s_pts), tw, torch.as_tensor(tau),
                                       torch.as_tensor(kp), R, S, 15, 128, bw, fused=fused)
    assert out.grad_fn.name().startswith("BandedKPConvTauFn") and not cnt.requires_grad
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    out.backward(torch.as_tensor(g_out))
    assert rel_err(out, want) <= 1e-4
    assert rel_err(tf.grad, want_gf) <= 1e-4
    assert rel_err(tw.grad, want_gw) <= 1e-4


@pytest.mark.parametrize("m,n,bw", [(512, 512, 64), (256, 512, 48), (1024, 2048, 256), (1280, 1280, 2560)])
def test_bwd_geometry_is_the_jax_plan(m, n, bw):
    tile, num_tiles, band, _ = _band_geometry(m, n, 128, bw)
    starts = _band_starts_np(m, n, tile, band, num_tiles)
    for stile in (256, 32, 16):
        got = bwd_geometry(m, n, tile, band, starts, stile)
        if stile == 256:
            want = j_bwd_geometry(m, n, tile, band, starts)
            assert got[:3] == want[:3]
            np.testing.assert_array_equal(got[3], want[3])
        st, ns, q_win, qstart = got
        # every query tile whose band touches a support tile lies in its window
        for s_i in range(ns):
            touch = np.nonzero((starts < (s_i + 1) * st) & (starts + band > s_i * st))[0]
            assert np.all(touch >= qstart[s_i]) and np.all(touch < qstart[s_i] + q_win // tile)


def test_cpu_wrappers_of_the_training_kernels_take_plain_versions():
    feats, q_pts, s_pts, _ = setup(256, 512, 8, 16)
    q, s = torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    g = torch.randn(2, 256, 15, 8, generator=torch.Generator().manual_seed(0))
    banded_kpconv_aggregate_fused.launches = banded_kpconv_transpose_fused.launches = 0
    got = banded_kpconv_aggregate_fused(torch.as_tensor(feats), q, s, R, S, 15, 128, 48)
    want = banded_kpconv_aggregate_plain(torch.as_tensor(feats), q, s, R, S, 15, 128, 48)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(banded_kpconv_transpose_fused(g, q, s, R, S, 15, 128, 48),
                       banded_kpconv_transpose_plain(g, q, s, R, S, 15, 128, 48))
    assert banded_kpconv_aggregate_fused.launches == banded_kpconv_transpose_fused.launches == 0


def test_cpu_wrappers_of_the_window_and_tau_transposes_take_plain_versions():
    m, n, c, bw = TAU[1]
    _, q_pts, s_pts, _, tau, kp = tau_inputs(m, n, c, bw)
    q, s = torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    g = torch.randn(2, m, 15, c, generator=torch.Generator().manual_seed(0))
    starts = torch.as_tensor(jax_starts(q_pts, s_pts, 128))
    banded_kpconv_transpose_dyn_fused.launches = banded_kpconv_transpose_tau_fused.launches = 0
    assert torch.equal(banded_kpconv_transpose_dyn_fused(g, q, s, starts, R, S, 15, 128, 128),
                       banded_kpconv_transpose_dyn_plain(g, q, s, starts, R, S, 15, 128, 128))
    tt, tk = torch.as_tensor(tau), torch.as_tensor(kp)
    assert torch.equal(banded_kpconv_transpose_tau_fused(g, q, s, tt, tk, R, S, 15, 128, bw),
                       banded_kpconv_transpose_tau_plain(g, q, s, tt, tk, R, S, 15, 128, bw))
    assert banded_kpconv_transpose_dyn_fused.launches == banded_kpconv_transpose_tau_fused.launches == 0
