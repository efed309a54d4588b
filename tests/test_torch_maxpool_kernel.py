"""Banded maxpool: the port's plain versions and its autograd Functions
against the JAX package's Pallas kernels (interpret mode on the CPU) and
their ``custom_vjp``s: the forward bit-equal (static bands and dynamic
``starts``), tie counts equal and the gradient within 1e-5 on clouds with
duplicated points, so exact ties occur, on static bands, dynamic windows
and under the k-NN (tau) semantics.  The CUDA kernels are held against the
plain versions on the card in test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.ops.banded import dynamic_band_starts, kernel_reach
from cofii2p_tpu.ops.maxpool_kernel import _match_count, banded_maxpool_pallas, banded_maxpool_tau_pallas
from cofii2p_tpu_torch.ops.banded import banded_knn_tau
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
    banded_maxpool_tau_apply,
    banded_maxpool_tau_plain,
    banded_maxpool_tie_count_fused,
    banded_maxpool_tie_count_plain,
)
from tests.torch_parity import lidar_cloud, ordered, ordered_idx, rel_err

R_ACT = kernel_reach(1.7, 0.8)


def setup(m, n, c, seed=0):
    rng = np.random.default_rng(seed)
    s_pts = np.stack([ordered(lidar_cloud(n, rng, extent=12.0, far=8)) for _ in range(2)])
    # strided queries: a subset of the support plus 8 isolated far points,
    # whose neighborhoods are empty (output 0)
    lone = np.array([500.0, 0.0, 500.0]) + 40.0 * np.arange(8)[:, None]
    q_pts = s_pts if m == n else np.stack([
        ordered(np.concatenate([s[rng.choice(n, m - 8, replace=False)], lone]).astype(np.float32))
        for s in s_pts
    ])
    feats = rng.normal(size=(2, n, c)).astype(np.float32)
    return feats, q_pts, s_pts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,c,bw,width", [
    (256, 512, 32, 64, 0),
    (512, 512, 16, 48, 0),
    (256, 512, 32, 0, 192),
])
def test_plain_bitequal_to_pallas(m, n, c, bw, width, dtype):
    feats, q_pts, s_pts = setup(m, n, c)
    starts = None
    if width:
        starts = np.asarray(jax.vmap(
            lambda q, s: dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1)
        )(jnp.asarray(q_pts), jnp.asarray(s_pts)))
    jf = jnp.asarray(feats).astype(dtype)
    want = banded_maxpool_pallas(
        jf, jnp.asarray(q_pts), jnp.asarray(s_pts), R_ACT, 128, width or bw, True,
        None if starts is None else jnp.asarray(starts),
    )
    tf = torch.as_tensor(np.asarray(jf.astype(jnp.float32))).to(getattr(torch, dtype))
    got = banded_maxpool_plain(
        tf, torch.as_tensor(q_pts), torch.as_tensor(s_pts), R_ACT, 128, width or bw,
        None if starts is None else torch.as_tensor(starts),
    )
    assert got.dtype == tf.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if m < n:
        assert (got == 0).all(-1).any()  # the isolated queries pool nothing


def test_cpu_wrapper_takes_plain_version():
    feats, q_pts, s_pts = setup(256, 512, 32)
    args = [torch.as_tensor(x) for x in (feats, q_pts, s_pts)]
    before = banded_maxpool_fused.launches
    out = banded_maxpool_fused(*args, R_ACT, 128, 64)
    assert banded_maxpool_fused.launches == before == 0
    assert torch.equal(out, banded_maxpool_plain(*args, R_ACT, 128, 64))


def setup_ties(m, n, c, seed=0):
    """As setup, but a quarter of the support rows duplicate another row
    (coordinates and features), as resample_fixed pads a cloud, and the
    features are coarsely quantised, so exact ties at the max occur."""
    rng = np.random.default_rng(seed)
    s_pts, feats = [], []
    for _ in range(2):
        base = lidar_cloud(n - n // 4, rng, extent=12.0)
        dup = rng.choice(len(base), n // 4)
        f = np.round(rng.normal(size=(len(base), c)) * 2) / 2
        pts, f = np.concatenate([base, base[dup]]), np.concatenate([f, f[dup]])
        order = ordered_idx(pts)
        s_pts.append(pts[order])
        feats.append(f[order])
    s_pts = np.stack(s_pts).astype(np.float32)
    q_pts = s_pts if m == n else np.stack([ordered(s[rng.choice(n, m, replace=False)]) for s in s_pts])
    return np.stack(feats).astype(np.float32), q_pts, s_pts


@pytest.mark.parametrize("m,n,c,bw", [(256, 512, 32, 64), (512, 512, 16, 48), (256, 512, 128, 256)])
def test_tie_count_and_gradient_match_pallas_vjp(m, n, c, bw):
    feats, q_pts, s_pts = setup_ties(m, n, c)
    jq, js = jnp.asarray(q_pts), jnp.asarray(s_pts)
    g = np.random.default_rng(3).normal(size=(2, m, c)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda f: banded_maxpool_pallas(f, jq, js, R_ACT, 128, bw), jnp.asarray(feats))
    (want_g,) = vjp(jnp.asarray(g))
    want_cnt = _match_count(jnp.asarray(feats), jq, js, jnp.full((2, m), R_ACT**2, jnp.float32), out_j, 128, bw)

    tf, tq, ts = torch.as_tensor(feats), torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    out = banded_maxpool_plain(tf, tq, ts, R_ACT, 128, bw)
    cnt = banded_maxpool_tie_count_plain(tf, tq, ts, out, R_ACT, 128, bw)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert (cnt > 1).any()  # the duplicates tie
    routed = banded_maxpool_route_plain(torch.as_tensor(g) / torch.clamp(cnt, min=1.0), tf, tq, ts, out, R_ACT, 128, bw)
    assert rel_err(routed, want_g) <= 1e-5

    tf.requires_grad_()
    got = banded_maxpool_apply(tf, tq, ts, R_ACT, 128, bw)
    assert got.grad_fn is not None and got.grad_fn.name().startswith("BandedMaxpoolFn")
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out_j))
    got.backward(torch.as_tensor(g))
    assert rel_err(tf.grad, want_g) <= 1e-5


def test_plain_autograd_splits_ties_like_the_kernels():
    """kernel='xla' differentiates the plain forward with autograd: amax
    splits a tie's gradient evenly, as the tie-count pass makes the
    kernels do."""
    feats, q_pts, s_pts = setup_ties(256, 512, 32)
    tq, ts = torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    g = torch.randn(2, 256, 32, generator=torch.Generator().manual_seed(4))
    a = torch.as_tensor(feats).requires_grad_()
    banded_maxpool_plain(a, tq, ts, R_ACT, 128, 64).backward(g)
    b = torch.as_tensor(feats).requires_grad_()
    banded_maxpool_apply(b, tq, ts, R_ACT, 128, 64).backward(g)
    assert rel_err(a.grad, b.grad) <= 1e-5


def test_cpu_wrappers_of_the_backward_kernels_take_plain_versions():
    feats, q_pts, s_pts = setup_ties(256, 512, 32)
    tf, tq, ts = torch.as_tensor(feats), torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    out = banded_maxpool_plain(tf, tq, ts, R_ACT, 128, 64)
    g = torch.randn(2, 256, 32, generator=torch.Generator().manual_seed(0))
    banded_maxpool_tie_count_fused.launches = banded_maxpool_backward_fused.launches = 0
    assert torch.equal(banded_maxpool_tie_count_fused(tf, tq, ts, out, R_ACT, 128, 64),
                       banded_maxpool_tie_count_plain(tf, tq, ts, out, R_ACT, 128, 64))
    assert torch.equal(banded_maxpool_backward_fused(g, tf, tq, ts, out, R_ACT, 128, 64),
                       banded_maxpool_route_plain(g, tf, tq, ts, out, R_ACT, 128, 64))
    assert banded_maxpool_tie_count_fused.launches == banded_maxpool_backward_fused.launches == 0


@pytest.mark.parametrize("m,n,c,width", [(256, 512, 32, 128), (512, 512, 16, 96)])
def test_dynamic_tie_count_and_gradient_match_pallas_vjp(m, n, c, width):
    """Dynamic windows narrower than their support level: the tie count
    in starts mode against _match_count with the same starts, the routing
    and BandedMaxpoolFn against the VJP of banded_maxpool_pallas with
    starts (_bwd_dyn, kernel #14's JAX body, interpreted)."""
    feats, q_pts, s_pts = setup_ties(m, n, c)
    jq, js = jnp.asarray(q_pts), jnp.asarray(s_pts)
    starts = np.asarray(jax.vmap(lambda q, s: dynamic_band_starts(q, s, R_ACT, 128, width, "best", 1))(jq, js))
    jst = jnp.asarray(starts)
    g = np.random.default_rng(5).normal(size=(2, m, c)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda f: banded_maxpool_pallas(f, jq, js, R_ACT, 128, width, True, jst), jnp.asarray(feats))
    (want_g,) = vjp(jnp.asarray(g))
    want_cnt = _match_count(jnp.asarray(feats), jq, js, jnp.full((2, m), R_ACT**2, jnp.float32), out_j, 128, width,
                            jst)

    tf, tq, ts, tst = (torch.as_tensor(x) for x in (feats, q_pts, s_pts, starts))
    out = banded_maxpool_plain(tf, tq, ts, R_ACT, 128, width, tst)
    cnt = banded_maxpool_tie_count_plain(tf, tq, ts, out, R_ACT, 128, width, tst)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert (cnt > 1).any()
    # the windows cut neighbourhoods: fewer members than the whole level gives
    assert (cnt < banded_maxpool_tie_count_plain(tf, tq, ts, out, R_ACT, 128, n)).any()
    routed = banded_maxpool_route_dyn_plain(torch.as_tensor(g) / torch.clamp(cnt, min=1.0), tf, tq, ts, out, tst,
                                            R_ACT, 128, width)
    assert rel_err(routed, want_g) <= 1e-5

    tf.requires_grad_()
    got = banded_maxpool_apply(tf, tq, ts, R_ACT, 128, width, tst)
    assert got.grad_fn is not None and got.grad_fn.name().startswith("BandedMaxpoolFn")
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out_j))
    got.backward(torch.as_tensor(g))
    assert rel_err(tf.grad, want_g) <= 1e-5


@pytest.mark.parametrize("m,n,c,bw", [(256, 512, 32, 64), (512, 512, 16, 48)])
def test_tau_tie_count_and_gradient_match_pallas_vjp(m, n, c, bw):
    """The k-NN maxpool's backward: the tie count in tau mode against
    _match_count with thr = tau, the routing and BandedMaxpoolTauFn against
    the VJP of banded_maxpool_tau_pallas (_tau_bwd, kernel #15's JAX body,
    interpreted); tau (k = 16) from the port, the same values on both
    sides."""
    feats, q_pts, s_pts = setup_ties(m, n, c, seed=1)
    tq, ts = torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    tau = banded_knn_tau(tq, ts, 16, 128, bw)
    jq, js, jt = jnp.asarray(q_pts), jnp.asarray(s_pts), jnp.asarray(tau.numpy())
    g = np.random.default_rng(6).normal(size=(2, m, c)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda f: banded_maxpool_tau_pallas(f, jq, js, jt, 128, bw), jnp.asarray(feats))
    (want_g,) = vjp(jnp.asarray(g))
    want_cnt = _match_count(jnp.asarray(feats), jq, js, jt, out_j, 128, bw)

    tf = torch.as_tensor(feats)
    out = banded_maxpool_tau_plain(tf, tq, ts, tau, 128, bw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))
    cnt = banded_maxpool_tie_count_plain(tf, tq, ts, out, 0.0, 128, bw, tau=tau)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert (cnt > 1).any()
    routed = banded_maxpool_route_tau_plain(torch.as_tensor(g) / torch.clamp(cnt, min=1.0), tf, tq, ts, out, tau,
                                            128, bw)
    assert rel_err(routed, want_g) <= 1e-5

    tf.requires_grad_()
    got = banded_maxpool_tau_apply(tf, tq, ts, tau, 128, bw)
    assert got.grad_fn is not None and got.grad_fn.name().startswith("BandedMaxpoolTauFn")
    got.backward(torch.as_tensor(g))
    assert rel_err(tf.grad, want_g) <= 1e-5
    with pytest.raises(NotImplementedError, match="forward-only"):
        banded_maxpool_tau_apply(tf, tq, ts, tau, 128, bw, torch.zeros(2, m // 128, dtype=torch.int32))


def test_cpu_wrappers_of_the_window_and_tau_backward_kernels_take_plain_versions():
    feats, q_pts, s_pts = setup_ties(256, 512, 32)
    tf, tq, ts = torch.as_tensor(feats), torch.as_tensor(q_pts), torch.as_tensor(s_pts)
    starts = torch.as_tensor(np.asarray(jax.vmap(
        lambda q, s: dynamic_band_starts(q, s, R_ACT, 128, 128, "best", 1))(jnp.asarray(q_pts), jnp.asarray(s_pts))))
    tau = banded_knn_tau(tq, ts, 16, 128, 64)
    g = torch.randn(2, 256, 32, generator=torch.Generator().manual_seed(0))
    banded_maxpool_tie_count_fused.launches = 0
    banded_maxpool_backward_dyn_fused.launches = banded_maxpool_backward_tau_fused.launches = 0
    out = banded_maxpool_plain(tf, tq, ts, R_ACT, 128, 128, starts)
    assert torch.equal(banded_maxpool_tie_count_fused(tf, tq, ts, out, R_ACT, 128, 128, starts),
                       banded_maxpool_tie_count_plain(tf, tq, ts, out, R_ACT, 128, 128, starts))
    assert torch.equal(banded_maxpool_backward_dyn_fused(g, tf, tq, ts, out, starts, R_ACT, 128, 128),
                       banded_maxpool_route_dyn_plain(g, tf, tq, ts, out, starts, R_ACT, 128, 128))
    out = banded_maxpool_tau_plain(tf, tq, ts, tau, 128, 64)
    assert torch.equal(banded_maxpool_tie_count_fused(tf, tq, ts, out, 0.0, 128, 64, tau=tau),
                       banded_maxpool_tie_count_plain(tf, tq, ts, out, 0.0, 128, 64, tau=tau))
    assert torch.equal(banded_maxpool_backward_tau_fused(g, tf, tq, ts, out, tau, 128, 64),
                       banded_maxpool_route_tau_plain(g, tf, tq, ts, out, tau, 128, 64))
    assert banded_maxpool_tie_count_fused.launches == 0
    assert banded_maxpool_backward_dyn_fused.launches == banded_maxpool_backward_tau_fused.launches == 0
