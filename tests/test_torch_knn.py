"""The k-NN (tau) ops of the port against the JAX package: the threshold
producer (kernel #5's plain version), the k-NN window starts, and the
tau aggregation and maxpool (#6-#8's plain versions) with per-layer
rotated and jittered kernel points.

Bit-equality of tau needs the same d2 bits on both sides.  Inside a jitted
fusion XLA's CPU backend contracts ``d2 + diff * diff`` into fused
multiply-adds; the port and its CUDA kernels round every op as written
(no FMA, as the JAX package's elementwise ops do when run one at a time).
So the float clouds go through the JAX functions op by op
(``jax.disable_jit``), and the comparisons against the jitted functions and
the Pallas kernel (interpret mode) use clouds on a 1/8 grid, whose d2 are
exact in fp32 under any arithmetic, with many exact distance ties.
Tolerances: tau, starts, counts and maxpool exact; aggregation fp32
rel 1e-5 against the XLA twin and 1e-4 against the Pallas kernel
(rms-floored).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.ops import banded as jb
from cofii2p_tpu.ops.kpconv_kernel import banded_kpconv_aggregate_tau_pallas, banded_kpconv_fused_tau_pallas
from cofii2p_tpu.ops.maxpool_kernel import banded_maxpool_tau_pallas
from cofii2p_tpu.ops.tau_kernel import banded_knn_tau_pallas
from cofii2p_tpu_torch.ops import banded as tb
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    banded_kpconv_aggregate_tau,
    banded_kpconv_aggregate_tau_plain,
    banded_kpconv_fused_tau,
    banded_kpconv_fused_tau_plain,
)
from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_tau, banded_maxpool_tau_plain
from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_kernel
from cofii2p_tpu_torch.utils.convert import jittered_kernel_points
from tests.torch_parity import lidar_cloud, ordered, rel_err

R, S = 1.7, 0.8  # the level-2 radius and sigma of the KITTI FPN
FULL = 1 << 20  # a band width past any level: one band of the whole level


def clouds(m, n, seed, grid=False, dup=9):
    """Two Morton-ordered frames; every ``dup``-th support row repeats its
    predecessor, as resample_fixed pads a cloud, so k-th and (k+1)-th
    distances tie.  ``grid``: coordinates on a 1/8 grid (exact d2)."""
    rng = np.random.default_rng(seed)
    s_pts = []
    for _ in range(2):
        s = lidar_cloud(n, rng, extent=12.0)
        if grid:
            s = np.round(s * 8) / 8
        s[1::dup] = s[0::dup][: len(s[1::dup])]
        s_pts.append(ordered(s.astype(np.float32)))
    s_pts = np.stack(s_pts)
    q_pts = s_pts if m == n else np.stack([ordered(s[rng.choice(n, m, replace=False)]) for s in s_pts])
    return q_pts, s_pts


def j_tau(q, s, k, bw, starts=None):
    """The JAX plain version, vmapped over frames like the FPN's tau_for."""
    return np.asarray(jax.vmap(lambda a, b, st: jb.banded_knn_tau(a, b, k, 128, bw, starts=st))(
        jnp.asarray(q), jnp.asarray(s), None if starts is None else jnp.asarray(starts)))


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# (M, N, k, band width): several tiles with k < band; one tile covering the
# whole level (dense); k = band (no (k+1)-th row: the fallback); a band
# narrower than k
TAU_CASES = [(256, 512, 16, 64), (512, 512, 16, FULL), (128, 128, 128, 64), (256, 512, 32, 40), (256, 512, 96, 8)]


@pytest.mark.parametrize("m,n,k,bw", TAU_CASES)
def test_tau_bitequal_to_jax_op_by_op(m, n, k, bw):
    q, s = clouds(m, n, seed=m + k)
    with jax.disable_jit():
        want = j_tau(q, s, k, bw)
    got = tb.banded_knn_tau(torch.as_tensor(q), torch.as_tensor(s), k, 128, bw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("m,n,k,bw", TAU_CASES)
def test_tau_bitequal_to_jax_and_pallas_on_exact_d2(m, n, k, bw):
    q, s = clouds(m, n, seed=m + k, grid=True)
    got = tb.banded_knn_tau(torch.as_tensor(q), torch.as_tensor(s), k, 128, bw)
    np.testing.assert_array_equal(bits(got), bits(j_tau(q, s, k, bw)))
    if bw < n:  # the Pallas kernel takes the static multi-tile plan
        want = banded_knn_tau_pallas(jnp.asarray(q), jnp.asarray(s), k, 128, bw)
        np.testing.assert_array_equal(bits(got), bits(want))
    # the wrapper of kernel #5 takes the plain version on the CPU
    banded_knn_tau_kernel.launches = 0
    assert torch.equal(banded_knn_tau_kernel(torch.as_tensor(q), torch.as_tensor(s), k, 128, bw), got)
    assert banded_knn_tau_kernel.launches == 0


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("m,n,k,width,stride", [(256, 512, 16, 96, 2), (512, 512, 32, 128, 1), (256, 1024, 16, 160, 4)])
def test_knn_window_starts_and_windowed_tau(m, n, k, width, stride, grid):
    """The windowed-tau chain of knn_tau_starts: a proxy tau on every
    stride-th row, dynamic_knn_starts, then tau over each window."""
    q, s = clouds(m, n, seed=n + width, grid=grid)
    tq, ts = torch.as_tensor(q), torch.as_tensor(s)
    with jax.disable_jit():
        proxy = j_tau(q, s[:, ::stride], max(k // stride, 1), max(256 // stride, 32))
        want_st = np.asarray(jax.vmap(lambda a, b, t: jb.dynamic_knn_starts(a, b, t, 128, width, stride))(
            jnp.asarray(q), jnp.asarray(s), jnp.asarray(proxy)))
        want = j_tau(q, s, k, width, want_st)
    got_proxy = tb.banded_knn_tau(tq, ts[:, ::stride], max(k // stride, 1), 128, max(256 // stride, 32))
    np.testing.assert_array_equal(bits(got_proxy), bits(proxy))
    got_st = tb.dynamic_knn_starts(tq, ts, got_proxy, 128, width, stride)
    assert got_st.dtype == torch.int32
    np.testing.assert_array_equal(got_st.numpy(), want_st)
    got = tb.banded_knn_tau(tq, ts, k, 128, width, starts=got_st)
    np.testing.assert_array_equal(bits(got), bits(want))


def layer_kernel_points(radius, seed):
    """Kernel points as a reference layer carries them: the canonical
    disposition rotated and jittered (utils/convert.py)."""
    kp = torch.tensor(tb._load_kernel_points(radius, 15), dtype=torch.float32)
    return jittered_kernel_points(kp, torch.Generator().manual_seed(seed)).numpy()


def tau_inputs(m, n, c, k, bw, seed, cout=8):
    """Clouds, features of both signs (so the active-row count differs from
    the in-tau count), weights, tau over the static band and a layer's own
    kernel points."""
    q, s = clouds(m, n, seed)
    rng = np.random.default_rng(seed + 1)
    feats = rng.normal(size=(2, n, c)).astype(np.float32)
    feats[:, ::5] = np.abs(feats[:, ::5])
    w = (rng.normal(size=(15, c, cout)) / np.sqrt(c)).astype(np.float32)
    tau = tb.banded_knn_tau(torch.as_tensor(q), torch.as_tensor(s), k, 128, bw).numpy()
    return feats, q, s, w, tau, layer_kernel_points(R, seed)


@pytest.mark.parametrize("m,n,c,k,bw", [(256, 512, 8, 16, 64), (512, 512, 4, 32, 48), (128, 128, 16, 128, 64)])
def test_tau_aggregation_and_maxpool_match_jax_xla(m, n, c, k, bw):
    feats, q, s, w, tau, kp = tau_inputs(m, n, c, k, bw, seed=m + c)
    t = [torch.as_tensor(x) for x in (feats, q, s, tau, kp)]
    got_w, got_cnt = banded_kpconv_aggregate_tau_plain(t[0], t[1], t[2], t[3], t[4], R, S, 15, 128, bw)
    want_w, want_cnt = jax.vmap(lambda f, a, b, ta: jb.banded_kpconv_aggregate(
        f, a, b, R, S, 15, 128, bw, jnp.float32, tau=ta, kp=jnp.asarray(kp)))(
        jnp.asarray(feats), jnp.asarray(q), jnp.asarray(s), jnp.asarray(tau))
    assert got_cnt.dtype == torch.int32
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    # rows whose features sum to <= 0 are in tau but not counted
    all_active = banded_kpconv_aggregate_tau_plain(t[0].abs(), t[1], t[2], t[3], t[4], R, S, 15, 128, bw)[1]
    assert (got_cnt < all_active).any()
    assert rel_err(got_w, want_w) <= 1e-5
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax.vmap(lambda f_, a, b, ta: jb.banded_maxpool(f_, a, b, 0.0, 128, bw, tau=ta))(
            jnp.asarray(feats).astype(jdt), jnp.asarray(q), jnp.asarray(s), jnp.asarray(tau))
        got = banded_maxpool_tau_plain(t[0].to(tdt), t[1], t[2], t[3], 128, bw)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("m,n,c,k,bw", [(256, 512, 8, 16, 64), (512, 512, 16, 32, 48)])
def test_tau_kernels_plain_versions_match_pallas(m, n, c, k, bw):
    """#6, #7 and #8's plain versions (and their wrappers on the CPU)
    against the Pallas kernels in interpret mode.  The Pallas kernels take
    the influence from the fp32 matmul identity, which cancels near a
    kernel point; against the plain version's float64 influence that
    differs by 4e-5 to 1.2e-4 over seeds at these sizes, so the gate of
    1e-4 is held at a fixed seed whose error is 5e-5 to 7e-5."""
    feats, q, s, w, tau, kp = tau_inputs(m, n, c, k, bw, seed=3, cout=12)
    t = [torch.as_tensor(x) for x in (feats, q, s, w, tau, kp)]
    j = [jnp.asarray(x) for x in (feats, q, s, w, tau, kp)]
    want_w, want_cnt = banded_kpconv_aggregate_tau_pallas(j[0], j[1], j[2], j[4], j[5], R, S, 15, 128, bw, jnp.float32)
    want_o, want_cnt2 = banded_kpconv_fused_tau_pallas(j[0], j[1], j[2], j[3], j[4], j[5], R, S, 15, 128, bw,
                                                       jnp.float32)
    want_mp = banded_maxpool_tau_pallas(j[0], j[1], j[2], j[4], 128, bw)
    for fn in (banded_kpconv_aggregate_tau, banded_kpconv_fused_tau, banded_maxpool_tau):
        fn.launches = 0
    got_w, got_cnt = banded_kpconv_aggregate_tau(t[0], t[1], t[2], t[4], t[5], R, S, 15, 128, bw)
    got_o, got_cnt2 = banded_kpconv_fused_tau(t[0], t[1], t[2], t[3], t[4], t[5], R, S, 15, 128, bw)
    got_mp = banded_maxpool_tau(t[0], t[1], t[2], t[4], 128, bw)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_cnt2.numpy(), np.asarray(want_cnt2))
    assert rel_err(got_w, want_w) <= 1e-4
    assert rel_err(got_o, want_o) <= 1e-4
    np.testing.assert_array_equal(got_mp.numpy(), np.asarray(want_mp))
    ref_o, _ = banded_kpconv_fused_tau_plain(t[0], t[1], t[2], t[3], t[4], t[5], R, S, 15, 128, bw)
    assert torch.equal(got_o, ref_o)
    assert banded_kpconv_aggregate_tau.launches == banded_kpconv_fused_tau.launches == banded_maxpool_tau.launches == 0
