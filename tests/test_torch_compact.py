"""The compacted top-k formulations (ops/banded.py: banded_knn_select,
banded_compact_maxpool, banded_compact_aggregate) and band_coverage
against the JAX package's, on the same numpy clouds with duplicated
points (so k-th distances and maxima tie): the selection equal, the
maxpool bit-equal, the aggregate within 1e-5 rel (rms-floored) with
counts equal, bf16 within 5e-2, gradients within 1e-5 of ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.ops import banded as jb
from cofii2p_tpu_torch.ops import banded as tb
from tests.torch_parity import lidar_cloud, ordered_idx, rel_err

B, M, N, C = 2, 256, 512, 8
TILE, BW = 128, 64  # band = 256 + 2 * 64 = 384 of 512 rows: three distinct bands
R, S = 4.0, 2.0  # reach ~ 8.8 m against ~3.5 m spacing: in-reach counts on both sides of K_RADIUS
K_RADIUS, K_KNN = 16, 12


def _dup_cloud(seed):
    """A Morton-ordered cloud in which every eighth row repeats another,
    features that repeat with it (so duplicated points tie in distance and
    in feature value), a query level of M of its rows, and each row's
    source row."""
    rng = np.random.default_rng(seed)
    base = lidar_cloud(N, rng, extent=20.0)
    src = np.arange(N)
    src[::8] = rng.integers(0, N, N // 8)
    order = ordered_idx(base[src])
    src = src[order]
    feats = rng.normal(size=(N, C)).astype(np.float32)[src]
    queries = base[src][np.sort(rng.choice(N, M, replace=False))]
    return queries, base[src], feats, src


@pytest.fixture(scope="module")
def clouds():
    qs, ss, fs, srcs = zip(*(_dup_cloud(s) for s in range(B)))
    return np.stack(qs), np.stack(ss), np.stack(fs), np.stack(srcs)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _jvmap(fn, *xs):
    return jax.vmap(fn)(*(jnp.asarray(x) for x in xs))


def test_clouds_tie_and_cap(clouds):
    """The inputs exercise what the tests claim: tied distances, queries
    both under and over the radius cap."""
    q, s, *_ = clouds
    counts = tb.banded_pair_count(_t(q), _t(s), tb.kernel_reach(R, S), TILE, BW)
    assert (counts <= K_RADIUS).any() and (counts > K_RADIUS).any()
    d2 = tb._membership_d2(_t(q)[:, :TILE], _t(s))
    sorted_d2 = torch.sort(d2, dim=-1).values
    assert (sorted_d2[..., 1:] == sorted_d2[..., :-1]).any()


@pytest.mark.parametrize("k", [K_KNN, 1000])
def test_knn_select_matches_jax(clouds, k):
    q, s, *_ = clouds
    want = _jvmap(lambda a, b: jb.banded_knn_select(a, b, k, TILE, BW), q, s)
    got = tb.banded_knn_select(_t(q), _t(s), k, TILE, BW)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # approx selects exactly
    np.testing.assert_array_equal(tb.banded_knn_select(_t(q), _t(s), k, TILE, BW, approx=True).numpy(),
                                  got.numpy())


def _rel(q, s, knn):
    k = K_KNN if knn else K_RADIUS
    return _jvmap(lambda a, b: jb.banded_knn_select(a, b, k, TILE, BW), q, s)


@pytest.mark.parametrize("knn", [False, True], ids=["radius", "knn"])
@pytest.mark.parametrize("with_rel", [False, True], ids=["select", "rel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_maxpool_matches_jax(clouds, knn, with_rel, dtype):
    q, s, f, _ = clouds
    k = K_KNN if knn else K_RADIUS
    r_active = 0.0 if knn else jb.kernel_reach(R, S)
    rel = _rel(q, s, knn) if with_rel else None
    jf = jnp.asarray(f, dtype)
    if with_rel:
        want = jax.vmap(lambda a, b, c, r: jb.banded_compact_maxpool(a, b, c, r_active, k, TILE, BW, knn=knn, rel=r))(
            jf, jnp.asarray(q), jnp.asarray(s), rel)
    else:
        want = jax.vmap(lambda a, b, c: jb.banded_compact_maxpool(a, b, c, r_active, k, TILE, BW, knn=knn))(
            jf, jnp.asarray(q), jnp.asarray(s))
    tf = _t(f).to(getattr(torch, dtype))
    got = tb.banded_compact_maxpool(tf, _t(q), _t(s), r_active, k, TILE, BW, knn=knn,
                                    rel=None if rel is None else _t(rel))
    assert got.dtype == tf.dtype and got.shape == (B, M, C)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_compact_maxpool_is_the_banded_maxpool_under_the_cap(clouds):
    """Radius mode equals the full-band maxpool on every query whose
    in-reach count is <= k (the gate the card's check holds kernel #3 to)."""
    q, s, f, _ = clouds
    r_active = tb.kernel_reach(R, S)
    got = tb.banded_compact_maxpool(_t(f), _t(q), _t(s), r_active, K_RADIUS, TILE, BW)
    full = tb.banded_maxpool(_t(f), _t(q), _t(s), r_active, TILE, BW)
    under = tb.banded_pair_count(_t(q), _t(s), r_active, TILE, BW) <= K_RADIUS
    assert under.any() and not under.all()
    assert torch.equal(got[under], full[under])
    assert not torch.equal(got[~under], full[~under])


def _j_aggregate(f, q, s, knn, rel, kp, dtype):
    k = K_KNN if knn else K_RADIUS
    fn = lambda a, b, c, *r: jb.banded_compact_aggregate(  # noqa: E731
        a, b, c, R, S, 15, k, TILE, BW, dtype, knn=knn, kp=kp, rel=r[0] if r else None)
    args = (jnp.asarray(f), jnp.asarray(q), jnp.asarray(s)) + (() if rel is None else (rel,))
    return jax.vmap(fn)(*args)


@pytest.mark.parametrize("knn", [False, True], ids=["radius", "knn"])
@pytest.mark.parametrize("with_rel", [False, True], ids=["select", "rel"])
def test_compact_aggregate_matches_jax(clouds, knn, with_rel):
    q, s, f, _ = clouds
    rel = _rel(q, s, knn) if with_rel else None
    kp = tb._load_kernel_points(R, 15) * 1.02 if knn else None  # a layer's own kernel points
    want_w, want_c = _j_aggregate(f, q, s, knn, rel, None if kp is None else jnp.asarray(kp, jnp.float32),
                                  jnp.float32)
    got_w, got_c = tb.banded_compact_aggregate(
        _t(f), _t(q), _t(s), R, S, 15, K_KNN if knn else K_RADIUS, TILE, BW, knn=knn,
        kp=None if kp is None else torch.as_tensor(kp, dtype=torch.float32), rel=None if rel is None else _t(rel))
    assert got_w.dtype == torch.float32 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert rel_err(got_w, want_w) <= 1e-5


@pytest.mark.parametrize("knn", [False, True], ids=["radius", "knn"])
def test_compact_aggregate_bf16_matches_jax(clouds, knn):
    """bf16 operands, fp32 products and output, as JAX's
    preferred_element_type=float32 contraction: within 5e-2 of JAX's bf16
    result, counts equal."""
    q, s, f, _ = clouds
    want_w, want_c = _j_aggregate(f, q, s, knn, None, None, jnp.bfloat16)
    got_w, got_c = tb.banded_compact_aggregate(_t(f), _t(q), _t(s), R, S, 15, K_KNN if knn else K_RADIUS, TILE,
                                               BW, torch.bfloat16, knn=knn)
    assert got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert rel_err(got_w, want_w) <= 5e-2


def test_compact_aggregate_is_the_banded_aggregate_under_the_cap(clouds):
    q, s, f, _ = clouds
    got_w, got_c = tb.banded_compact_aggregate(_t(f), _t(q), _t(s), R, S, 15, K_RADIUS, TILE, BW)
    full_w, full_c = tb.banded_kpconv_aggregate(_t(f), _t(q), _t(s), R, S, 15, TILE, BW)
    assert torch.equal(got_c, full_c)
    under = full_c <= K_RADIUS
    assert rel_err(got_w[under], full_w[under]) <= 1e-5


@pytest.mark.parametrize("knn", [False, True], ids=["radius", "knn"])
def test_compact_maxpool_gradient_matches_jax(clouds, knn):
    """The max's gradient splits evenly among tied maxima (duplicated
    points carry equal features), as jax.grad of jnp.max does."""
    q, s, f, _ = clouds
    k = K_KNN if knn else K_RADIUS
    r_active = 0.0 if knn else jb.kernel_reach(R, S)
    g = np.random.default_rng(5).normal(size=(B, M, C)).astype(np.float32)

    def jloss(ff):
        out = jax.vmap(lambda a, b, c: jb.banded_compact_maxpool(a, b, c, r_active, k, TILE, BW, knn=knn))(
            ff, jnp.asarray(q), jnp.asarray(s))
        return jnp.sum(out * g)

    want = jax.grad(jloss)(jnp.asarray(f))
    tf = _t(f).clone().requires_grad_(True)
    (tb.banded_compact_maxpool(tf, _t(q), _t(s), r_active, k, TILE, BW, knn=knn) * _t(g)).sum().backward()
    assert rel_err(tf.grad, want) <= 1e-5
    # ties occurred: two copies of one point received equal nonzero shares
    want = np.asarray(want)
    src = clouds[3]
    split = [(want[b, i] == want[b, j]) & (want[b, i] != 0) for b in range(B) for i in range(N) for j in range(i)
             if src[b, i] == src[b, j]]
    assert np.any(split)


@pytest.mark.parametrize("knn", [False, True], ids=["radius", "knn"])
def test_compact_aggregate_gradient_matches_jax(clouds, knn):
    q, s, f, _ = clouds
    g = np.random.default_rng(6).normal(size=(B, M, 15, C)).astype(np.float32)

    def jloss(ff):
        w, _ = _j_aggregate(ff, q, s, knn, None, None, jnp.float32)
        return jnp.sum(w * g)

    want = jax.grad(jloss)(jnp.asarray(f))
    tf = _t(f).clone().requires_grad_(True)
    w, _ = tb.banded_compact_aggregate(tf, _t(q), _t(s), R, S, 15, K_KNN if knn else K_RADIUS, TILE, BW, knn=knn)
    (w * _t(g)).sum().backward()
    assert rel_err(tf.grad, want) <= 1e-5


def test_checkpointed_chunks_keep_the_gradient(clouds, monkeypatch):
    """With one tile a chunk, the chunks' recomputed backward gives the
    same gradient as one chunk."""
    q, s, f, _ = clouds
    grads = []
    for elems in (tb._CHUNK_ELEMS, 1):
        monkeypatch.setattr(tb, "_CHUNK_ELEMS", elems)
        tf = _t(f).clone().requires_grad_(True)
        w, _ = tb.banded_compact_aggregate(tf, _t(q), _t(s), R, S, 15, K_RADIUS, TILE, BW)
        out = tb.banded_compact_maxpool(tf, _t(q), _t(s), tb.kernel_reach(R, S), K_RADIUS, TILE, BW)
        (w.sum() + out.sum()).backward()
        grads.append(tf.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("bw", [BW, 1 << 20])
def test_band_coverage_matches_jax(clouds, bw):
    q, s, *_ = clouds
    want = jb.band_coverage(q[0], s[0], R, S, 15, TILE, bw)
    got = tb.band_coverage(q[0], s[0], R, S, 15, TILE, bw)
    assert got == want
