"""The port's training losses against the JAX package's (cofii2p_tpu/losses.py):
values and gradients on the same numpy inputs, fp32, within 1e-5
(relative, rms-floored)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu import losses as jl
from cofii2p_tpu_torch import losses as tl
from tests.torch_parity import rel_err

TOL = 1e-5


def unit(x, axis):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_desc_loss(seed):
    rng = np.random.default_rng(seed)
    b, c, k = 2, 16, 8
    img = unit(rng.normal(size=(b, c, k)), 1).astype(np.float32)
    pc = unit(rng.normal(size=(b, c, k)), 1).astype(np.float32)
    mask = (rng.uniform(size=(b, k, k)) < 0.2).astype(np.float32)

    def j_loss(i, p):
        loss, dists = jax.vmap(lambda a, bb, m: jl.desc_loss(a, bb, m, 0.2, 1.8))(i, p, jnp.asarray(mask))
        return jnp.mean(loss), dists

    (want, want_d), (gi, gp) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(img), jnp.asarray(pc))
    ti = torch.as_tensor(img).requires_grad_()
    tp = torch.as_tensor(pc).requires_grad_()
    loss, dists = tl.desc_loss(ti, tp, torch.as_tensor(mask), 0.2, 1.8)
    assert loss.shape == (b,)
    loss.mean().backward()
    assert rel_err(loss.mean(), want) <= TOL
    assert rel_err(dists, want_d) <= TOL
    assert rel_err(ti.grad, gi) <= TOL
    assert rel_err(tp.grad, gp) <= TOL


def test_overlap_loss():
    rng = np.random.default_rng(2)
    inl = rng.uniform(0, 1, (2, 8)).astype(np.float32)
    out = rng.uniform(0, 1, (2, 8)).astype(np.float32)
    inl[0, 0], out[1, 1] = 0.0, 1.0  # clipped at eps
    want, (gi, go) = jax.value_and_grad(jl.overlap_loss, argnums=(0, 1))(jnp.asarray(inl), jnp.asarray(out))
    ti, to = torch.as_tensor(inl).requires_grad_(), torch.as_tensor(out).requires_grad_()
    loss = tl.overlap_loss(ti, to)
    loss.backward()
    assert rel_err(loss, want) <= TOL
    assert rel_err(ti.grad, gi) <= TOL
    assert rel_err(to.grad, go) <= TOL


def test_fine_circle_loss():
    rng = np.random.default_rng(3)
    patch = rng.normal(size=(2, 8, 4, 4, 16)).astype(np.float32)
    feat = rng.normal(size=(2, 8, 16)).astype(np.float32)
    rel = rng.integers(0, 16, (2, 8)).astype(np.int32)
    want, (gpatch, gfeat) = jax.value_and_grad(
        lambda p, f: jl.fine_circle_loss(p, f, jnp.asarray(rel)), argnums=(0, 1)
    )(jnp.asarray(patch), jnp.asarray(feat))
    tp, tf = torch.as_tensor(patch).requires_grad_(), torch.as_tensor(feat).requires_grad_()
    loss = tl.fine_circle_loss(tp, tf, torch.as_tensor(rel))
    loss.backward()
    assert rel_err(loss, want) <= TOL
    assert rel_err(tp.grad, gpatch) <= TOL
    assert rel_err(tf.grad, gfeat) <= TOL
