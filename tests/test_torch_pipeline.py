"""The whole serving slice: the JAX package's make_eval_body against the
port's, EvalOutput field by field, with the port fed JAX's own random
draws (pyramid permutations, RANSAC noise) replayed from the key splits.

TinyConfig with dynamic windows on the deep levels and the fused attention
on both sides, fp32.  Continuous fields agree to 1e-3 (relative,
rms-floored); discrete fields must be equal wherever the JAX side's
decision has a margin above 1e-5 (the coarse and fine top-2 gaps and the
score-to-threshold gaps), and whole-frame results (pose, inlier count,
success) wherever no superpoint of the frame sits inside such a margin.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from cofii2p_tpu.evaluation.pipeline import make_eval_body as j_make_eval_body
from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.convert import load_jax_params
from tests.torch_parity import (
    assert_eval_outputs_match,
    cfg_pair,
    host_batch,
    jax_test_mode,
    jax_variables,
    replay_draws,
    to_torch,
)

DYN = dict(kpconv_dynamic_plan=(0, 64, 64, 64, 0), kpconv_dynamic_plan_self=(0, 0, 64, 64, 0))


@pytest.mark.parametrize("residual_fused", [False, True])
def test_eval_pipeline_matches_jax(residual_fused):
    """With kpconv_residual_fused the JAX side runs kpconv_kernel='pallas'
    (interpret mode), since under 'auto' off the TPU it never reaches its
    fused pass (models/kpconv.py:550-553); the port's four strided blocks
    take banded_residual_fused (its plain version on the CPU)."""
    extra = dict(kpconv_residual_fused=True, kpconv_kernel="pallas") if residual_fused else {}
    jcfg, tcfg = cfg_pair("TinyConfig", attention="pallas", **DYN, **extra)
    b = 2
    hb = host_batch(jcfg, b, start=4)
    jmodel, params, stats = jax_variables(jcfg, hb, seed=1)
    rng = jax.random.PRNGKey(7)
    jhb = {k: jnp.asarray(v) for k, v in hb.items()}
    want = jax.jit(j_make_eval_body(jcfg, jmodel))(params, stats, jhb, rng)

    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats).eval()
    got = make_eval_body(tcfg, tmodel)(to_torch(hb), draws=replay_draws(jcfg, rng, b))

    assert_eval_outputs_match(jcfg, jax_test_mode(jcfg, jmodel, params, stats, jhb, rng), want, got, b)
    assert torch.is_tensor(got.R) and got.R.dtype == torch.float32
