"""The intensity-only path (nuScenes, ``has_normals=False``) of the port
against the JAX package's, TinyConfig, fp32; the port's counterpart of
tests/test_nuscenes_shapes.py.

The frames are real loader output: NuScenesDataset on a fixture tree in
the builder's layout (cofii2p_tpu_torch/data/fixtures.py), so the
features are intensity + perturbed xyz (reference nuscenes.py:207-213).
Same weights on both sides (a JAX init, norms perturbed), JAX's random
draws replayed into the port.  Tolerances as tests/test_torch_pipeline.py
and tests/test_torch_train.py state them: sample prep's training fields
equal and its features within 1e-6; the eval outputs through
make_eval_body as torch_parity.assert_eval_outputs_match holds them; one
train step's losses 1e-4 and every parameter gradient 1e-3 as
rms(difference) / rms(gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu import train_lib as jtl
from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare
from cofii2p_tpu.evaluation.pipeline import make_eval_body as j_make_eval_body
from cofii2p_tpu_torch import train_lib
from cofii2p_tpu_torch.data.fixtures import write_nuscenes_tree
from cofii2p_tpu_torch.data.loader import _collate
from cofii2p_tpu_torch.data.nuscenes import NuScenesDataset
from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
from cofii2p_tpu_torch.models.kpconv import norm_cancelled_biases
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params
from tests.torch_parity import (
    assert_eval_outputs_match, cfg_pair, jax_test_mode, jax_variables, rel_err, replay_draws, replay_train_draws,
    to_torch,
)
from tests.test_torch_train import TRAIN_FIELDS

B, STEP = 2, 1


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = write_nuscenes_tree(str(tmp_path_factory.mktemp("nuscenes")), 6, {"train": B, "test": B}, points=2000)
    jcfg, tcfg = cfg_pair("TinyConfig", data_path=root)
    ds = NuScenesDataset(tcfg, "train")
    hb = _collate([ds[i] for i in range(B)])
    hb.pop("index")
    assert hb["attrs"].shape == (B, tcfg.num_pc, 1)
    jmodel, params, stats = jax_variables(jcfg, hb, seed=3, has_normals=False)
    return jcfg, tcfg, hb, jmodel, params, stats


def test_prepare_samples_without_normals(setup):
    jcfg, tcfg, hb, _, _, _ = setup
    rng = jax.random.PRNGKey(4)
    prep_rng, _ = jax.random.split(jax.random.fold_in(rng, STEP))
    want = j_prepare(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), prep_rng, jnp.asarray(hb["img"]),
                     jcfg, has_normals=False)
    got = train_lib.prepare_batch(tcfg, to_torch(hb), replay_train_draws(jcfg, rng, STEP, B), has_normals=False)
    assert got["feats"].shape == (B, tcfg.num_pc, 4)  # intensity + perturbed xyz
    np.testing.assert_allclose(got["feats"].numpy(), np.asarray(want["feats"]), rtol=1e-6, atol=1e-6)
    for lvl, (p, q) in enumerate(zip(got["points"], want["points"])):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=1e-6, atol=1e-6, err_msg=f"points {lvl}")
    for key in TRAIN_FIELDS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_eval_forward_without_normals_matches_jax(setup):
    jcfg, tcfg, hb, jmodel, params, stats = setup
    rng = jax.random.PRNGKey(9)
    jhb = {k: jnp.asarray(v) for k, v in hb.items()}
    want = jax.jit(j_make_eval_body(jcfg, jmodel, has_normals=False))(params, stats, jhb, rng)
    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats).eval()
    got = make_eval_body(tcfg, tmodel, has_normals=False)(to_torch(hb), draws=replay_draws(jcfg, rng, B))
    jout = jax_test_mode(jcfg, jmodel, params, stats, jhb, rng, has_normals=False)
    assert_eval_outputs_match(jcfg, jout, want, got, B)


def test_train_step_without_normals_matches_jax(setup):
    jcfg, tcfg, hb, jmodel, params, stats = setup
    rng = jax.random.PRNGKey(11)
    prep_rng, _ = jax.random.split(jax.random.fold_in(rng, STEP))
    jbatch = j_prepare(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), prep_rng, jnp.asarray(hb["img"]),
                       jcfg, has_normals=False)

    def loss_fn(p):  # cofii2p_tpu/train_lib.py:134-143
        out, mut = jmodel.apply({"params": p, "batch_stats": stats}, jbatch, mode="train", train=True,
                                mutable=["batch_stats"])
        terms = jtl.batch_losses(jcfg, out, jbatch)
        return terms["loss"], terms

    (_, want_terms), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref = jax_to_state_dict(jax.device_get(want_grads), {})

    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats)
    tbatch = train_lib.prepare_batch(tcfg, to_torch(hb), replay_train_draws(jcfg, rng, STEP, B), has_normals=False)
    terms = train_lib.loss_fn(tcfg, tmodel, tbatch)
    terms["loss"].backward()
    for key in ("loss", "loss_desc", "loss_coarse", "loss_fine"):
        assert rel_err(terms[key], np.asarray(want_terms[key])) <= 1e-4, key

    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in tmodel.named_parameters()}
    cancelled = set(norm_cancelled_biases(tmodel))
    rms_all = float(torch.cat([ref[n].flatten() for n in grads]).pow(2).mean().sqrt())
    worst = {}
    for name, g in grads.items():
        r = ref[name].double()
        scale = rms_all if name in cancelled else float(r.pow(2).mean().sqrt())
        worst[name] = float((g.double() - r).pow(2).mean().sqrt()) / max(scale, 1e-30)
    bad = {k: v for k, v in worst.items() if v > 1e-3}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    assert max(float(ref[n].abs().max()) for n in ref if n.startswith("pc_encoder")) > 0
