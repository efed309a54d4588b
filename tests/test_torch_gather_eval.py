"""make_eval_body under ``kpconv_impl='gather'`` with per-layer kernel
points (a reference checkpoint's configuration) against the JAX
package's, JAX's draws replayed, at the tolerances of
tests/test_torch_pipeline.py."""

import jax
import jax.numpy as jnp

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
    per_layer_kernel_points,
    replay_draws,
    to_torch,
)


def test_eval_pipeline_gather_matches_jax():
    """make_eval_body under gather with per-layer kernel points (a
    reference checkpoint's configuration) against JAX's, JAX's draws
    replayed, as tests/test_torch_pipeline.py compares the banded path."""
    jcfg, tcfg = cfg_pair("TinyConfig", kpconv_impl="gather", kpconv_shared_influence=False)
    b = 2
    hb = host_batch(jcfg, b, start=4)
    jmodel, params, stats = jax_variables(jcfg, hb, seed=1)
    params = per_layer_kernel_points(params)
    rng = jax.random.PRNGKey(7)
    jhb = {k: jnp.asarray(v) for k, v in hb.items()}
    want = jax.jit(j_make_eval_body(jcfg, jmodel))(params, stats, jhb, rng)
    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats).eval()
    got = make_eval_body(tcfg, tmodel)(to_torch(hb), draws=replay_draws(jcfg, rng, b))
    assert_eval_outputs_match(jcfg, jax_test_mode(jcfg, jmodel, params, stats, jhb, rng), want, got, b)


def test_eval_all_and_train_take_kpconv_impl_gather(tmp_path, monkeypatch):
    """``eval_all <ref.t7> ... kpconv_impl=gather`` keeps the override
    through reference_ckpt_config, and the FPN receives the batch's k-NN
    maps; ``train ... kpconv_impl=gather`` takes a step and saves."""
    from cofii2p_tpu_torch import train
    from cofii2p_tpu_torch.evaluation import eval_all
    from cofii2p_tpu_torch.utils.checkpoint import export_t7, latest_checkpoint

    path = str(tmp_path / "ref.t7")
    export_t7(CoFiI2P(cfg_pair("TinyConfig")[1]), path)
    seen, maps = [], []

    def recording_model(cfg):
        model = CoFiI2P(cfg)
        model.pc_encoder.register_forward_pre_hook(lambda mod, args: maps.append([len(a) for a in args[2:]]))
        seen.append(cfg)
        return model

    monkeypatch.setattr(eval_all, "CoFiI2P", recording_model)
    monkeypatch.chdir(tmp_path)
    r, t = eval_all.main([path, "tiny", "--synthetic", "--synthetic_frames", "2", "--batch_size", "2", "--device",
                          "cpu", "--eval_path", "res", "kpconv_impl=gather"])
    assert r.shape == t.shape
    assert seen[0].kpconv_impl == "gather" and not seen[0].kpconv_shared_influence
    assert maps == [[5, 4, 4]]
    save_dir = train.main(["tiny", "--synthetic", "--synthetic_frames", "4", "--batch_size", "2", "--device", "cpu",
                           f"root_path={tmp_path}", "num_workers=2", "kpconv_impl=gather", "--steps", "1"])
    assert latest_checkpoint(save_dir).endswith("step_00000001.pt")
