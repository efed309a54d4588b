"""The port's training slice against the JAX package's, TinyConfig, fp32.

Same numpy frames and weights on both sides (weights from a JAX
``model.init`` through utils/convert.py, norm scales and BatchNorm
statistics perturbed), and JAX's own random draws replayed into the port
(tests/torch_parity.py::replay_train_draws).  On the CPU the port's
autograd Functions run the kernels' plain versions.  The one-step parity
runs three configurations: the static bands; dynamic windows narrower than
their levels (``kpconv_dynamic_plan``; ``--fast``'s w256 plan turns every
TinyConfig entry into the static band, so it would test nothing here);
and the k-NN semantics (``kpconv_impl='banded_knn'``) with every KPConv's
kernel points rotated and jittered, as a reference checkpoint has them.

Tolerances: the training fields of sample prep exactly equal; one train
step's losses 1e-4 (relative, rms-floored) and every parameter gradient
1e-3 as rms(difference) / rms(gradient) (the biases a one-channel group
norm cancels, whose gradient is zero in exact arithmetic, are divided by
the rms of the whole gradient).  Element-wise the gradients are not
gated: the two fp32 forwards differ by ~1e-6, which flips a few
leaky-ReLU, ReLU and max-pool choices, and each flip moves single gradient
elements by up to ~1e-2 of their tensor.  New BatchNorm running
statistics 1e-4; Adam against optax 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cofii2p_tpu import train_lib as jtl
from cofii2p_tpu.data.device_pipeline import masked_choice as j_masked_choice
from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare
from cofii2p_tpu_torch import train_lib
from cofii2p_tpu_torch.data.device_pipeline import masked_choice
from cofii2p_tpu_torch.models.kpconv import norm_cancelled_biases
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.ops.banded import banded_pair_count, kernel_reach
from cofii2p_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params
from tests.torch_parity import (
    cfg_pair, config_fields, host_batch, jax_variables, per_layer_kernel_points, rel_err, replay_prep_draws,
    replay_train_draws, to_torch,
)

STEP, B = 3, 2
# the one-step parity's configurations (TinyConfig overrides)
CASES = {
    "static": {},
    "windows": dict(kpconv_dynamic_plan=(0, 128, 64, 32, 0)),
    "knn": dict(kpconv_impl="banded_knn", kpconv_shared_influence=False),
}
TRAIN_FIELDS = ("pc_kpt_idx", "kpt_valid", "pc_outline_idx", "coarse_img_mask", "coarse_img_kpt_idx",
                "coarse_img_outline_index", "fine_xy_coors", "fine_center_kpt_coors", "relative_index",
                "fine_pc_inline_index")


_SETUPS = {}


def _setup(case):
    if case in _SETUPS:
        return _SETUPS[case]
    jcfg, tcfg = cfg_pair("TinyConfig", **CASES[case])
    hb = host_batch(jcfg, B, start=2)
    jmodel, params, stats = jax_variables(jcfg, hb, seed=2)
    if case == "knn":
        params = per_layer_kernel_points(params)
    rng = jax.random.PRNGKey(11)
    prep_rng, _ = jax.random.split(jax.random.fold_in(rng, STEP))
    jbatch = j_prepare(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), prep_rng,
                       jnp.asarray(hb["img"]), jcfg)

    def loss_fn(p):  # train_lib.py:134-143
        out, mut = jmodel.apply({"params": p, "batch_stats": stats}, jbatch, mode="train", train=True,
                                mutable=["batch_stats"])
        terms = jtl.batch_losses(jcfg, out, jbatch)
        return terms["loss"], (mut["batch_stats"], terms)

    (_, (new_stats, terms)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = {
        "terms": {k: np.asarray(terms[k]) for k in ("loss", "loss_desc", "loss_coarse", "loss_fine")},
        "grads": jax_to_state_dict(jax.device_get(grads), {}),
        "stats": jax_to_state_dict(params, jax.device_get(new_stats)),
    }
    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats)
    tbatch = train_lib.prepare_batch(tcfg, to_torch(hb), replay_train_draws(jcfg, rng, STEP, B))
    _SETUPS[case] = jcfg, tcfg, hb, jmodel, params, stats, jbatch, want, tmodel, tbatch
    return _SETUPS[case]


@pytest.fixture(scope="module", params=sorted(CASES))
def setup(request):
    """One JAX train step per configuration, compiled once for the module."""
    return _setup(request.param)


@pytest.fixture(scope="module")
def static_setup():
    return _setup("static")


def test_prepare_samples_training_fields(static_setup):
    _, _, _, _, _, _, jbatch, _, _, tbatch = static_setup
    for key in TRAIN_FIELDS:
        np.testing.assert_array_equal(tbatch[key].numpy(), np.asarray(jbatch[key]), err_msg=key)
    np.testing.assert_allclose(tbatch["K_4"].numpy(), np.asarray(jbatch["K_4"]), rtol=1e-6)
    assert tbatch["kpt_valid"].any() and not tbatch["kpt_valid"].all()  # both branches of the draw


def test_masked_choice_takes_ties_lowest_index_first():
    """Few valid entries: the tail is drawn from the masked ones, which all
    round to the same score; the order must be lax.top_k's."""
    rng = jax.random.PRNGKey(0)
    mask = np.zeros(40, bool)
    mask[[3, 17, 29]] = True
    want_idx, want_valid = j_masked_choice(rng, jnp.asarray(mask), 8)
    g = torch.as_tensor(np.asarray(jax.random.gumbel(rng, mask.shape)))
    idx, valid = masked_choice(g, torch.as_tensor(mask), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


@pytest.fixture(scope="module")
def step_result(setup):
    _, tcfg, _, _, _, _, _, _, tmodel, tbatch = setup
    terms = train_lib.loss_fn(tcfg, tmodel, tbatch)
    terms["loss"].backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in tmodel.named_parameters()}
    return terms, grads


def test_train_step_losses(setup, step_result):
    want = setup[7]
    terms, _ = step_result
    for key, value in want["terms"].items():
        assert rel_err(terms[key], value) <= 1e-4, key


def test_train_step_gradients(setup, step_result):
    want, tmodel = setup[7], setup[8]
    _, grads = step_result
    ref = {n: want["grads"][n] for n in grads}
    assert all(float(g.abs().max()) == 0.0 for n, g in want["grads"].items() if n.endswith("kernel_points"))
    assert not any(n.endswith("kernel_points") for n in grads)  # a frozen buffer in the port
    cancelled = set(norm_cancelled_biases(tmodel))
    assert len(cancelled) == 4
    rms_all = float(torch.cat([r.flatten() for r in ref.values()]).pow(2).mean().sqrt())
    worst = {}
    for name, g in grads.items():
        r = ref[name].double()
        scale = rms_all if name in cancelled else float(r.pow(2).mean().sqrt())
        # a tensor the losses do not reach has zero gradient on both sides
        worst[name] = float((g.double() - r).pow(2).mean().sqrt()) / max(scale, 1e-30)
    bad = {k: v for k, v in worst.items() if v > 1e-3}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    # every subsystem received a real gradient
    for sub in ("img_encoder", "pc_encoder", "transformer", "pc_score_layer", "img_upsample_1", "pc_feature_layer"):
        assert max(float(ref[n].abs().max()) for n in ref if n.startswith(sub)) > 0, sub


def test_train_step_batchnorm_statistics(setup, step_result):
    want, tmodel = setup[7], setup[8]
    sd = tmodel.state_dict()
    keys = [k for k in want["stats"] if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 24
    for k in keys:
        assert rel_err(sd[k], want["stats"][k]) <= 1e-4, k


def test_eval_step_matches_jax(static_setup):
    jcfg, tcfg, hb, jmodel, params, stats, _, _, _, _ = static_setup
    rng = jax.random.PRNGKey(5)
    state = jtl.TrainState(params, stats, None, jnp.asarray(0, jnp.int32))
    want = jax.device_get(jtl.make_eval_step(jcfg, jmodel)(state, {k: jnp.asarray(v) for k, v in hb.items()}, rng))
    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats)
    got = train_lib.make_eval_step(tcfg, tmodel)(to_torch(hb), replay_prep_draws(jcfg, rng, B))
    assert set(got) == set(want)
    assert rel_err(got["val_loss"], want["val_loss"]) <= 1e-4
    for key in want:
        if key != "val_loss":
            assert abs(float(got[key]) - float(want[key])) <= 1e-6, key


def test_adam_matches_optax():
    """Three updates fed the same gradients, with an LR change before the
    third, as the epoch-level decay makes it."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    cfg = cfg_pair("TinyConfig")[1]
    tx = jtl.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in p0.items()}
    opt = train_lib.make_optimizer(cfg, tp.values())
    for i, g in enumerate(grads):
        if i == 2:
            opt_state = jtl.set_learning_rate(opt_state, 2.5e-4)
            train_lib.set_learning_rate(opt, 2.5e-4)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_lr_schedule_and_resume_epoch():
    cfg = cfg_pair("TinyConfig")[1]
    jcfg = cfg_pair("TinyConfig")[0]
    for epoch in (0, 4, 5, 12, 24):
        assert train_lib.lr_for_epoch(cfg, epoch) == jtl.lr_for_epoch(jcfg, epoch)
    for step in (0, 7 * 64, 10_000 * 64):
        assert train_lib.resume_epoch(cfg, step, 64) == jtl.resume_epoch(jcfg, step, 64)


def test_train_cli_writes_and_resumes_a_checkpoint(tmp_path):
    from cofii2p_tpu_torch import train
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint

    common = ["tiny", "--synthetic", "--synthetic_frames", "8", "--batch_size", "2", "--device", "cpu",
              f"root_path={tmp_path}", "num_workers=2"]
    first = train.main(common + ["--steps", "2"])
    path = latest_checkpoint(first)
    assert path is not None and path.endswith("step_00000002.pt")
    model = CoFiI2P(cfg_pair("TinyConfig")[1])
    assert restore_checkpoint(path, model) == 2
    resumed = train.main(common + ["--steps", "3", "--ft_from", path])
    assert latest_checkpoint(resumed).endswith("step_00000003.pt")
    after = CoFiI2P(cfg_pair("TinyConfig")[1])
    restore_checkpoint(latest_checkpoint(resumed), after)
    moved = [n for n, p in after.named_parameters() if not torch.equal(p, model.state_dict()[n])]
    assert moved  # the resumed run took a step from the restored state


def test_train_cli_refuses_fast_and_a_missing_card():
    """The trainer runs on the card unless asked for the CPU, with or
    without --fast (which no longer refuses by itself)."""
    from cofii2p_tpu_torch import train

    if not torch.cuda.is_available():
        for extra in ([], ["--fast"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                train.main(["tiny", "--synthetic", "--steps", "1"] + extra)


def test_windows_case_drops_pairs():
    """The windows case is no static plan in disguise: its windows leave
    out in-reach pairs that the whole support level holds."""
    _, _, _, _, _, _, _, _, tmodel, tbatch = _setup("windows")
    fpn, pts = tmodel.pc_encoder, tbatch["points"]
    pairs = [(0, 0, 1, True)] + [(lvl, sl, 2 ** sl, sl == lvl) for lvl in range(1, 5) for sl in (lvl - 1, lvl)]
    dropped, windowed = 0, 0
    for lvl, sl, scale, is_self in pairs:
        starts = fpn.starts_for(pts[lvl], pts[sl], sl, scale, is_self)
        if starts is None:
            continue
        windowed += 1
        r_act = kernel_reach(fpn.r * scale, fpn.s * scale, fpn.kernel_size)
        win = banded_pair_count(pts[lvl], pts[sl], r_act, fpn.tile, fpn.dyn_w(sl, is_self), starts)
        whole = banded_pair_count(pts[lvl], pts[sl], r_act, fpn.tile, pts[sl].shape[1])
        assert (win <= whole).all()
        dropped += int((whole - win).sum())
    assert windowed == 6 and dropped > 0


def _cli_common(tmp_path):
    return ["tiny", "--synthetic", "--synthetic_frames", "8", "--batch_size", "2", "--device", "cpu",
            f"root_path={tmp_path}", "num_workers=2"]


@pytest.mark.parametrize("overrides", [[], ["kpconv_dynamic_plan=0,128,64,32,0"]])
def test_train_cli_fast_applies_with_fast_windows(tmp_path, monkeypatch, overrides):
    """--fast takes JAX's with_fast_windows of the same overrides: the w256
    plan fitted to the levels (all static at TinyConfig), and an explicit
    window plan wins; two steps run and save a checkpoint."""
    import cofii2p_tpu.config as jconfig
    from cofii2p_tpu_torch import train
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint

    seen = []
    monkeypatch.setattr(train, "CoFiI2P", lambda cfg: seen.append(cfg) or CoFiI2P(cfg))
    save_dir = train.main(_cli_common(tmp_path) + ["--fast", "--steps", "2"] + overrides)
    keys = [a for a in _cli_common(tmp_path) if "=" in a] + overrides
    want = jconfig.with_fast_windows(jconfig.apply_overrides(jconfig.get_config("tiny"), keys))
    assert config_fields(seen[0]) == config_fields(want)
    assert latest_checkpoint(save_dir).endswith("step_00000002.pt")


def test_train_cli_trains_banded_knn(tmp_path):
    """kpconv_impl=banded_knn trains two steps; a k-NN window plan is
    forward-only and refuses the differentiated step, as in JAX."""
    from cofii2p_tpu_torch import train
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint

    save_dir = train.main(_cli_common(tmp_path) + ["kpconv_impl=banded_knn", "--steps", "2"])
    assert latest_checkpoint(save_dir).endswith("step_00000002.pt")
    with pytest.raises(NotImplementedError, match="forward-only"):
        train.main(_cli_common(tmp_path) + ["kpconv_impl=banded_knn", "kpconv_knn_window_plan=0,128,0,0,0",
                                            "--steps", "1"])
