"""The port's models against the JAX package's, with weights carried over
by utils/convert.py::load_jax_params from a JAX ``model.init`` (norm
scales, biases and BatchNorm statistics perturbed so a mis-mapped tensor
shows).  TinyConfig, fp32; tolerance 1e-3 relative, rms-floored."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare
from cofii2p_tpu.models.kpconv import KPConvFPN as JFPN
from cofii2p_tpu.models.resnet import ImageUpSample as JUp
from cofii2p_tpu.models.resnet import ResNetEncoder as JResNet
from cofii2p_tpu.models.transformer import LocalFeatureTransformer as JTransformer
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params
from tests.torch_parity import cfg_pair, host_batch, jax_variables, rel_err, to_torch

TOL = 1e-3
DYN = dict(kpconv_dynamic_plan=(0, 64, 64, 64, 0), kpconv_dynamic_plan_self=(0, 0, 64, 64, 0))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = cfg_pair("TinyConfig", attention="pallas", **DYN)
    hb = host_batch(jcfg, 2)
    jmodel, params, stats = jax_variables(jcfg, hb)
    batch = j_prepare(
        *(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), jax.random.PRNGKey(3),
        jnp.asarray(hb["img"]), jcfg,
    )
    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats).eval()
    tbatch = {
        "img": to_torch(batch["img"]), "feats": to_torch(batch["feats"]),
        "points": [to_torch(p) for p in batch["points"]],
    }
    return jcfg, jmodel, params, stats, batch, tmodel, tbatch


def test_state_dict_mapping_is_complete(setup):
    _, _, params, stats, _, tmodel, _ = setup
    sd = jax_to_state_dict(params, stats)
    assert set(sd) == set(tmodel.state_dict())
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    n_port = sum(p.numel() for p in tmodel.parameters()) + sum(
        b.numel() for n, b in tmodel.named_buffers() if n.endswith("kernel_points")
    )
    assert n_jax == n_port


def test_kpconv_fpn(setup):
    jcfg, _, params, _, batch, tmodel, tbatch = setup
    jfpn = JFPN(
        input_dim=jcfg.kpconv_input_dim, output_dim=jcfg.kpconv_output_dim, init_dim=jcfg.kpconv_init_dim,
        kernel_size=jcfg.kernel_size, init_radius=jcfg.init_radius, init_sigma=jcfg.init_sigma,
        norm=jcfg.norm, group_norm=jcfg.group_norm, impl="banded", tile=jcfg.kpconv_tile,
        band_width=jcfg.kpconv_band_width, band_plan=jcfg.kpconv_band_plan, kernel="auto",
        dynamic_plan=jcfg.kpconv_dynamic_plan, dynamic_plan_self=jcfg.kpconv_dynamic_plan_self,
        dynamic_center=jcfg.kpconv_dynamic_center,
    )
    want = jfpn.apply({"params": params["pc_encoder"]}, batch["feats"], batch["points"])
    with torch.no_grad():
        got = tmodel.pc_encoder(tbatch["feats"], tbatch["points"])
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert rel_err(g, w) <= TOL


def test_resnet_and_upsample(setup):
    _, _, params, stats, batch, tmodel, tbatch = setup
    want = JResNet(stage_sizes=(3, 4, 6, 3)).apply({"params": params["img_encoder"]}, batch["img"])
    with torch.no_grad():
        got = tmodel.img_encoder(tbatch["img"])
    assert [g.shape for g in got] == [w.shape for w in want]
    # the network reads the /2, /4, /8 maps; at TinyConfig's 32x64 image
    # the /32 map is 1x2 pixels, where a 2-pixel instance norm turns
    # rounding-level differences into O(1) ones, so the pyramid is
    # compared down to /16
    for w, g in zip(want[:4], got[:4]):
        assert rel_err(g, w) <= TOL
    up = functools.partial(JUp(128).apply, {"params": params["img_upsample_1"], "batch_stats": stats["img_upsample_1"]})
    want_up = up(want[2], want[1], False)
    with torch.no_grad():
        got_up = tmodel.img_upsample_1(to_torch(want[2]), to_torch(want[1]))
    assert rel_err(got_up, want_up) <= TOL


def test_bilinear_upsample_matches_jax_resize_at_edges():
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="bilinear"))
    got = F.interpolate(torch.as_tensor(x).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("attention", ["full", "pallas"])
def test_transformer(setup, attention):
    jcfg, _, params, _, _, tmodel, _ = setup
    rng = np.random.default_rng(1)
    img_tok = rng.normal(size=(2, jcfg.num_img_tokens, 128)).astype(np.float32)
    pc_tok = rng.normal(size=(2, jcfg.num_superpoints, 128)).astype(np.float32)
    jt = JTransformer(128, 4, ("self", "cross") * 4, attention=attention)
    want = jt.apply({"params": params["transformer"]}, jnp.asarray(img_tok), jnp.asarray(pc_tok))
    for layer in tmodel.transformer.layers:
        layer.attention = attention
    with torch.no_grad():
        got = tmodel.transformer(torch.as_tensor(img_tok), torch.as_tensor(pc_tok))
    for layer in tmodel.transformer.layers:
        layer.attention = "pallas"
    for w, g in zip(want, got):
        assert rel_err(g, w) <= TOL


def test_cofii2p_test_mode(setup):
    _, jmodel, params, stats, batch, tmodel, tbatch = setup
    want = jmodel.apply({"params": params, "batch_stats": stats}, batch, mode="test", train=False)
    with torch.no_grad():
        got = tmodel(tbatch, mode="test")
    for key in ("img_feature_norm", "pc_feature_norm", "coarse_img_score", "coarse_pc_score",
                "fine_img_map", "fine_pc_feature", "fine_img_patch"):
        assert got[key].shape == want[key].shape, key
        assert rel_err(got[key], want[key]) <= TOL, key
    # discrete selections: equal (random-weight tiny inputs have no near-ties here)
    for key in ("inlier_mask", "fine_center_xy", "threshold", "coarse_pc_points"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def _kpconv_dispatch(monkeypatch, cfg, grad):
    """Which kernel wrapper each KPConv of one FPN forward calls, by module
    name; the wrappers are replaced by recorders that call through."""
    import cofii2p_tpu_torch.ops.kpconv_kernel as kpk
    from cofii2p_tpu_torch.models.kpconv import KPConv

    calls, current = [], []
    for name in ("banded_kpconv_fused", "banded_kpconv_aggregate_fused"):
        orig = getattr(kpk, name)

        def rec(*a, _orig=orig, _name=name, **k):
            calls.append((current[-1], _name))
            return _orig(*a, **k)

        monkeypatch.setattr(kpk, name, rec)
    model = CoFiI2P(cfg)
    for mname, mod in model.pc_encoder.named_modules():
        if isinstance(mod, KPConv):
            mod.register_forward_pre_hook(lambda m, a, _n=mname: current.append(_n))
    hb = host_batch(cfg, 1)
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws

    draws = make_draws(cfg, 1, torch.Generator().manual_seed(0), "cpu")
    batch = prepare_samples(*(to_torch(hb[k]) for k in ("pc", "attrs", "P", "K", "img")), cfg, draws["perms"])
    with torch.set_grad_enabled(grad):
        model.pc_encoder(batch["feats"], batch["points"])
    return calls


@pytest.mark.parametrize("dtype,grad", [("float32", False), ("bfloat16", False), ("float32", True)])
def test_kpconv_dispatch_follows_fused_contraction_fits(monkeypatch, dtype, grad):
    """As the JAX package chooses (models/kpconv.py:355-382): without grad,
    the fused kernel where fused_contraction_fits and the aggregate kernel
    plus a matmul elsewhere, i.e. the two Cin = 512 convs in fp32 and none
    in bf16; differentiated, every conv takes the aggregate kernel inside
    BandedKPConvFn."""
    from cofii2p_tpu_torch.config import TinyConfig

    calls = _kpconv_dispatch(monkeypatch, TinyConfig(compute_dtype=dtype), grad)
    assert len(calls) == 14
    unfused = sorted(m for m, name in calls if name == "banded_kpconv_aggregate_fused")
    if grad:
        assert len(unfused) == 14
    elif dtype == "float32":
        assert unfused == ["encoder5_2.KPConv", "encoder5_3.KPConv"]
    else:
        assert unfused == []
