"""Whole-model configurations the network refused before, against the
JAX package's test mode: the two that chip_smoke.py's ``variants`` phase
serves (linear attention, LayerNorm point blocks, centroid windows and 20
kernel points; span windows and 12 kernel points), on JAX's weights
through load_jax_params.  JAX's kernel_dispositions is replaced as in
tests/test_torch_variants.py, so nothing is written into its package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params
from tests.test_torch_variants import jax_kernel_sizes  # noqa: F401  (fixture)
from tests.torch_parity import cfg_pair, host_batch, jax_variables, rel_err, to_torch


DYN = dict(kpconv_dynamic_plan=(0, 64, 64, 64, 0), kpconv_dynamic_plan_self=(0, 0, 64, 64, 0))
VARIANTS = {
    "linear-ln-centroid-k20": dict(attention="linear", norm="ln", kpconv_dynamic_center="centroid", kernel_size=20,
                                   **DYN),
    "span-k12": dict(kpconv_dynamic_center="span", kernel_size=12, **DYN),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_network_variant_matches_jax(jax_kernel_sizes, variant):
    """CoFiI2P builds each configuration the variants phase serves, takes
    JAX's weights through load_jax_params (for 'ln' the LayerNorm
    parameters of every point block) and matches JAX's test mode: scores
    and normalised features within 1e-5 (relative, rms-floored), the
    selection and the superpoints equal."""
    jcfg, tcfg = cfg_pair("TinyConfig", **VARIANTS[variant])
    hb = host_batch(jcfg, 2)
    jmodel, params, stats = jax_variables(jcfg, hb)
    batch = j_prepare(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), jax.random.PRNGKey(3),
                      jnp.asarray(hb["img"]), jcfg)
    want = jmodel.apply({"params": params, "batch_stats": stats}, batch, mode="test", train=False)
    model = load_jax_params(CoFiI2P(tcfg), params, stats).eval()
    sd = jax_to_state_dict(params, stats)
    if tcfg.norm == "ln":
        ln = params["pc_encoder"]["encoder2_1"]["TorchLayerNorm_0"]["LayerNorm_0"]
        np.testing.assert_array_equal(sd["pc_encoder.encoder2_1.norm_conv.weight"].numpy(), np.asarray(ln["scale"]))
        np.testing.assert_array_equal(sd["pc_encoder.encoder2_1.norm_conv.bias"].numpy(), np.asarray(ln["bias"]))
        assert not any(k.endswith("norm.norm.weight") for k in sd if k.startswith("pc_encoder"))
    assert model.pc_encoder.encoder1_1.KPConv.kernel_points.shape == (tcfg.kernel_size, 3)
    tb = {"img": to_torch(batch["img"]), "feats": to_torch(batch["feats"]),
          "points": [to_torch(p) for p in batch["points"]]}
    with torch.no_grad():
        got = model(tb, mode="test")
    for key in ("img_feature_norm", "pc_feature_norm", "coarse_img_score", "coarse_pc_score", "fine_pc_feature"):
        assert rel_err(got[key], want[key]) <= 1e-5, key
    for key in ("inlier_mask", "coarse_pc_points"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
