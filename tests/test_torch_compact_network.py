"""The compacted plans (``maxpool_compact_plan``, ``aggregate_compact_plan``)
through the whole TinyConfig KPConv FPN: the JAX package's forward against
the port's, weights carried by utils/convert.py, fp32, within the 1e-3 of
test_torch_models.py (the twin of tests/test_banded_knn.py:193-290); the
port's own equivalences at a band that covers every level; one selection
per (query level, support level) pair and no tau for a pair whose
consumers are all compacted; and the two guards: a dynamic or a k-NN
window on a support level that takes a compacted formulation raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare
from cofii2p_tpu.models.kpconv import KPConvFPN as JFPN
from cofii2p_tpu_torch.config import TinyConfig
from cofii2p_tpu_torch.models.kpconv import KPConvFPN
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.convert import load_jax_params
from tests.torch_parity import cfg_pair, host_batch, jax_variables, per_layer_kernel_points, rel_err, to_torch

TOL = 1e-3
FULL_BAND = 1 << 20
PLANS = {
    "radius_maxpool": dict(maxpool_compact_plan=(8,) * 5),
    "radius_both": dict(maxpool_compact_plan=(8, 0, 8, 0, 0), aggregate_compact_plan=(8, 8, 0, 8, 8)),
    "knn_both": dict(kpconv_impl="banded_knn", maxpool_compact_plan=(1,) * 5, aggregate_compact_plan=(1,) * 5),
    "knn_aggregate": dict(kpconv_impl="banded_knn", aggregate_compact_plan=(0, 1, 1, 0, 1)),
}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = cfg_pair("TinyConfig")
    hb = host_batch(jcfg, 2)
    _, params, stats = jax_variables(jcfg, hb)
    batch = j_prepare(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), jax.random.PRNGKey(3),
                      jnp.asarray(hb["img"]), jcfg)
    tb = {"feats": to_torch(batch["feats"]), "points": [to_torch(p) for p in batch["points"]]}
    return jcfg, tcfg, params, stats, batch, tb


def _jfpn(cfg, **kw):
    return JFPN(input_dim=cfg.kpconv_input_dim, output_dim=cfg.kpconv_output_dim, init_dim=cfg.kpconv_init_dim,
                kernel_size=cfg.kernel_size, init_radius=cfg.init_radius, init_sigma=cfg.init_sigma,
                group_norm=cfg.group_norm, tile=cfg.kpconv_tile, band_width=cfg.kpconv_band_width,
                band_plan=cfg.kpconv_band_plan, knn_k=cfg.neighbor_num, **kw)


def _fields(plan):
    """A plan's config fields as KPConvFPN arguments (kpconv_impl -> impl)."""
    kw = dict(plan)
    kw["impl"] = kw.pop("kpconv_impl", "banded")
    return kw


@pytest.mark.parametrize("name", sorted(PLANS))
def test_compact_fpn_matches_jax(setup, name):
    """Under 'banded_knn' every KPConv carries its own rotated and jittered
    kernel points, as a reference checkpoint does."""
    jcfg, tcfg, params, stats, batch, tb = setup
    plan = PLANS[name]
    knn = plan.get("kpconv_impl") == "banded_knn"
    if knn:
        params = per_layer_kernel_points(params, seed=1)
    jfpn = _jfpn(jcfg, shared_influence=not knn, **_fields(plan))
    want = jfpn.apply({"params": params["pc_encoder"]}, batch["feats"], batch["points"])
    model = load_jax_params(CoFiI2P(tcfg.replace(kpconv_shared_influence=not knn, **plan)), params, stats)
    with torch.no_grad():
        got = model.pc_encoder(tb["feats"], tb["points"])
    for w, g in zip(want, got):
        assert g.shape == w.shape and rel_err(g, w) <= TOL


def _tfpn(cfg, **kw):
    """The port's KPConvFPN of ``cfg`` with ``kw`` (KPConvFPN arguments)."""
    args = dict(input_dim=cfg.kpconv_input_dim, output_dim=cfg.kpconv_output_dim, init_dim=cfg.kpconv_init_dim,
                kernel_size=cfg.kernel_size, init_radius=cfg.init_radius, init_sigma=cfg.init_sigma,
                group_norm=cfg.group_norm, tile=cfg.kpconv_tile, band_width=cfg.kpconv_band_width,
                band_plan=cfg.kpconv_band_plan, knn_k=cfg.neighbor_num)
    return KPConvFPN(**{**args, **kw})


def test_compact_at_a_full_band_equals_the_band_formulation(setup):
    """k >= band: the compacted maxpool is the band maxpool bit for bit, the
    compacted aggregation sums the same members in another order
    (tests/test_banded_knn.py:193-250's gates); under 'banded_knn' with
    k = knn_k both match the tau formulation."""
    _, tcfg, _, _, _, tb = setup
    torch.manual_seed(0)
    for impl, k, gate in (("banded", FULL_BAND, 2e-4), ("banded_knn", 1, 2e-4)):
        full = dict(impl=impl, band_width=FULL_BAND, band_plan=None)
        base = _tfpn(tcfg, **full)
        outs = {}
        for plan in ("none", "maxpool", "aggregate"):
            kw = {} if plan == "none" else {f"{plan}_compact_plan": (k,) * 5}
            fpn = _tfpn(tcfg, **full, **kw)
            fpn.load_state_dict(base.state_dict())
            with torch.no_grad():
                outs[plan] = fpn(tb["feats"], tb["points"])
        if impl == "banded":
            assert all(torch.equal(a, b) for a, b in zip(outs["maxpool"], outs["none"]))
        for plan in ("maxpool", "aggregate"):
            for a, b in zip(outs[plan], outs["none"]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=gate, atol=gate)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(a[0].shape[1:2] + a[1].shape[1:2])
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("plan,selections,taus", [
    ("knn_both", 9, 0),  # every pair's consumers compacted: no tau at all
    ("knn_aggregate", 5, 6),  # 3 self pairs and 2 cross; the other 2 self pairs and the shortcuts keep tau
    ("radius_both", 8, 0),
])
def test_one_selection_a_pair_and_no_unread_tau(setup, monkeypatch, plan, selections, taus):
    """One banded_knn_select per (query level, support level) pair with a
    compacted consumer, and no k-NN tau (kernel #5 on the card) for a pair
    that nothing reads it on; JAX's jit drops that dead tau, eager PyTorch
    would run it."""
    import cofii2p_tpu_torch.models.kpconv as kpc

    _, tcfg, _, _, _, tb = setup
    sel = _count_calls(monkeypatch, kpc, "banded_knn_select")
    tau = _count_calls(monkeypatch, kpc, "banded_knn_tau_kernel")
    with torch.no_grad():
        _tfpn(tcfg, **_fields(PLANS[plan]))(tb["feats"], tb["points"])
    assert len(sel) == selections
    assert len(tau) == taus


def test_compact_fpn_gradient_is_finite(setup):
    """Training differentiates through both compacted formulations (the
    selection is not differentiated; the cotangent routes through the row
    gathers and the max)."""
    _, tcfg, _, _, _, tb = setup
    fpn = _tfpn(tcfg, **_fields(PLANS["radius_both"]))
    outs = fpn(tb["feats"], tb["points"])
    sum((o**2).sum() for o in outs).backward()
    grads = [p.grad for p in fpn.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    assert fpn.encoder2_1.KPConv.weights.grad.abs().max() > 0


@pytest.mark.parametrize("override", [
    # tests/test_dynamic_starts.py:271's case, which the JAX package refuses too
    dict(kpconv_kernel="xla", kpconv_dynamic_plan=(0, 256, 256, 256, 256), maxpool_compact_plan=(0, 0, 64, 0, 0)),
    # a k-NN window meeting a compacted plan, which the JAX package does not refuse
    dict(kpconv_impl="banded_knn", kpconv_knn_window_plan=(0, 128, 0, 0, 0), aggregate_compact_plan=(0, 16, 0, 0, 0)),
], ids=["dynamic_window", "knn_window"])
def test_windows_meeting_compact_plans_raise(override):
    with pytest.raises(NotImplementedError, match="compact"):
        CoFiI2P(TinyConfig(**override))


def test_windows_on_other_levels_are_allowed():
    """The guards refuse a window only on a level that is compacted."""
    CoFiI2P(TinyConfig(kpconv_dynamic_plan=(0, 256, 0, 256, 256), maxpool_compact_plan=(0, 0, 64, 0, 0)))
    CoFiI2P(TinyConfig(kpconv_impl="banded_knn", kpconv_knn_window_plan=(128, 0, 0, 0, 0),
                       aggregate_compact_plan=(0, 16, 0, 0, 0)))
