"""The gather formulation (``kpconv_impl='gather'``, the JAX package's
exact k-NN KPConv) against the JAX package's, on seeded numpy inputs:
kernel_influence, KPConv, ResidualBlock (strided and not) and the
KPConvFPN in fp32 at rel 1e-5, with shared and with per-layer kernel
points, bf16 within 5e-2; the port's gather FPN against its own
banded_knn FPN at a band that covers every level (as
tests/test_banded_knn.py requires of JAX).  The whole eval body and one
train step under gather are in test_torch_gather_eval.py and
test_torch_gather_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare
from cofii2p_tpu.models.kpconv import KPConv as JKPConv
from cofii2p_tpu.models.kpconv import KPConvFPN as JFPN
from cofii2p_tpu.models.kpconv import ResidualBlock as JResidualBlock
from cofii2p_tpu.models.kpconv import kernel_influence as j_kernel_influence
from cofii2p_tpu.models.kpconv import nearest_upsample as j_nearest_upsample
from cofii2p_tpu.models.kpconv import neighbor_maxpool as j_neighbor_maxpool
from cofii2p_tpu.ops.knn import knn as j_knn
from cofii2p_tpu_torch.models.kernel_points import load_kernel_points
from cofii2p_tpu_torch.models.kpconv import (
    KPConv,
    KPConvFPN,
    ResidualBlock,
    kernel_influence,
    nearest_upsample,
    neighbor_maxpool,
)
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.convert import jittered_kernel_points, load_jax_params
from tests.torch_parity import (
    cfg_pair,
    host_batch,
    jax_variables,
    lidar_cloud,
    per_layer_kernel_points,
    rel_err,
    to_torch,
)

T = torch.as_tensor
R, S, K, H = 0.6, 0.3, 15, 16


def pair(seed, m=96, n=192, cin=8):
    """Support cloud, queries (a subset, as a pyramid's), features of both
    signs and the queries' H nearest support indices, some replaced by the
    shadow index N."""
    rng = np.random.default_rng(seed)
    s_pts = np.stack([lidar_cloud(n, rng, extent=2.0) for _ in range(2)])
    q_pts = s_pts[:, rng.permutation(n)[:m]]
    feats = rng.normal(size=(2, n, cin)).astype(np.float32)
    nbr = np.stack([np.asarray(j_knn(jnp.asarray(q), jnp.asarray(s), H)) for q, s in zip(q_pts, s_pts)])
    nbr[:, ::5, -3:] = n
    return feats, q_pts, s_pts, nbr


def test_kernel_influence_and_index_helpers_match_jax():
    feats, q, s, nbr = pair(0)
    kp = jittered_kernel_points(T(np.asarray(load_kernel_points(R, K), np.float32)), torch.Generator().manual_seed(0))
    for kpi in (None, kp):
        want = j_kernel_influence(jnp.asarray(q), jnp.asarray(s), jnp.asarray(nbr), R, S, K,
                                  kp=None if kpi is None else jnp.asarray(kpi.numpy()))
        got = kernel_influence(T(q), T(s), T(nbr), R, S, K, kp=kpi)
        assert got.shape == want.shape and rel_err(got, want) <= 1e-5
        assert float(got[:, ::5, -3:].abs().max()) == 0.0  # shadow rows
    np.testing.assert_array_equal(neighbor_maxpool(T(feats), T(nbr)).numpy(),
                                  np.asarray(j_neighbor_maxpool(jnp.asarray(feats), jnp.asarray(nbr))))
    up = np.random.default_rng(1).integers(0, 96, size=(2, 192, 8))
    np.testing.assert_array_equal(nearest_upsample(T(feats[:, :96]), T(up)).numpy(),
                                  np.asarray(j_nearest_upsample(jnp.asarray(feats[:, :96]), jnp.asarray(up))))


def test_neighbor_maxpool_gradient_splits_ties_as_jax():
    """JAX's max splits the cotangent evenly among tied rows; duplicated
    features (and shadow zeros) tie here."""
    feats, _, _, nbr = pair(2)
    feats[:, 1::4] = feats[:, ::4]
    feats[:, 7::9, 2] = 0.0
    g = np.random.default_rng(3).normal(size=(2, 96, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_neighbor_maxpool(f, jnp.asarray(nbr)), jnp.asarray(feats))
    tf = T(feats).requires_grad_()
    neighbor_maxpool(tf, T(nbr)).backward(T(g))
    assert rel_err(tf.grad, vjp(jnp.asarray(g))[0]) <= 1e-6


@pytest.mark.parametrize("shared", [True, False])
def test_kpconv_gather_matches_jax(shared):
    """fp32 within 1e-5, with the influence passed in (shared, canonical
    kernel points) or computed from the layer's own rotated and jittered
    kernel points; bf16 within the reference's 5e-2 of the fp32 result."""
    feats, q, s, nbr = pair(4)
    jconv = JKPConv(24, K, R, S, impl="gather")
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(q), jnp.asarray(s), jnp.asarray(nbr))
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    if not shared:
        p["kernel_points"] = jittered_kernel_points(T(p["kernel_points"]), torch.Generator().manual_seed(1)).numpy()
    infl = j_kernel_influence(jnp.asarray(q), jnp.asarray(s), jnp.asarray(nbr), R, S, K) if shared else None
    want = jconv.apply({"params": p}, jnp.asarray(feats), jnp.asarray(q), jnp.asarray(s), jnp.asarray(nbr), infl)
    conv = KPConv(8, 24, K, R, S, impl="gather")
    conv.load_state_dict({k: T(np.array(v)) for k, v in p.items()})
    tinfl = kernel_influence(T(q), T(s), T(nbr), R, S, K) if shared else None
    with torch.no_grad():
        got = conv(T(feats), T(q), T(s), neighbor_indices=T(nbr), influence=tinfl)
        conv.dtype = torch.bfloat16
        got16 = conv(T(feats), T(q), T(s), neighbor_indices=T(nbr), influence=tinfl)
    assert got.dtype == torch.float32 and rel_err(got, want) <= 1e-5
    assert got16.dtype == torch.float32 and rel_err(got16, want) <= 5e-2


def _block_state(p):
    """The port block's state dict from the flax block's parameters."""
    sd = {}

    def unary(f, t):
        sd[f"{t}.mlp.weight"] = p[f]["mlp"]["Dense_0"]["kernel"].T
        sd[f"{t}.mlp.bias"] = p[f]["mlp"]["Dense_0"]["bias"]
        sd[f"{t}.norm.norm.weight"] = p[f]["PointGroupNorm_0"]["scale"]
        sd[f"{t}.norm.norm.bias"] = p[f]["PointGroupNorm_0"]["bias"]

    for name in ("unary1", "unary2", "unary_shortcut"):
        if name in p:
            unary(name, name)
    for nm in ("weights", "kernel_points", "bias"):
        sd[f"KPConv.{nm}"] = p["KPConv"][nm]
    sd["norm_conv.norm.weight"] = p["PointGroupNorm_0"]["scale"]
    sd["norm_conv.norm.bias"] = p["PointGroupNorm_0"]["bias"]
    return {k: T(np.array(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("strided", [False, True])
def test_residual_block_gather_matches_jax(strided):
    """Forward rel 1e-5 and the features' and parameters' gradients rel
    1e-4; a strided block's shortcut is the max over its subsampling
    neighbours."""
    feats, q, s, nbr = pair(5, cin=16)
    if not strided:
        q = s
        nbr = np.stack([np.asarray(j_knn(jnp.asarray(x), jnp.asarray(x), H)) for x in s])
    kw = dict(in_channels=16, out_channels=32, kernel_size=K, radius=R, sigma=S, strided=strided, group_norm=4)
    jblk = JResidualBlock(impl="gather", **kw)
    args = (jnp.asarray(q), jnp.asarray(s), jnp.asarray(nbr))
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(feats), *args)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']") else x, params)
    g = rng.normal(size=(2, q.shape[1], 32)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x: jblk.apply(p, x, *args), params, jnp.asarray(feats))
    g_params, g_feats = vjp(jnp.asarray(g))

    tblk = ResidualBlock(impl="gather", **kw)
    tblk.load_state_dict(_block_state(jax.tree_util.tree_map(np.asarray, params["params"])))
    tf = T(feats).requires_grad_()
    out = tblk(tf, T(q), T(s), neighbor_indices=T(nbr))
    assert rel_err(out, want) <= 1e-5
    out.backward(T(g))
    assert rel_err(tf.grad, g_feats) <= 1e-4
    want_g = _block_state(jax.tree_util.tree_map(np.asarray, g_params["params"]))
    for name, prm in tblk.named_parameters():
        assert rel_err(prm.grad, want_g[name]) <= 1e-4, name


@pytest.fixture(scope="module")
def fpn_setup():
    """TinyConfig under gather: JAX's sample prep (with the k-NN maps) and
    model weights, carried into the port."""
    jcfg, tcfg = cfg_pair("TinyConfig", kpconv_impl="gather")
    hb = host_batch(jcfg, 2)
    jmodel, params, stats = jax_variables(jcfg, hb)
    batch = j_prepare(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), jax.random.PRNGKey(3),
                      jnp.asarray(hb["img"]), jcfg)
    tb = {k: to_torch(batch[k]) for k in ("feats", "points", "neighbors", "subsampling", "upsampling")}
    return jcfg, tcfg, params, stats, batch, tb


def _fpn_kw(cfg):
    return dict(input_dim=cfg.kpconv_input_dim, output_dim=cfg.kpconv_output_dim, init_dim=cfg.kpconv_init_dim,
                kernel_size=cfg.kernel_size, init_radius=cfg.init_radius, init_sigma=cfg.init_sigma,
                group_norm=cfg.group_norm)


@pytest.mark.parametrize("shared", [True, False])
def test_kpconv_fpn_gather_matches_jax(fpn_setup, shared):
    """One canonical influence a level (shared) or each KPConv's own
    rotated and jittered kernel points.  The latent and the first decoder
    output within 1e-5; the two finer decoder outputs within 2e-5: on
    them JAX's own eager and jitted forwards of these weights differ by up
    to 1.1e-5 (the order of evaluation alone), and the port lies 1.3e-5 to
    1.6e-5 from either."""
    jcfg, tcfg, params, stats, batch, tb = fpn_setup
    if not shared:
        params = per_layer_kernel_points(params)
    jfpn = JFPN(impl="gather", shared_influence=shared, **_fpn_kw(jcfg))
    maps = (batch["neighbors"], batch["subsampling"], batch["upsampling"])
    want = jfpn.apply({"params": params["pc_encoder"]}, batch["feats"], batch["points"], *maps)
    model = load_jax_params(CoFiI2P(tcfg.replace(kpconv_shared_influence=shared)), params, stats)
    assert all(len(tb[k]) == n for k, n in (("neighbors", 5), ("subsampling", 4), ("upsampling", 4)))
    with torch.no_grad():
        got = model.pc_encoder(tb["feats"], tb["points"], tb["neighbors"], tb["subsampling"], tb["upsampling"])
    for w, g, tol in zip(want, got, (2e-5, 2e-5, 1e-5, 1e-5)):
        assert g.shape == w.shape and rel_err(g, w) <= tol


def test_gather_fpn_equals_banded_knn_at_a_full_band(fpn_setup):
    """The port's two k-NN formulations agree where the band covers every
    support level (rtol/atol 2e-4, tests/test_banded_knn.py:168)."""
    jcfg, tcfg, params, stats, batch, tb = fpn_setup
    params = per_layer_kernel_points(params, seed=3)
    gather = load_jax_params(CoFiI2P(tcfg.replace(kpconv_shared_influence=False)), params, stats).pc_encoder
    knn = KPConvFPN(impl="banded_knn", knn_k=jcfg.neighbor_num, band_width=jcfg.num_pc, kernel="xla",
                    tile=jcfg.kpconv_tile, **_fpn_kw(jcfg))
    knn.load_state_dict(gather.state_dict())
    with torch.no_grad():
        outs_g = gather(tb["feats"], tb["points"], tb["neighbors"], tb["subsampling"], tb["upsampling"])
        outs_k = knn(tb["feats"], tb["points"])
    for og, ok in zip(outs_g, outs_k):
        np.testing.assert_allclose(ok.numpy(), og.numpy(), rtol=2e-4, atol=2e-4)
