"""The configurations the network refused before, against the JAX
package: ``attention='linear'`` (linear_attention and the transformer, rel
1e-5), ``norm='ln'`` (LayerNorm point blocks, the converter's mapping of
their parameters), ``kpconv_dynamic_center`` 'centroid' and 'span'
(window starts equal) and kernel sizes other than 15 (the disposition
generator np.array_equal to JAX's ``_simulate`` with the same rescale, a
KPConv at K = 12 and 20 rel 1e-5).  The two whole-model configurations
chip_smoke.py's ``variants`` phase serves are in
test_torch_variants_network.py.

JAX's ``kernel_dispositions`` writes a cache file into its package for a
new size (cofii2p_tpu/models/kernel_points.py:64-76); these tests replace
it with a twin that computes the same array and writes nothing, where the
JAX modules look it up, and check that no file appeared."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cofii2p_tpu.models.kernel_points as jkp
from cofii2p_tpu.models.kpconv import KPConv as JKPConv
from cofii2p_tpu.models.kpconv import ResidualBlock as JResidualBlock
from cofii2p_tpu.models.transformer import LocalFeatureTransformer as JTransformer
from cofii2p_tpu.models.transformer import linear_attention as j_linear_attention
from cofii2p_tpu.ops.banded import dynamic_band_starts as j_dynamic_band_starts
from cofii2p_tpu.ops.knn import knn as j_knn
from cofii2p_tpu_torch.models import kernel_points as tkp
from cofii2p_tpu_torch.models.kpconv import KPConv, ResidualBlock
from cofii2p_tpu_torch.models.layers import PointLayerNorm
from cofii2p_tpu_torch.models.transformer import LocalFeatureTransformer, linear_attention
from cofii2p_tpu_torch.ops.banded import dynamic_band_starts, kernel_reach
from tests.torch_parity import lidar_cloud, ordered, rel_err

T = torch.as_tensor
JAX_DISPOSITIONS = os.path.join(os.path.dirname(jkp.__file__), "dispositions")


@functools.lru_cache(maxsize=None)
def _twin_dispositions(num_points=15, dimension=3, ratio=0.66):
    """JAX's kernel_dispositions without its cache file: the shipped file
    where there is one, else its _simulate rescaled as it rescales."""
    path = os.path.join(JAX_DISPOSITIONS, f"k_{num_points:03d}_{dimension}d.npy")
    if os.path.exists(path):
        return np.load(path)
    pts = jkp._simulate(num_points, dimension, jkp._SEED)
    radii = np.linalg.norm(pts, axis=-1)
    return (pts * (ratio / np.mean(radii[1:]))).astype(np.float32)


@pytest.fixture
def jax_kernel_sizes(monkeypatch):
    """JAX at any kernel size, writing nothing into its package."""
    before = sorted(os.listdir(JAX_DISPOSITIONS))
    monkeypatch.setattr(jkp, "kernel_dispositions", _twin_dispositions)
    yield
    assert sorted(os.listdir(JAX_DISPOSITIONS)) == before


@pytest.mark.parametrize("k", [12, 15, 20])
def test_disposition_generator_matches_jax(k):
    np.testing.assert_array_equal(tkp._simulate(k, 3, tkp._SEED), jkp._simulate(k, 3, jkp._SEED))
    got = tkp.generate_disposition(k)
    assert got.dtype == np.float32 and got.shape == (k, 3)
    np.testing.assert_array_equal(got, _twin_dispositions(k))
    np.testing.assert_array_equal(tkp.kernel_dispositions(k), got)
    shipped = os.path.join(os.path.dirname(tkp.__file__), "dispositions", f"k_{k:03d}_3d.npy")
    if k == 15:
        np.testing.assert_array_equal(got, np.load(shipped))
    else:
        assert not os.path.exists(shipped)  # generated in memory, no file written


@pytest.mark.parametrize("k", [12, 20])
@pytest.mark.parametrize("impl", ["banded", "gather"])
def test_kpconv_at_other_kernel_sizes_matches_jax(jax_kernel_sizes, k, impl):
    rng = np.random.default_rng(k)
    s = np.stack([ordered(lidar_cloud(256, rng, extent=2.0)) for _ in range(2)])
    q = s[:, ::2].copy()
    feats = rng.normal(size=(2, 256, 8)).astype(np.float32)
    r, sg = 0.6, 0.3
    nbr = np.stack([np.asarray(j_knn(jnp.asarray(a), jnp.asarray(b), 16)) for a, b in zip(q, s)])
    extra = dict(tile=64, band_width=64) if impl == "banded" else {}
    jconv = JKPConv(24, k, r, sg, impl=impl, **extra)
    args = (jnp.asarray(feats), jnp.asarray(q), jnp.asarray(s)) + ((jnp.asarray(nbr),) if impl == "gather" else ())
    params = jconv.init(jax.random.PRNGKey(0), *args)
    want = jconv.apply(params, *args)
    conv = KPConv(8, 24, k, r, sg, impl=impl, kernel="xla", **extra)
    conv.load_state_dict({n: T(np.array(v)) for n, v in params["params"].items()})
    np.testing.assert_array_equal(conv.kernel_points.numpy(), np.asarray(params["params"]["kernel_points"]))
    assert conv.kernel_points.shape == (k, 3)
    with torch.no_grad():
        got = conv(T(feats), T(q), T(s), neighbor_indices=T(nbr) if impl == "gather" else None)
    assert rel_err(got, want) <= 1e-5
    assert kernel_reach(r, sg, k) == pytest.approx(float(np.linalg.norm(np.asarray(
        params["params"]["kernel_points"]), axis=-1).max() + sg), rel=1e-6)


def test_linear_attention_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, n, 4, 8)).astype(np.float32) for n in (40, 50, 50))
    want = j_linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = linear_attention(T(q), T(k), T(v))
    assert got.dtype == torch.float32 and rel_err(got, want) <= 1e-5
    got16 = linear_attention(T(q).bfloat16(), T(k).bfloat16(), T(v).bfloat16())
    assert got16.dtype == torch.float32  # fp32 features and output, as JAX


def test_linear_transformer_matches_jax():
    rng = np.random.default_rng(1)
    img, pc = (rng.normal(size=(2, n, 128)).astype(np.float32) for n in (48, 32))
    jt = JTransformer(128, 4, ("self", "cross") * 2, attention="linear")
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(pc))
    want = jt.apply(params, jnp.asarray(img), jnp.asarray(pc))
    tt = LocalFeatureTransformer(128, 4, ("self", "cross") * 2, attention="linear")
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    sd = {}
    for i in range(4):
        fb, tb = p[f"layer{i}"], f"layers.{i}."
        for nm in ("q_proj", "k_proj", "v_proj", "merge"):
            sd[tb + nm + ".weight"] = fb[nm]["kernel"].T
        sd[tb + "mlp.0.weight"], sd[tb + "mlp.2.weight"] = fb["mlp1"]["kernel"].T, fb["mlp2"]["kernel"].T
        for nm in ("norm1", "norm2"):
            sd[tb + nm + ".weight"], sd[tb + nm + ".bias"] = fb[nm]["scale"], fb[nm]["bias"]
    tt.load_state_dict({n: T(np.array(v)) for n, v in sd.items()})
    with torch.no_grad():
        got = tt(T(img), T(pc))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-5


@pytest.mark.parametrize("strided", [False, True])
def test_layernorm_residual_block_matches_jax(strided):
    """norm='ln' in every norm of the block: the LayerNorm parameters sit
    where the reference's get_norm puts its nn.LayerNorm
    (<block>.norm_conv.weight, <unary>.norm.weight)."""
    rng = np.random.default_rng(2)
    s = np.stack([ordered(lidar_cloud(256, rng, extent=2.0)) for _ in range(2)])
    q = s[:, ::2].copy() if strided else s
    feats = rng.normal(size=(2, 256, 16)).astype(np.float32)
    kw = dict(in_channels=16, out_channels=32, kernel_size=15, radius=0.6, sigma=0.3, strided=strided, norm="ln",
              tile=64, band_width=64)
    jblk = JResidualBlock(impl="banded", **kw)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(q), jnp.asarray(s))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32) + 0.1
        if "LayerNorm" in jax.tree_util.keystr(path) else x, params)
    want = jblk.apply(params, jnp.asarray(feats), jnp.asarray(q), jnp.asarray(s))
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    sd = {}
    for name in ("unary1", "unary2", "unary_shortcut"):
        sd[f"{name}.mlp.weight"] = p[name]["mlp"]["Dense_0"]["kernel"].T
        sd[f"{name}.mlp.bias"] = p[name]["mlp"]["Dense_0"]["bias"]
        sd[f"{name}.norm.weight"] = p[name]["TorchLayerNorm_0"]["LayerNorm_0"]["scale"]
        sd[f"{name}.norm.bias"] = p[name]["TorchLayerNorm_0"]["LayerNorm_0"]["bias"]
    for nm in ("weights", "kernel_points", "bias"):
        sd[f"KPConv.{nm}"] = p["KPConv"][nm]
    sd["norm_conv.weight"] = p["TorchLayerNorm_0"]["LayerNorm_0"]["scale"]
    sd["norm_conv.bias"] = p["TorchLayerNorm_0"]["LayerNorm_0"]["bias"]
    blk = ResidualBlock(kernel="xla", impl="banded", **kw)
    blk.load_state_dict({n: T(np.array(v)) for n, v in sd.items()})
    assert isinstance(blk.norm_conv, PointLayerNorm)
    with torch.no_grad():
        got = blk(T(feats), T(q), T(s))
    assert rel_err(got, want) <= 1e-5
    x16 = T(feats).bfloat16()
    assert blk.norm_conv(x16[..., :8]).dtype == torch.float32  # flax promotes bf16 against fp32 params


@pytest.mark.parametrize("center", ["centroid", "span"])
def test_dynamic_band_starts_centroid_and_span_match_jax(center):
    """Starts equal on clouds with a far cluster (tiles without in-reach
    support fall back to the static start), for self and strided pairs;
    stride > 1 raises for both, as in JAX."""
    rng = np.random.default_rng(3)
    for m_div, width in ((1, 96), (2, 160), (4, 64)):
        s = np.stack([ordered(lidar_cloud(512, rng, extent=4.0, far=40)) for _ in range(2)])
        q = s[:, ::m_div].copy()
        r_act = kernel_reach(0.425, 0.2)
        want = np.stack([np.asarray(j_dynamic_band_starts(jnp.asarray(a), jnp.asarray(b), r_act, 64, width, center))
                         for a, b in zip(q, s)])
        got = dynamic_band_starts(T(q), T(s), r_act, 64, width, center)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(NotImplementedError):
        dynamic_band_starts(T(q), T(s), r_act, 64, width, center, stride=2)
    with pytest.raises(ValueError):
        dynamic_band_starts(T(q), T(s), r_act, 64, width, "median")
