"""Why the fp32 KPConvs (kernels #7 and #6, csrc/kpconv_tau_mma.cuh, and #1,
csrc/kpconv_mma.cuh, with the same products) and the fp32 fused attention
(#4, csrc/attention.cu) may run their products on the tensor cores: 3xTF32
keeps them inside the gates (1e-4 rel, 1e-5 abs) that one TF32 product
misses.

TF32 keeps 10 mantissa bits.  The kernel splits each fp32 operand into
hi = tf32(a) and lo = tf32(a - hi) (cvt.rna: round to nearest, ties away
from zero) and accumulates hi*hi + hi*lo + lo*hi in fp32, dropping lo*lo
(about 2^-22 relative).  Here numpy emulates that, and one TF32 product,
on `.t7`-shaped operands: a block's influence tile (64 queries by the 640
active rows of an lvl3 band, most of it zero) times the rows' features
(Cin 256), then the aggregate times W_k (256 x 256); each against float64,
in chip_smoke.py's error (max elementwise, floored at the rms); and the
attention's softmax(Q K^T / sqrt(D)) V of one (frame, head) at the `.t7`
path's shape, against float64 in absolute error.
"""

import numpy as np
import pytest

GATE = 1e-4  # the fp32 gates of #7/#6, the t7 phase and the train_knn replays


def tf32(x):
    """Round fp32 to tf32 (10 mantissa bits), to nearest, ties away from 0."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def mma_product(a, b, split):
    """a (M, K) @ b (K, N) as the tensor cores take it: products of the
    (split) operands exact, summed per k-step of 8 and accumulated in fp32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if split:
        ah, bh = tf32(a), tf32(b)
        al, bl = tf32(a - ah), tf32(b - bh)
        terms = [(al, bh), (ah, bl), (ah, bh)]
    else:
        terms = [(tf32(a), tf32(b))]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            part = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
            acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    rms = np.sqrt(np.mean(ref * ref)) + 1e-30
    return float(np.max(np.abs(a - ref) / np.maximum(np.abs(ref), rms)))


def operands(seed):
    rng = np.random.default_rng(seed)
    # influence: max(1 - d / sigma, 0) at random offsets, zero outside tau
    infl = np.maximum(1.0 - rng.uniform(0.0, 1.6, (64, 640)), 0.0).astype(np.float32)
    infl[rng.random((64, 640)) < 0.8] = 0.0
    feats = rng.standard_normal((640, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 256)) / 16.0).astype(np.float32)
    return infl, feats, w


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.float32([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-20, -(1.0 + 3 * 2.0**-11), 3.0e-30])
    got = tf32(x)
    assert got.tolist() == np.float32([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2 * 2.0**-10),
                                       got[-1]]).tolist()
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # hi + lo carries 22 bits: the split's own error is below 2^-21
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = tf32(v)
    lo = tf32(v - hi)
    assert np.max(np.abs((hi.astype(np.float64) + lo) - v) / np.abs(v)) < 2.0**-21


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_products_keep_the_fp32_gates(seed):
    """Aggregation and contraction by 3xTF32 stay 50 times inside 1e-4
    (about 1.2e-6, within 4 times fp32 products' own rounding); one TF32
    product misses the gate by 5 times on the same operands (about 1.2e-3)."""
    infl, feats, w = operands(seed)
    ref_acc = infl.astype(np.float64) @ feats.astype(np.float64)
    acc3 = mma_product(infl, feats, split=True)
    assert rel_err(acc3, ref_acc) < GATE / 50
    assert rel_err(acc3, ref_acc) < 4 * rel_err(infl @ feats, ref_acc)
    assert rel_err(mma_product(infl, feats, split=False), ref_acc) > 5 * GATE
    # the contraction takes the kernel's own fp32 aggregate
    ref_out = acc3.astype(np.float64) @ w.astype(np.float64)
    out3 = mma_product(acc3, w, split=True)
    assert rel_err(out3, ref_out) < GATE / 50
    assert rel_err(mma_product(acc3, w, split=False), ref_out) > 5 * GATE
    # both products against float64 throughout
    assert rel_err(out3, ref_acc @ w.astype(np.float64)) < GATE / 50


ATTN_GATE = 1e-5  # chip_smoke.py's and the card tests' fp32 gate of the fused attention (#4), abs


def attention_tf32x3(q, k, v, split=True, chunk=64):
    """One (frame, head) of the fp32 attention body of csrc/attention.cu:
    S = Q K^T by mma_product (3xTF32, or one TF32 product), divided by
    sqrt(D) in fp32; an online softmax over chunks of 64 keys (running max,
    fp32 denominators, the output rescaled by exp(m_old - m_new)); P V by
    mma_product on P's and V's splits; acc / denom in fp32."""
    d = q.shape[1]
    scale = np.sqrt(np.float32(d), dtype=np.float32)
    o = np.zeros((q.shape[0], d), np.float32)
    m = np.full(q.shape[0], -np.inf, np.float32)
    den = np.zeros(q.shape[0], np.float32)
    for s0 in range(0, k.shape[0], chunk):
        x = (mma_product(q, k[s0:s0 + chunk].T, split) / scale).astype(np.float32)
        m_new = np.maximum(m, x.max(1))
        corr = np.exp(m - m_new).astype(np.float32)
        p = np.exp(x - m_new[:, None]).astype(np.float32)
        den = (den * corr + p.sum(1, dtype=np.float32)).astype(np.float32)
        o = (o * corr[:, None] + mma_product(p, v[s0:s0 + chunk], split)).astype(np.float32)
        m = m_new
    return o / den[:, None]


def attention_f64(q, k, v):
    x = q.astype(np.float64) @ k.astype(np.float64).T / np.sqrt(q.shape[1])
    p = np.exp(x - x.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)


@pytest.mark.parametrize("queries", ["normalised", "randn"])
def test_three_tf32_products_keep_the_attention_gate(queries):
    """The fp32 attention at the `.t7` path's shape, one (frame, head) of
    (8, 1280, 4, 32), with the transformer's sequence-normalised queries and
    with randn ones (logit std ~1): by 3xTF32 (Q, K, P and V each split
    into hi + lo) within the 1e-5 abs gate of a float64 reference, more
    than 10 times inside it; one TF32 product on the same operands misses
    it."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1280, 32)).astype(np.float32) for _ in range(3))
    if queries == "normalised":
        q = (q / np.linalg.norm(q, axis=0, keepdims=True)).astype(np.float32)
    ref = attention_f64(q, k, v)
    err3 = np.abs(attention_tf32x3(q, k, v) - ref).max()
    assert err3 < ATTN_GATE / 10
    assert np.abs(attention_tf32x3(q, k, v, split=False) - ref).max() > ATTN_GATE
