"""I2P feature-fusion transformer (counterpart of
cofii2p_tpu/models/transformer.py).

Kept on purpose: the reference L2-normalises the projected query along
the SEQUENCE axis of the (B, L, H, D) tensor (F.normalize's default dim=1,
transformer.py:66-73), and trained checkpoints depend on it.

``attention='pallas'`` runs ops/attention_kernel.py::fused_attention (the
CUDA kernel on the card, output in q's dtype); ``'full'`` the plain
full_attention and ``'linear'`` the reference's elu+1 linear attention
(fp32 outputs), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import LayerNorm, Linear
from benchmark.reference.ops.plain import full_attention, fused_attention_plain

ATTENTIONS = ("full", "pallas", "linear")


def linear_attention(q, k, v, eps: float = 1e-6):
    """elu+1 feature-map linear attention over (B, L/S, H, D), fp32
    (cofii2p_tpu/models/transformer.py:54-63): v is divided by S before the
    products and the result multiplied by S after, the reference's
    overflow guard."""
    qf = F.elu(q.float()) + 1.0
    kf = F.elu(k.float()) + 1.0
    s = v.shape[1]
    v = v.float() / s
    kv = torch.einsum("bshd,bshv->bhdv", kf, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", qf, kf.sum(1)) + eps)
    return torch.einsum("blhd,bhdv,blh->blhv", qf, kv, z) * s


def _seq_l2norm(q: torch.Tensor) -> torch.Tensor:
    q32 = q.float()
    return (q32 / torch.clamp(torch.linalg.vector_norm(q32, dim=1, keepdim=True), min=1e-12)).to(q.dtype)


class LoFTREncoderLayer(nn.Module):
    """x (B, L, C) attends to source (B, S, C)."""

    def __init__(self, d_model=128, nhead=4, dtype=torch.float32, attention="full"):
        super().__init__()
        if attention not in ATTENTIONS:
            raise ValueError(f"attention {attention!r} not in {ATTENTIONS}")
        c = d_model
        self.nhead, self.dtype, self.attention = nhead, dtype, attention
        self.q_proj = Linear(c, c, bias=False, dtype=dtype)
        self.k_proj = Linear(c, c, bias=False, dtype=dtype)
        self.v_proj = Linear(c, c, bias=False, dtype=dtype)
        self.merge = Linear(c, c, bias=False, dtype=dtype)
        self.mlp = nn.Sequential(
            Linear(2 * c, 2 * c, bias=False, dtype=dtype), nn.ReLU(), Linear(2 * c, c, bias=False, dtype=dtype)
        )
        self.norm1 = LayerNorm(c)
        self.norm2 = LayerNorm(c)
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.merge, self.mlp[0], self.mlp[2]):
            nn.init.xavier_uniform_(lin.weight)

    def forward(self, x, source):
        b, l, c = x.shape
        h = self.nhead
        q = _seq_l2norm(self.q_proj(x).reshape(b, l, h, c // h))
        k = self.k_proj(source).reshape(b, -1, h, c // h)
        v = self.v_proj(source).reshape(b, -1, h, c // h)
        attn = {"pallas": fused_attention_plain, "linear": linear_attention, "full": full_attention}[self.attention]
        message = attn(q, k, v).reshape(b, l, c)
        message = self.norm1(self.merge(message.to(self.dtype)))
        y = self.norm2(self.mlp(torch.cat([x.to(self.dtype), message], dim=-1)))
        return x + y


class LocalFeatureTransformer(nn.Module):
    """Alternating self/cross fusion over two token sets; ``layers.{i}``
    as in the reference state dict (transformer.py:67-103)."""

    def __init__(self, d_model=128, nhead=4, layer_names=("self", "cross") * 4, dtype=torch.float32, attention="full"):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(
            LoFTREncoderLayer(d_model, nhead, dtype, attention) for _ in self.layer_names
        )

    def forward(self, feat0, feat1):
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                feat0, feat1 = layer(feat0, feat0), layer(feat1, feat1)
            elif name == "cross":
                feat0 = layer(feat0, feat1)
                feat1 = layer(feat1, feat0)
            else:
                raise KeyError(name)
        return feat0, feat1
