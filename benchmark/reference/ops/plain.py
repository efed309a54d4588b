"""The plain versions of the port's kernel entry points: the banded
KPConv (radius and k-NN semantics), the banded strided-shortcut maxpool
and softmax attention, in plain PyTorch over ``banded.py``.  Under
autograd each banded call runs frame by frame, checkpointed: its (query,
band row) intermediates are taken again in the backward rather than held,
which changes no value."""

from __future__ import annotations

import functools
import inspect

import torch
import torch.utils.checkpoint

from benchmark.reference.ops.banded import _round, banded_kpconv_aggregate, banded_maxpool


PER_FRAME = ("s_feats", "q_points", "s_points", "tau", "starts")


def checkpointed(fn):
    """Under autograd, ``fn`` runs one frame at a time (frames are
    independent in a banded call), each checkpointed, so that no more than
    one frame's (query, band row) intermediates are held."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        if not (torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                                for a in bound.arguments.values())):
            return fn(*args, **kwargs)
        outs = []
        for i in range(bound.arguments["q_points"].shape[0]):
            one = {k: (v[i:i + 1] if k in PER_FRAME and v is not None else v) for k, v in bound.arguments.items()}
            outs.append(torch.utils.checkpoint.checkpoint(fn, use_reentrant=False, **one))
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    return wrapper


@checkpointed
def banded_kpconv_fused_plain(
    s_feats, q_points, s_points, weights, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Banded aggregation, then the contraction with the aggregate and W
    rounded to ``dtype`` and fp32 accumulation.  Returns (out (B, M, Cout)
    fp32 unnormalised, count (B, M) int32)."""
    weighted, count = banded_kpconv_aggregate(
        s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )
    out = torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype))
    return out, count


@checkpointed
def banded_kpconv_fused_tau_plain(
    s_feats, q_points, s_points, weights, tau, kp, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """The k-NN (tau) aggregation with the layer's kernel points ``kp``,
    then the contraction in ``dtype`` with fp32 accumulation."""
    weighted, count = banded_kpconv_aggregate(
        s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts, tau=tau, kp=kp,
    )
    return torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype)), count


banded_maxpool_plain = checkpointed(banded_maxpool)


@checkpointed
def banded_maxpool_tau_plain(s_feats, q_points, s_points, tau, tile=128, band_width=1024, starts=None):
    """The max over {d2 <= tau} of each query's band, no radius mask."""
    return banded_maxpool(s_feats, q_points, s_points, 0.0, tile, band_width, starts, tau=tau)


def full_attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (B, L/S, H, D) tensors, fp32 softmax
    and fp32 output."""
    d = q.shape[-1]
    logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) / torch.sqrt(
        torch.tensor(d, dtype=torch.float32, device=q.device)
    )
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhls,bshd->blhd", attn, v.float())


def fused_attention_plain(q, k, v):
    """What the fused attention kernel computes: full attention cast to q's dtype."""
    return full_attention(q, k, v).to(q.dtype)
