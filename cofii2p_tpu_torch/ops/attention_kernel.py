"""Fused softmax attention: the CUDA kernel's wrapper and its plain version.

Counterpart of cofii2p_tpu/ops/attention_kernel.py::fused_attention.  Like
the TPU kernel, the output is in q's dtype: bf16 under bf16 serving, where
``full_attention`` returns fp32 (a known difference between the two JAX
attention options, kept as it is).

:func:`fused_attention` takes the plain version for a CPU tensor and
launches the kernel (csrc/attention.cu: on the tensor cores, bf16 on bf16
products, fp32 by 3xTF32) for a CUDA tensor; there is no other fallback.
The JAX package has no backward for this kernel, so on the card it
refuses inputs that require grad under grad mode (training uses
``attention='full'``).
"""

from __future__ import annotations

import functools

import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.kpconv_kernel import check_no_grad

HEAD_DIM = 32  # the head width the kernel takes


@functools.lru_cache(maxsize=None)
def _sqrt_on(d: int, device) -> torch.Tensor:
    """sqrt(d) as an fp32 scalar tensor kept on ``device``: a division by
    it rounds as JAX's does (by a Python float the card would multiply by
    its reciprocal), and no copy from the host waits for the card."""
    return torch.sqrt(torch.tensor(d, dtype=torch.float32, device=device))


def full_attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (B, L/S, H, D) tensors, fp32 softmax
    and fp32 output (cofii2p_tpu/models/transformer.py::full_attention)."""
    logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) / _sqrt_on(q.shape[-1], q.device)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhls,bshd->blhd", attn, v.float())


def fused_attention_plain(q, k, v):
    """Plain version of the fused kernel: full attention cast to q's dtype."""
    return full_attention(q, k, v).to(q.dtype)


def fused_attention(q, k, v):
    """Softmax attention (B, L, H, D) x (B, S, H, D) -> (B, L, H, D) in q's
    dtype."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v)
    check_no_grad("fused_attention (no backward exists; train with attention='full')", q, k, v)
    b, l, h, d = q.shape
    s = k.shape[1]
    if d != HEAD_DIM:
        raise ValueError(f"head width {d} not supported (kernel takes {HEAD_DIM})")
    if k.shape != (b, s, h, d) or v.shape != k.shape:
        raise ValueError("q, k, v shapes disagree")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must all be float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        # both bodies read k and v in 16-byte copies
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    bf16 = int(q.dtype == torch.bfloat16)
    err = cuda_lib.lib().attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bf16, bf16,
        b, l, s, h, d, cuda_lib.stream_of(q),
    )
    cuda_lib.check(err, "attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
