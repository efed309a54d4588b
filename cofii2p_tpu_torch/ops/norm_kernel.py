"""The point branch's GroupNorm chain: its CUDA kernels' wrapper and its
plain version.

The JAX package has no kernel here: cofii2p_tpu/models/layers.py's
PointGroupNorm and leaky_relu are plain jnp, which XLA fuses.  The chain a
point block runs after each KPConv or Linear is the whole-cloud GroupNorm,
then, in a residual block's last unary, the shortcut's add, then
LeakyReLU(0.1):

 - :func:`point_group_norm_fused` (csrc/point_norm.cu, two kernels): the
   statistics, mean and rstd per (frame, group) in fp32 from one pass over
   x in its own dtype, the partial sums of each row chunk merged by a
   second kernel in a fixed order, with no atomics (the same bits every
   launch); then the
   apply, one pass that rounds each operation as the plain version does,
   so that given the same statistics its output is bit-equal to the plain
   version's.  Only the statistics' fp32 summation order differs.
 - :func:`point_group_norm_plain`: the plain version, PyTorch's arithmetic
   of the point blocks operation for operation
   (:func:`group_norm_stats_plain`, then :func:`group_norm_apply_plain`).
 - :func:`point_group_norm` picks: the kernels for a tensor off the CPU
   whose blocks run on the kernels (``kernel`` not 'xla') when no autograd
   graph is being recorded through x, the parameters or the residual; the
   plain version otherwise (the CPU, training's forward, ``kernel='xla'``).
   A card tensor the kernels cannot take (:func:`fused_fits`) raises; it
   never falls back.  Each call adds one to the counter
   ``cofii2p.point_norm.fused`` or ``cofii2p.point_norm.plain``.

The kernels' wrapper follows the other wrappers' rules: the plain version
for a CPU tensor, a launch or an error for any other, and a refusal of
inputs that would need autograd history.
"""

from __future__ import annotations

import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.utils.profiling import counter

# csrc/point_norm_plan.cuh: threads a block, row chunks a (frame, slice) in
# the statistics' merge
THREADS = 256
MAX_CHUNKS = 256


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def _grouped(x, g):
    return x.float().reshape(*x.shape[:-1], g, x.shape[-1] // g)


def _stats(xg, eps):
    """mean and rstd of xg (..., N, G, C/G), kept (..., 1, G, 1)."""
    mean = xg.mean(dim=(-3, -1), keepdim=True)
    var = xg.var(dim=(-3, -1), keepdim=True, unbiased=False)
    return mean, torch.rsqrt(var + eps)


def _apply(x, xg, mean, rstd, weight, bias, relu, residual):
    out = ((xg - mean) * rstd).reshape(x.shape)
    out = (out * weight + bias).to(x.dtype)
    if residual is not None:
        out = out + residual
    return leaky_relu(out) if relu else out


def group_norm_stats_plain(x: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """(mean, rstd), each (..., G) fp32: the statistics of each group over
    all N points and its C/G channels of x (..., N, C), biased variance,
    rstd = rsqrt(var + eps)."""
    mean, rstd = _stats(_grouped(x, num_groups), eps)
    return mean[..., 0, :, 0], rstd[..., 0, :, 0]


def group_norm_apply_plain(x, mean, rstd, weight, bias, relu=False, residual=None):
    """((x - mean) * rstd) * weight + bias in fp32, rounded to x's dtype;
    then ``+ residual`` in PyTorch's promotion, then LeakyReLU(0.1) where
    ``relu``."""
    xg = _grouped(x, mean.shape[-1])
    return _apply(x, xg, mean[..., None, :, None], rstd[..., None, :, None], weight, bias, relu, residual)


def point_group_norm_plain(x, weight, bias, num_groups, eps=1e-5, relu=False, residual=None):
    """Plain version of :func:`point_group_norm_fused`: the statistics and
    the apply above with the statistics kept in their reduced shape, so
    that autograd records no more operations than the chain itself."""
    xg = _grouped(x, num_groups)
    return _apply(x, xg, *_stats(xg, eps), weight, bias, relu, residual)


def norm_plan(c: int, g: int, esz: int):
    """The kernels' slices of a row of C channels in G groups at element
    size ``esz``, or None where they do not take the shape; a copy of
    csrc/point_norm_plan.cuh's make_plan."""
    vec = 16 // esz
    if g < 1 or c < 1 or c % g or c % vec:
        return None
    cg, vpr = c // g, c // vec
    if cg % vec and vec % cg:
        return None
    if THREADS % vpr and vpr % THREADS:
        return None
    cs = min(vpr, THREADS)
    if (cs * vec) % cg or THREADS % (cs * vec // cg):
        return None
    return vpr // cs


def _fits(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def fused_fits(x, num_groups, residual=None) -> bool:
    """Whether the kernels take this call: x (B, N, C) bf16 or fp32,
    contiguous and 16-byte aligned, (C, G) in the plan, and a residual of
    x's shape and dtype, contiguous and aligned, or none."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16) or x.numel() == 0 or not _fits(x):
        return False
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device or not _fits(residual)):
        return False
    slices = norm_plan(x.shape[-1], num_groups, x.element_size())
    return slices is not None and x.shape[0] <= 65535


def _check(x, num_groups, residual):
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if not fused_fits(x, num_groups, residual):
        shape = None if residual is None else (tuple(residual.shape), residual.dtype)
        raise ValueError(f"point_norm: x {tuple(x.shape)} {x.dtype} with {num_groups} groups (residual {shape}) "
                         "is not a shape the kernels take (norm_plan, fused_fits)")


def _check_no_grad(*tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("point_group_norm_fused: the CUDA kernels return no autograd history; "
                           "point_group_norm takes the plain version where autograd records")


def point_norm_stats(x, num_groups, eps=1e-5):
    """The statistics kernels alone (the chunks' partials, then their
    merge): (mean, rstd), each (B, G) fp32, of x (B, N, C) on the card."""
    _check(x, num_groups, None)
    b = x.shape[0]
    mean = torch.empty(b, num_groups, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    part = torch.empty(b * num_groups * MAX_CHUNKS * 2, dtype=torch.float32, device=x.device)
    err = cuda_lib.lib().point_norm_stats_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), part.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b,
        x.shape[1], x.shape[2], num_groups, float(eps), cuda_lib.stream_of(x),
    )
    cuda_lib.check(err, "point_norm_stats")
    return mean, rstd


def point_norm_apply(x, mean, rstd, weight, bias, relu=False, residual=None):
    """The apply kernel alone, on the card: :func:`group_norm_apply_plain`'s
    result, bit for bit, for mean and rstd (B, G) fp32."""
    _check(x, mean.shape[-1], residual)
    b, n, c = x.shape
    g = mean.shape[-1]
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    if mean.shape != (b, g) or rstd.shape != (b, g) or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("point_norm: mean, rstd must be (B, G) and weight, bias (C,)")
    out = torch.empty_like(x)
    err = cuda_lib.lib().point_norm_apply_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), 0 if residual is None else residual.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), out.data_ptr(), b, n, c, g,
        int(bool(relu)), cuda_lib.stream_of(x),
    )
    cuda_lib.check(err, "point_norm_apply")
    return out


def point_group_norm_fused(x, weight, bias, num_groups, eps=1e-5, relu=False, residual=None):
    """The GroupNorm chain on the card: x (B, N, C) bf16 or fp32 grouped
    into ``num_groups``, weight and bias (C,); LeakyReLU(0.1) where
    ``relu``, after the residual's add where a residual (x's shape and
    dtype) is given.  Returns x's shape and dtype."""
    if x.device.type == "cpu":
        return point_group_norm_plain(x, weight, bias, num_groups, eps, relu, residual)
    _check_no_grad(x, weight, bias, residual)
    _check(x, num_groups, residual)
    mean, rstd = point_norm_stats(x, num_groups, eps)
    out = point_norm_apply(x, mean, rstd, weight, bias, relu, residual)
    point_group_norm_fused.launches += 1
    return out


point_group_norm_fused.launches = 0


def point_group_norm(x, weight, bias, num_groups, eps=1e-5, relu=False, residual=None, kernel="auto"):
    """The point blocks' GroupNorm chain (module docstring): the kernels or
    the plain version, and the counter that says which."""
    records = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias, residual))
    if kernel != "xla" and x.device.type != "cpu" and not records:
        counter("cofii2p.point_norm.fused").add()
        return point_group_norm_fused(x, weight, bias, num_groups, eps, relu, residual)
    counter("cofii2p.point_norm.plain").add()
    return point_group_norm_plain(x, weight, bias, num_groups, eps, relu, residual)
