"""The dynamic windows' placement: kernel #19's wrapper.

The JAX package has no kernel here: cofii2p_tpu/ops/banded.py's
dynamic_band_starts and dynamic_knn_starts are plain jnp, which XLA fuses.
The port's plain version, ops/banded.py::_best_windows, places each query
tile's width-W window of support rows holding the most (query, sampled
row) pairs with d2 <= a threshold; PyTorch runs it as ~8 full-size fp32
broadcast passes over every pair.

:func:`best_windows_fused` (csrc/window_starts.cu) launches once a
(query level, support level) pair, one block a (query tile, frame), and
returns the plain version's starts bit for bit.  The threshold is one float
(``dynamic_band_starts``, radius semantics) or one fp32 value a query,
(B, M) (``dynamic_knn_starts``); the kernel's build follows the argument it
is given.  ops/banded.py::_windows calls it for any tensor off the CPU and
the plain version on the CPU, and counts which in
``cofii2p.windows.kernel`` or ``cofii2p.windows.plain``.  A card tensor the
kernel does not take raises; it never falls back.

The starts are integers with no gradient, so the wrapper takes points that
require grad (training's windows, ``train --fast``) as they are.
"""

from __future__ import annotations

import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import _best_windows, _dyn_tile

# csrc/window_starts.cuh: the most queries a tile and sampled rows a launch
# takes (kMaxTile, kMaxRows)
MAX_TILE = 1024
MAX_ROWS = 98304


def _points(name, x, device):
    if x.device != device or x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"window_starts: {name} must be contiguous fp32 (B, n, 3) on {device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}, contiguous {x.is_contiguous()}")


def _check(q_points, s_points, threshold, tile, width, stride):
    """(tile, num_tiles) of a call the kernel takes; raises ValueError for
    any other."""
    dev = q_points.device
    if dev.type != "cuda":
        raise ValueError(f"window_starts: the points must be CUDA tensors, got {dev}")
    _points("q_points", q_points, dev)
    _points("s_points", s_points, dev)
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    if s_points.shape[0] != b or not 1 <= b <= 65535 or m < 1 or n < 1 or tile < 1 or width < 1 or stride < 1:
        raise ValueError(f"window_starts: q {tuple(q_points.shape)}, s {tuple(s_points.shape)}, tile {tile}, "
                         f"width {width}, stride {stride} is not a call the kernel takes")
    if isinstance(threshold, torch.Tensor) and (
            threshold.device != dev or threshold.shape != (b, m) or threshold.dtype != torch.float32
            or not threshold.is_contiguous()):
        raise ValueError(f"window_starts: a threshold tensor must be contiguous fp32 (B, M) = {(b, m)} on {dev}, "
                         f"got {tuple(threshold.shape)} {threshold.dtype} on {threshold.device}")
    tile, num_tiles = _dyn_tile(m, tile)
    n_sub = -(-n // stride)
    if tile > MAX_TILE or n_sub > MAX_ROWS:
        raise ValueError(f"window_starts: a tile of {tile} queries (<= {MAX_TILE}) over {n_sub} sampled rows "
                         f"(<= {MAX_ROWS}) does not fit the kernel's shared memory")
    return tile, num_tiles


def best_windows_fused(q_points, s_points, threshold, tile=128, width=256, stride=1):
    """Kernel #19: each query tile's window start, (B, num_tiles) int32, of
    q_points (B, M, 3) over s_points (B, N, 3), both contiguous fp32, with
    ``threshold`` one float or (B, M) fp32; :func:`ops.banded._best_windows`
    on the CPU."""
    if q_points.device.type == "cpu":
        return _best_windows(q_points, s_points, threshold, tile, width, stride)
    tile, num_tiles = _check(q_points, s_points, threshold, tile, width, stride)
    b, m = q_points.shape[:2]
    per_query = isinstance(threshold, torch.Tensor)
    out = torch.empty(b, num_tiles, dtype=torch.int32, device=q_points.device)
    err = cuda_lib.lib().window_starts_launch(
        q_points.data_ptr(), s_points.data_ptr(), threshold.data_ptr() if per_query else None,
        0.0 if per_query else float(threshold), out.data_ptr(), b, m, s_points.shape[1], tile, stride, width,
        cuda_lib.stream_of(q_points),
    )
    cuda_lib.check(err, "window_starts")
    best_windows_fused.launches += 1
    return out


best_windows_fused.launches = 0

