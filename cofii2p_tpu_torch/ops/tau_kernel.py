"""The banded k-NN threshold (tau): the CUDA kernel's wrapper and its plain
version.

Counterpart of cofii2p_tpu/ops/tau_kernel.py.  :func:`banded_knn_tau_kernel`
(csrc/knn_tau.cu, kernel #5; replaces banded_knn_tau_pallas) gives each
query of a band tile the threshold tau = max(0.5 * (kth + nxt),
kth * (1 + 1e-5) + 1e-12) from the kk-th and (kk+1)-th smallest band d2,
bit-equal to the plain version ops/banded.py::banded_knn_tau; the kernel
takes its block (queries, warps, whether d2 is kept) from
csrc/knn_tau_plan.cuh.  Unlike the
TPU kernel it also takes dynamic window ``starts``, so the windowed tau of
``kpconv_knn_window_plan`` runs through it too.

The wrapper takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no other fallback.  tau is a function
of coordinates only and has no gradient.
"""

from __future__ import annotations

import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import band_plan, banded_knn_tau
from cofii2p_tpu_torch.ops.kpconv_kernel import _check_cuda, _starts_arg

MAX_BAND = 16384  # band rows whose coordinates fit the kernel's shared memory (kTauMaxBand)

banded_knn_tau_plain = banded_knn_tau


def banded_knn_tau_kernel(q_points, s_points, k=128, tile=128, band_width=1024, starts=None):
    """Per-query k-NN threshold over the band (kernel #5): q_points
    (B, M, 3), s_points (B, N, 3) fp32, optional window ``starts``
    (B, num_tiles) of width ``band_width``.  Returns tau (B, M) fp32."""
    if q_points.device.type == "cpu":
        return banded_knn_tau_plain(q_points, s_points, k, tile, band_width, starts)
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if s_points.shape[0] != b or q_points.shape[-1] != 3 or s_points.shape[-1] != 3:
        raise ValueError("shape mismatch between the query and support points")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    if band > MAX_BAND:
        raise ValueError(f"band of {band} rows > {MAX_BAND}")
    st = _starts_arg(m, n, tile, band, num_tiles, b, q_points.device, starts)
    _check_cuda(q_points=q_points, s_points=s_points, starts=st)
    tau = torch.empty(b, m, dtype=torch.float32, device=q_points.device)
    err = cuda_lib.lib().knn_tau_launch(
        q_points.data_ptr(), s_points.data_ptr(), st.data_ptr(), tau.data_ptr(),
        b, m, n, tile, num_tiles, band, min(k, band),
        cuda_lib.stream_of(q_points),
    )
    cuda_lib.check(err, "knn_tau")
    banded_knn_tau_kernel.launches += 1
    return tau


banded_knn_tau_kernel.launches = 0
