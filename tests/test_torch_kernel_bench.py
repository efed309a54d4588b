"""kernel_bench's bounds and yardsticks on the CPU: what it computes from
shapes and data, with no card (the times themselves come only from the
card).  The fp32 tensor-core KPConvs (#7, #6, the aggregate #2 and the tau
transpose #11) take their products at the 3xTF32 rate, every other fp32
kernel at the CUDA cores' 67 TFLOP/s, and the transposes on static bands
and windows (#9, #10) at 67 in both precisions; the library call timed
beside the fused attention computes the same function."""

import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.ops.attention_kernel import fused_attention_plain
from cofii2p_tpu_torch.ops.banded import banded_pair_count, dynamic_band_starts, kernel_reach, tau_reach2
from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_plain
from cofii2p_tpu_torch.utils import kernel_bench as kb


def inputs(seed=0, m=256, c=32):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor((rng.random((2, m, 3)) * 10).astype(np.float32))
    f = torch.as_tensor(rng.standard_normal((2, m, c)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((15, c, c)).astype(np.float32))
    kp = torch.as_tensor((rng.standard_normal((15, 3)) * 0.5).astype(np.float32))
    return q, f, w, kp, banded_knn_tau_plain(q, q, 16, 128, 64)


def test_tau_kpconv_products_take_the_tf32x3_rate():
    """#7's bound: the influence math at fp32, both products at 495/3
    TFLOP/s; #6's the same without the contraction, against its bytes."""
    q, f, w, kp, tau = inputs()
    pairs = float(banded_pair_count(q, q, tau_reach2(1.7, 0.8) ** 0.5, 128, 64, None, tau).sum())
    ms, by = kb.call_bound("banded_kpconv_fused_tau", (f, q, q, w, tau, kp, 1.7, 0.8, 15, 128, 64))
    infl, mma = pairs * 15 * kb.INFL_OPS, 2.0 * pairs * 15 * 32 + 2.0 * 2 * 256 * 15 * 32 * 32
    assert by == "operations"
    assert ms == pytest.approx((infl / kb.FP32_OPS + mma / kb.TF32X3_OPS) * 1e3, rel=1e-9)
    assert kb.TF32X3_OPS == pytest.approx(495e12 / 3)
    ms6, _ = kb.call_bound("banded_kpconv_aggregate_tau", (f, q, q, tau, kp, 1.7, 0.8, 15, 128, 64))
    io = 2 * 512 * 3 * 4 + f.numel() * 4 + 2 * 256 * (15 * 32 + 1) * 4 + tau.numel() * 4 + 15 * 3 * 4
    assert ms6 == pytest.approx(max(io / kb.HBM_BPS, infl / kb.FP32_OPS + 2.0 * pairs * 15 * 32 / kb.TF32X3_OPS) * 1e3)


def test_other_fp32_kernels_keep_the_cuda_core_rate():
    """#1 in fp32 runs its products on the CUDA cores: all its operations
    at 67 TFLOP/s; in bf16 its products at 989."""
    q, f, w, _, _ = inputs()
    pairs = float(banded_pair_count(q, q, kernel_reach(1.7, 0.8), 128, 64).sum())
    infl, mma = pairs * 15 * kb.INFL_OPS, 2.0 * pairs * 15 * 32 + 2.0 * 2 * 256 * 15 * 32 * 32
    ms, _ = kb.call_bound("banded_kpconv_fused", (f, q, q, w, 1.7, 0.8, 15, 128, 64))
    assert ms == pytest.approx((infl + mma) / kb.FP32_OPS * 1e3, rel=1e-9)
    ms16, _ = kb.call_bound("banded_kpconv_fused", (f.bfloat16(), q, q, w, 1.7, 0.8, 15, 128, 64, torch.bfloat16))
    io = 2 * 512 * 3 * 4 + f.numel() * 2 + w.numel() * 4 + 2 * 256 * 33 * 4
    assert ms16 == pytest.approx(max(io / kb.HBM_BPS, infl / kb.FP32_OPS + mma / kb.BF16_MMA_OPS) * 1e3, rel=1e-9)


def test_attention_library_call_computes_the_same_function():
    """The yardstick beside #4 (scaled_dot_product_attention, heads second)
    gives the plain version's output on the same (B, L, H, D) inputs; no
    other kernel has one."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, 4, 32, generator=g) for _ in range(3))
    lib = kb.library_call("fused_attention", (q, k, v), {})
    torch.testing.assert_close(lib().transpose(1, 2), fused_attention_plain(q, k, v), rtol=1e-5, atol=1e-6)
    q2, f, w, kp, tau = inputs()
    assert kb.library_call("banded_kpconv_fused_tau", (f, q2, q2, w, tau, kp, 1.7, 0.8), {}) is None


def test_aggregate_and_tau_transpose_take_the_tf32x3_rate():
    """#2 (the radius aggregate) and #11 (the tau transpose) run their fp32
    products by 3xTF32 since they moved to the tensor cores: the influence
    math at fp32, the products at 495/3 TFLOP/s, against their bytes; in
    bf16 the products at 989."""
    q, f, w, kp, tau = inputs()
    pairs = float(banded_pair_count(q, q, kernel_reach(1.7, 0.8), 128, 64).sum())
    infl, agg = pairs * 15 * kb.INFL_OPS, 2.0 * pairs * 15 * 32
    io = 2 * 512 * 3 * 4 + f.numel() * 4 + 2 * 256 * (15 * 32 + 1) * 4
    ms2, _ = kb.call_bound("banded_kpconv_aggregate_fused", (f, q, q, 1.7, 0.8, 15, 128, 64))
    assert ms2 == pytest.approx(max(io / kb.HBM_BPS, infl / kb.FP32_OPS + agg / kb.TF32X3_OPS) * 1e3, rel=1e-9)
    ms2h, _ = kb.call_bound("banded_kpconv_aggregate_fused", (f, q, q, 1.7, 0.8, 15, 128, 64, torch.bfloat16))
    assert ms2h == pytest.approx(max(io / kb.HBM_BPS, infl / kb.FP32_OPS + agg / kb.BF16_MMA_OPS) * 1e3, rel=1e-9)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 256, 15, 32)).astype(np.float32))
    tpairs = float(banded_pair_count(q, q, tau_reach2(1.7, 0.8) ** 0.5, 128, 64, None, tau).sum())
    tio = 2 * 512 * 3 * 4 + tau.numel() * 4 + 15 * 3 * 4 + g.numel() * 4 + 2 * 256 * 32 * 4
    ms11, by = kb.call_bound("banded_kpconv_transpose_tau_fused", (g, q, q, tau, kp, 1.7, 0.8, 15, 128, 64))
    t_ops = tpairs * 15 * kb.INFL_OPS / kb.FP32_OPS + 2.0 * tpairs * 15 * 32 / kb.TF32X3_OPS
    assert ms11 == pytest.approx(max(tio / kb.HBM_BPS, t_ops) * 1e3, rel=1e-9)
    assert by == ("bytes" if tio / kb.HBM_BPS >= t_ops else "operations")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_and_window_transposes_keep_the_cuda_core_rate(dtype):
    """#9 (static bands) and #10 (windows) still multiply on the CUDA cores,
    in either precision: the influence math and the products at 67 TFLOP/s."""
    q, _, _, _, _ = inputs()
    g = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 256, 15, 32)).astype(np.float32))
    pairs = float(banded_pair_count(q, q, kernel_reach(1.7, 0.8), 128, 64).sum())
    io = 2 * 512 * 3 * 4 + g.numel() * 4 + 2 * 256 * 32 * 4
    ms9, _ = kb.call_bound("banded_kpconv_transpose_fused", (g, q, q, 1.7, 0.8, 15, 128, 64, dtype))
    assert ms9 == pytest.approx(max(io / kb.HBM_BPS, pairs * 15 * (2 * 32 + kb.INFL_OPS) / kb.FP32_OPS) * 1e3,
                                rel=1e-9)
    starts = dynamic_band_starts(q, q, kernel_reach(1.7, 0.8), 128, 64, "best", 1)
    wpairs = float(banded_pair_count(q, q, kernel_reach(1.7, 0.8), 128, 64, starts).sum())
    ms10, _ = kb.call_bound("banded_kpconv_transpose_dyn_fused", (g, q, q, starts, 1.7, 0.8, 15, 128, 64, dtype))
    wio = io + starts.numel() * 4
    assert ms10 == pytest.approx(max(wio / kb.HBM_BPS, wpairs * 15 * (2 * 32 + kb.INFL_OPS) / kb.FP32_OPS) * 1e3,
                                 rel=1e-9)
