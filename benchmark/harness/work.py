"""The yardstick's arithmetic: the work a layer must do, counted from the
configuration's shapes and each input's in-reach pairs, never from which
kernels the program happens to launch.

Peaks are the NVIDIA H100 SXM data sheet's dense rates: HBM 3.35 TB/s,
fp32 on the CUDA cores 67 TFLOP/s, bf16 on the tensor cores 989 TFLOP/s,
an fp32 product by three TF32 products 495/3 TFLOP/s (the rate of every
fp32 product the port computes within its gates).  A layer's least time is
the larger of its bytes over the HBM rate and its operations over the peak
of their type (a frozen copy of cofii2p_tpu_torch/utils/kernel_bench.py::
bound_ms and call_work).

FLOPs follow cofii2p_tpu_torch/evaluation/get_flops_fps.py's convention:
``torch.utils.flop_counter`` over the library operations of one forward
(a product is two operations), plus, for each banded KPConv, shortcut
maxpool, k-NN threshold and fused attention, the operations counted from
its inputs as below.  The forward is the plain reference's
(benchmark/reference), with those layers replaced by counting stubs.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.flop_counter import FlopCounterMode

HBM_BPS, FP32_OPS, BF16_MMA_OPS, TF32X3_OPS = 3.35e12, 67e12, 989e12, 495e12 / 3
INFL_OPS = 15  # operations of one kernel point's influence on one (query, row) pair
PEAK_FLOPS = {"bfloat16": BF16_MMA_OPS, "float32": TF32X3_OPS}


def bound_ms(nbytes, ops32=0.0, ops16=0.0, ops_tf32x3=0.0) -> float:
    t_bytes = nbytes / HBM_BPS
    t_ops = ops32 / FP32_OPS + ops16 / BF16_MMA_OPS + ops_tf32x3 / TF32X3_OPS
    return max(t_bytes, t_ops) * 1e3


def kpconv_work(b, m, n, cin, cout, ks, pairs, fbytes, bf16, extra_bytes=0, backward=False) -> dict:
    """Bytes and operations of one banded KPConv over ``pairs`` in-reach
    (query, band row) pairs: the influence of every kernel point on every
    pair (CUDA cores), the aggregation and the contraction (tensor cores);
    with ``backward``, also the transposed aggregation and the two
    contractions of the gradient."""
    infl = pairs * ks * INFL_OPS
    prod = 2.0 * pairs * ks * cin + 2.0 * b * m * ks * cin * cout
    io = b * (m + n) * 3 * 4 + extra_bytes + n * b * cin * fbytes + ks * cin * cout * 4 + b * m * (cout + 1) * 4
    if backward:
        infl *= 2
        prod += 2.0 * pairs * ks * cin + 4.0 * b * m * ks * cin * cout
        io += b * m * ks * cin * 4 + b * n * cin * 4 + b * m * cout * 4 + ks * cin * cout * 4
    key = "ops16" if bf16 else "ops_tf32x3"
    return {"nbytes": float(io), "ops32": float(infl), key: float(prod)}


class Counter:
    """Counting stubs for the reference's banded layers and its attention,
    installed on the reference's modules while :meth:`count` runs."""

    def __init__(self, precision: str, attention: str):
        self.bf16 = precision == "bfloat16"
        self.fused_attention = attention == "pallas"
        self.flops = 0.0  # operations counted from inputs
        self.kpconv_bound_ms = 0.0
        self.kpconv_bound_ms_train = 0.0
        self.inside = 0.0  # what the library counter saw inside a stub
        self.counter = None

    @contextlib.contextmanager
    def _inside(self):
        before = self.counter.get_total_flops()
        try:
            yield
        finally:
            self.inside += self.counter.get_total_flops() - before

    def _add(self, w: dict):
        self.flops += w["ops32"] + w.get("ops16", 0.0) + w.get("ops_tf32x3", 0.0)

    def _kpconv(self, s_feats, q_points, s_points, weights, reach, tile, band_width, starts, tau, kp):
        from benchmark.reference.ops.banded import banded_pair_count

        with self._inside():
            pairs = float(banded_pair_count(q_points, s_points, reach, tile, band_width, starts, tau).sum())
        b, m = q_points.shape[:2]
        n = s_points.shape[1]
        ks, cin, cout = weights.shape
        extra = (0 if starts is None else starts.numel() * 4) + (0 if tau is None else tau.numel() * 4 + ks * 12)
        fbytes = 2 if self.bf16 else 4
        fwd = kpconv_work(b, m, n, cin, cout, ks, pairs, fbytes, self.bf16, extra)
        self._add(fwd)
        self.kpconv_bound_ms += bound_ms(**fwd)
        self.kpconv_bound_ms_train += bound_ms(**kpconv_work(b, m, n, cin, cout, ks, pairs, fbytes, self.bf16,
                                                             extra, backward=True))
        out = torch.zeros(b, m, cout, device=s_feats.device, requires_grad=s_feats.requires_grad)
        return out, torch.ones(b, m, dtype=torch.int32, device=s_feats.device)

    def _maxpool(self, s_feats, q_points, s_points, reach, tile, band_width, starts, tau):
        from benchmark.reference.ops.banded import banded_pair_count

        with self._inside():
            pairs = float(banded_pair_count(q_points, s_points, reach, tile, band_width, starts, tau).sum())
        self.flops += pairs * s_feats.shape[-1]
        return torch.zeros(*q_points.shape[:2], s_feats.shape[-1], device=s_feats.device)

    @contextlib.contextmanager
    def installed(self):
        from benchmark.reference.models import kpconv as K
        from benchmark.reference.models import transformer as T
        from benchmark.reference.ops.banded import band_plan, kernel_reach, tau_reach2

        def kp_radius(s_feats, q_points, s_points, weights, radius, sigma, kernel_size=15, tile=128,
                      band_width=1024, dtype=torch.float32, starts=None):
            return self._kpconv(s_feats, q_points, s_points, weights, kernel_reach(radius, sigma, kernel_size),
                                tile, band_width, starts, None, None)

        def kp_tau(s_feats, q_points, s_points, weights, tau, kp, radius, sigma, kernel_size=15, tile=128,
                   band_width=1024, dtype=torch.float32, starts=None):
            return self._kpconv(s_feats, q_points, s_points, weights, tau_reach2(radius, sigma, kernel_size) ** 0.5,
                                tile, band_width, starts, tau, kp)

        def mp_radius(s_feats, q_points, s_points, r_active, tile=128, band_width=1024, starts=None):
            return self._maxpool(s_feats, q_points, s_points, r_active, tile, band_width, starts, None)

        def mp_tau(s_feats, q_points, s_points, tau, tile=128, band_width=1024, starts=None):
            return self._maxpool(s_feats, q_points, s_points, None, tile, band_width, starts, tau)

        knn_tau = K.banded_knn_tau

        def tau_stub(q_points, s_points, k=128, tile=128, band_width=1024, starts=None):
            b, m = q_points.shape[:2]
            band = band_plan(m, s_points.shape[1], tile, band_width, starts)[2]
            self.flops += 9.0 * b * m * band  # one d2 and one comparison per (query, band row)
            with self._inside():
                return knn_tau(q_points, s_points, k, tile, band_width, starts)

        attn_full, attn_fused = T.full_attention, T.fused_attention_plain

        def attention(q, k, v, _fn):
            b, l, h, _ = q.shape
            if self.fused_attention:
                self.flops += 5.0 * b * h * l * k.shape[1]  # scale, max, exp, sum, divide
            return _fn(q, k, v)

        saved = [(K, "banded_kpconv_fused_plain", kp_radius), (K, "banded_kpconv_fused_tau_plain", kp_tau),
                 (K, "banded_maxpool_plain", mp_radius), (K, "banded_maxpool_tau_plain", mp_tau),
                 (K, "banded_knn_tau", tau_stub),
                 (T, "full_attention", lambda q, k, v: attention(q, k, v, attn_full)),
                 (T, "fused_attention_plain", lambda q, k, v: attention(q, k, v, attn_fused))]
        old = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in old:
                setattr(mod, name, fn)

    def count(self, fn):
        """Runs ``fn`` with the stubs and the library counter on; returns
        (FLOPs, least time of the KPConv layers' forward in ms, and of
        their forward and backward)."""
        self.flops = self.kpconv_bound_ms = self.kpconv_bound_ms_train = self.inside = 0.0
        self.counter = FlopCounterMode(display=False)
        with self.installed(), self.counter:
            fn()
        total = self.counter.get_total_flops() - self.inside + self.flops
        return total, self.kpconv_bound_ms, self.kpconv_bound_ms_train
