"""Per-call times of the port's CUDA kernels on the serving or training path.

    python -m cofii2p_tpu_torch.utils.kernel_bench [--path serve|train] [--batch 8] [--reps 10]

``serve`` runs one forward of bench.py's serving config (bf16 w192,
fused attention); ``train`` one fp32 training step of the default
KITTIConfig (static bands), forward and backward.  Both use seeded random
weights and synthetic KITTI-shaped frames.  Every call of a kernel wrapper
is recorded with its arguments, then replayed on its own: the kernel and
its plain PyTorch version are timed with CUDA events, and the call's bound
is computed from its inputs (the least time the card could take: the
larger of the bytes moved over the HBM rate and the operations over the
peak rate of their type).  One line per call, then per-kernel totals.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import subprocess

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; fp32 outside the
# tensor cores, which every non-matmul operation is counted at; bf16 matmul
HBM_BPS, FP32_OPS, BF16_MMA_OPS = 3.35e12, 67e12, 989e12
INFL_OPS = 15  # operations of one kernel point's influence on one (query, row) pair


def time_ms(fn, reps=10):
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes, ops32=0.0, ops16=0.0):
    """(ms, 'bytes' | 'operations'): the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BPS
    t_ops = ops32 / FP32_OPS + ops16 / BF16_MMA_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _pairs(q, s, r_active, tile, width, starts=None) -> float:
    """In-reach (query, band row) pairs of these inputs."""
    from cofii2p_tpu_torch.ops.banded import banded_pair_count

    return float(banded_pair_count(q, s, r_active, tile, width, starts).sum())


def kernel_wrappers() -> dict:
    """Every kernel wrapper by name, with its plain version and the module
    attribute the model's path looks it up through."""
    from cofii2p_tpu_torch.models import transformer as tf
    from cofii2p_tpu_torch.ops import attention_kernel as att
    from cofii2p_tpu_torch.ops import kpconv_kernel as kpk
    from cofii2p_tpu_torch.ops import maxpool_kernel as mpk

    return {
        "banded_kpconv_fused": (kpk, kpk.banded_kpconv_fused, kpk.banded_kpconv_fused_plain),
        "banded_kpconv_aggregate_fused": (kpk, kpk.banded_kpconv_aggregate_fused, kpk.banded_kpconv_aggregate_plain),
        "banded_kpconv_transpose_fused": (kpk, kpk.banded_kpconv_transpose_fused, kpk.banded_kpconv_transpose_plain),
        "banded_maxpool_fused": (mpk, mpk.banded_maxpool_fused, mpk.banded_maxpool_plain),
        "banded_maxpool_tie_count_fused": (mpk, mpk.banded_maxpool_tie_count_fused,
                                           mpk.banded_maxpool_tie_count_plain),
        "banded_maxpool_backward_fused": (mpk, mpk.banded_maxpool_backward_fused, mpk.banded_maxpool_route_plain),
        "fused_attention": (tf, att.fused_attention, att.fused_attention_plain),
    }


def call_bound(name: str, args, kwargs=None):
    """Bound of one call of the wrapper ``name`` on these arguments."""
    from cofii2p_tpu_torch.ops.banded import kernel_reach

    fn = kernel_wrappers()[name][1]
    a = inspect.signature(fn).bind(*args, **(kwargs or {}))
    a.apply_defaults()
    a = a.arguments
    if name == "fused_attention":
        q, k = a["q"], a["k"]
        b, l, h, d = q.shape
        s = k.shape[1]
        mma = 4.0 * b * h * l * s * d
        io = (q.numel() * 2 + k.numel() * 2) * q.element_size()
        return bound_ms(io, ops32=5.0 * b * h * l * s + (0 if q.dtype == torch.bfloat16 else mma),
                        ops16=mma if q.dtype == torch.bfloat16 else 0.0)
    q, s = a["q_points"], a["s_points"]
    b, m = q.shape[:2]
    n = s.shape[1]
    pts = b * (m + n) * 3 * 4
    starts = a.get("starts")
    if name.startswith("banded_kpconv"):
        ks, tile, bw = a["kernel_size"], a["tile"], a["band_width"]
        pairs = _pairs(q, s, kernel_reach(a["radius"], a["sigma"], ks), tile, bw, starts)
        mma16 = a["dtype"] == torch.bfloat16
        if name == "banded_kpconv_transpose_fused":
            g = a["g_weighted"]
            c = g.shape[-1]
            return bound_ms(pts + g.numel() * 4 + b * n * c * 4, ops32=pairs * ks * (2 * c + INFL_OPS))
        f = a["s_feats"]
        cin = f.shape[-1]
        infl = pairs * ks * INFL_OPS
        agg = 2.0 * pairs * ks * cin
        if name == "banded_kpconv_aggregate_fused":
            io = pts + f.numel() * f.element_size() + b * m * (ks * cin + 1) * 4
            return bound_ms(io, ops32=infl + (0 if mma16 else agg), ops16=agg if mma16 else 0.0)
        w = a["weights"]
        cout = w.shape[-1]
        mma = agg + 2.0 * b * m * ks * cin * cout
        io = pts + f.numel() * f.element_size() + w.numel() * 4 + b * m * (cout + 1) * 4
        return bound_ms(io, ops32=infl + (0 if mma16 else mma), ops16=mma if mma16 else 0.0)
    f = a["s_feats"]
    c = f.shape[-1]
    pairs = _pairs(q, s, a["r_active"], a["tile"], a["band_width"], starts)
    fbytes = f.numel() * f.element_size()
    if name == "banded_maxpool_fused":
        return bound_ms(pts + fbytes + b * m * c * f.element_size(), ops32=pairs * c)
    out_bytes = a["out"].numel() * a["out"].element_size()
    if name == "banded_maxpool_tie_count_fused":
        return bound_ms(pts + fbytes + out_bytes + b * m * c * 4, ops32=2.0 * pairs * c)
    return bound_ms(pts + fbytes + out_bytes + b * m * c * 4 + b * n * c * 4, ops32=2.0 * pairs * c)


@contextlib.contextmanager
def recording(calls):
    """Record (name, args, kwargs) of every kernel-wrapper call the model's
    path makes (forward and backward)."""
    patched = []
    for name, (mod, fn, _) in kernel_wrappers().items():
        def rec(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, args, kwargs))
            return _fn(*args, **kwargs)

        # the wrapper counts its launches on the module attribute it is
        # found by, which is the recorder while this context is open
        rec.launches = 0
        patched.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        yield
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def _describe(name, args, kwargs):
    fn = kernel_wrappers()[name][1]
    a = inspect.signature(fn).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    if name == "fused_attention":
        return f"q {tuple(a['q'].shape)} kv {a['k'].shape[1]} {a['q'].dtype}"
    lead = a.get("s_feats", a.get("g_weighted"))
    band = ("w%d" if a.get("starts") is not None else "bw%d") % a["band_width"]
    extra = f" Cout {a['weights'].shape[-1]}" if "weights" in a else ""
    return f"M {a['q_points'].shape[1]} N {a['s_points'].shape[1]} C {lead.shape[-1]}{extra} {band} {lead.dtype}"


def record_serve(batch, seed, dev):
    from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize

    cfg = KITTIConfig(compute_dtype="bfloat16", kpconv_dynamic_plan=SERVE_DYNAMIC_PLAN,
                      kpconv_dynamic_plan_self=SERVE_DYNAMIC_PLAN_SELF, attention="pallas")
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(dev).eval()
    hb = _frames(cfg, batch, dev)
    draws = make_draws(cfg, batch, torch.Generator(dev).manual_seed(seed), dev)
    calls = []
    with torch.no_grad():
        b = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
        with recording(calls):
            model(b)
    return calls


def record_train(batch, seed, dev):
    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.config import KITTIConfig
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize

    cfg = KITTIConfig()
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(dev)
    hb = _frames(cfg, batch, dev)
    draws = train_lib.make_train_draws(cfg, batch, torch.Generator(dev).manual_seed(seed), dev)
    calls = []
    with torch.no_grad():
        b = train_lib.prepare_batch(cfg, hb, draws)
    with recording(calls):
        train_lib.loss_fn(cfg, model, b)["loss"].backward()
    return calls


def _frames(cfg, batch, dev):
    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(cfg, "val", length=batch)
    hb = _collate([ds[i] for i in range(batch)])
    return {k: torch.as_tensor(v).to(dev) for k, v in hb.items() if k != "index"}


def main():
    ap = argparse.ArgumentParser(description="time the port's kernels on the serving or training path")
    ap.add_argument("--path", choices=("serve", "train"), default="serve")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    calls = (record_serve if args.path == "serve" else record_train)(args.batch, args.seed, dev)
    torch.cuda.synchronize()

    wrappers = kernel_wrappers()
    totals = {}
    with torch.no_grad():
        for name, a, kw in calls:
            _, kern, plain = wrappers[name]
            k_ms = time_ms(lambda: kern(*a, **kw), args.reps)
            p_ms = time_ms(lambda: plain(*a, **kw), max(1, args.reps // 3))
            b_ms, by = call_bound(name, a, kw)
            t = totals.setdefault(name, [0, 0.0, 0.0, 0.0])
            t[0] += 1
            t[1] += k_ms
            t[2] += p_ms
            t[3] += b_ms
            print(f"{name:32s} {_describe(name, a, kw):52s} kernel {k_ms:8.3f} ms  plain {p_ms:8.3f} ms  "
                  f"bound {b_ms:7.3f} ms ({by})", flush=True)
    for name, (n, k_ms, p_ms, b_ms) in totals.items():
        print(f"TOTAL {name:32s} {n:3d} calls  kernel {k_ms:8.3f} ms  plain {p_ms:8.3f} ms  bound {b_ms:8.3f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{args.path} path, B={args.batch}; {torch.cuda.get_device_name(0)}; nvidia-smi: {smi or 'unavailable'}")


if __name__ == "__main__":
    main()
