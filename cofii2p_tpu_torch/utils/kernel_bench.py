"""Per-call times of the port's CUDA kernels on the serving, training or
`.t7` eval path.

    python -m cofii2p_tpu_torch.utils.kernel_bench [--path serve|resfuse|train|fast|knn_train|t7|val|val_resfuse]
        [--batch 8] [--reps 10] [--only WRAPPER[,WRAPPER...]]

``serve`` runs one forward of bench.py's serving config (bf16 w192,
fused attention); ``resfuse`` the same with ``kpconv_residual_fused=True``
(each strided block's conv and shortcut in one pass, kernel #16, whose
lines also give the time of the unfused pair, #1 and #3, on the same
inputs); ``train`` one fp32 training step of the default
KITTIConfig (static bands), forward and backward; ``fast`` the same step
with ``train --fast``'s w256 dynamic windows (config.with_fast_windows);
``knn_train`` the step under ``kpconv_impl=banded_knn`` with per-layer
kernel points; ``t7`` one fp32 forward of the configuration a reference
checkpoint is evaluated with (evaluation/eval_all.py::reference_ckpt_config:
k-NN semantics, static bands, per-layer kernel points, fused attention);
``val`` one fp32 forward of the static-band trainer's validation step
(train_lib.make_eval_step: the fp32 KPConvs #1 and #2, #3, full
attention), ``val_resfuse`` the same with ``kpconv_residual_fused=True``
(#16 for the strided blocks it admits).  All use seeded random
weights and synthetic KITTI-shaped frames.  Every call of a kernel wrapper
is recorded with its arguments, then replayed on its own: the kernel and
its plain PyTorch version are timed with CUDA events, and the call's bound
is computed from its inputs (the least time the card could take: the
larger of the bytes moved over the HBM rate and the operations over the
peak rate of their type).  Where one PyTorch call computes the same
function (the fused attention: ``scaled_dot_product_attention``), it is
timed beside them as a yardstick.  One line per call, then per-kernel
totals; ``--only`` replays the calls of the named wrappers alone (e.g.
``banded_maxpool_fused,banded_maxpool_tau``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import subprocess

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; fp32 outside the
# tensor cores, which every non-matmul operation is counted at; bf16 matmul;
# an fp32 product by 3xTF32 (three TF32 products at 495 TFLOP/s), the rate
# of every fp32 product of the KPConv kernels (#1, #2, #6, #7, #9, #10, #11,
# #16) and the fused attention (#4), which all take that route
HBM_BPS, FP32_OPS, BF16_MMA_OPS, TF32X3_OPS = 3.35e12, 67e12, 989e12, 495e12 / 3
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


def bound_ms(nbytes, ops32=0.0, ops16=0.0, ops_tf32x3=0.0):
    """(ms, 'bytes' | 'operations'): the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type (fp32 on the
    CUDA cores, bf16 or 3xTF32 on the tensor cores)."""
    t_bytes = nbytes / HBM_BPS
    t_ops = ops32 / FP32_OPS + ops16 / BF16_MMA_OPS + ops_tf32x3 / TF32X3_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _pairs(q, s, r_active, tile, width, starts=None, tau=None) -> float:
    """In-reach (query, band row) pairs of these inputs (and within tau
    where it is given)."""
    from cofii2p_tpu_torch.ops.banded import banded_pair_count

    return float(banded_pair_count(q, s, r_active, tile, width, starts, tau).sum())


def kernel_wrappers() -> dict:
    """Every kernel wrapper by name, with its plain version and the module
    attribute the model's path looks it up through."""
    from cofii2p_tpu_torch.models import kpconv as kpc
    from cofii2p_tpu_torch.models import transformer as tf
    from cofii2p_tpu_torch.ops import attention_kernel as att
    from cofii2p_tpu_torch.ops import kpconv_kernel as kpk
    from cofii2p_tpu_torch.ops import maxpool_kernel as mpk
    from cofii2p_tpu_torch.ops import residual_kernel as rk
    from cofii2p_tpu_torch.ops import tau_kernel as tk

    return {
        "banded_knn_tau_kernel": (kpc, tk.banded_knn_tau_kernel, tk.banded_knn_tau_plain),
        "banded_kpconv_fused_tau": (kpk, kpk.banded_kpconv_fused_tau, kpk.banded_kpconv_fused_tau_plain),
        "banded_kpconv_aggregate_tau": (kpk, kpk.banded_kpconv_aggregate_tau, kpk.banded_kpconv_aggregate_tau_plain),
        "banded_maxpool_tau": (mpk, mpk.banded_maxpool_tau, mpk.banded_maxpool_tau_plain),
        "banded_kpconv_fused": (kpk, kpk.banded_kpconv_fused, kpk.banded_kpconv_fused_plain),
        "banded_kpconv_aggregate_fused": (kpk, kpk.banded_kpconv_aggregate_fused, kpk.banded_kpconv_aggregate_plain),
        "banded_kpconv_transpose_fused": (kpk, kpk.banded_kpconv_transpose_fused, kpk.banded_kpconv_transpose_plain),
        "banded_kpconv_transpose_dyn_fused": (kpk, kpk.banded_kpconv_transpose_dyn_fused,
                                              kpk.banded_kpconv_transpose_dyn_plain),
        "banded_kpconv_transpose_tau_fused": (kpk, kpk.banded_kpconv_transpose_tau_fused,
                                              kpk.banded_kpconv_transpose_tau_plain),
        "banded_maxpool_fused": (mpk, mpk.banded_maxpool_fused, mpk.banded_maxpool_plain),
        "banded_maxpool_tie_count_fused": (mpk, mpk.banded_maxpool_tie_count_fused,
                                           mpk.banded_maxpool_tie_count_plain),
        "banded_maxpool_backward_fused": (mpk, mpk.banded_maxpool_backward_fused, mpk.banded_maxpool_route_plain),
        "banded_maxpool_backward_dyn_fused": (mpk, mpk.banded_maxpool_backward_dyn_fused,
                                              mpk.banded_maxpool_route_dyn_plain),
        "banded_maxpool_backward_tau_fused": (mpk, mpk.banded_maxpool_backward_tau_fused,
                                              mpk.banded_maxpool_route_tau_plain),
        "fused_attention": (tf, att.fused_attention, att.fused_attention_plain),
        "banded_residual_fused": (rk, rk.banded_residual_fused, rk.banded_residual_fused_plain),
    }


def unfused_pair(mp_feats, agg_feats, weights, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
                 band_width=1024, dtype=torch.float32, starts=None):
    """Kernel #16's work done by the pair it fuses: #1 on ``agg_feats``,
    then #3 on ``mp_feats`` (the strided block without the flag)."""
    from cofii2p_tpu_torch.ops.banded import kernel_reach
    from cofii2p_tpu_torch.ops.kpconv_kernel import banded_kpconv_fused
    from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_fused

    out, count = banded_kpconv_fused(agg_feats, q_points, s_points, weights, radius, sigma, kernel_size, tile,
                                     band_width, dtype, starts)
    shortcut = banded_maxpool_fused(mp_feats, q_points, s_points, kernel_reach(radius, sigma, kernel_size), tile,
                                    band_width, starts)
    return out, count, shortcut


def _work(nbytes, ops32=0.0, ops16=0.0, ops_tf32x3=0.0) -> dict:
    return dict(nbytes=float(nbytes), ops32=float(ops32), ops16=float(ops16), ops_tf32x3=float(ops_tf32x3))


def call_work(name: str, args, kwargs=None) -> dict:
    """The work of one call of the wrapper ``name`` on these arguments: the
    bytes it must move (each input read once, each output written once)
    and its operations by type (``ops32`` on the CUDA cores, ``ops16``
    bf16 and ``ops_tf32x3`` fp32 products on the tensor cores), counted
    from this call's data (its in-reach pairs)."""
    from cofii2p_tpu_torch.ops.banded import kernel_reach, tau_reach2

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
        bf16 = q.dtype == torch.bfloat16
        return _work(io, ops32=5.0 * b * h * l * s, ops16=mma if bf16 else 0.0,
                        ops_tf32x3=0.0 if bf16 else mma)
    q, s = a["q_points"], a["s_points"]
    b, m = q.shape[:2]
    n = s.shape[1]
    pts = b * (m + n) * 3 * 4
    starts = a.get("starts")
    tau = a.get("tau")
    if name == "banded_knn_tau_kernel":
        # one d2 (3 subtractions, 3 products, 2 sums) and one comparison
        # per (query, band row): the least a selection over the band does
        from cofii2p_tpu_torch.ops.banded import band_plan

        band = band_plan(m, n, a["tile"], a["band_width"], starts)[2]
        return _work(pts + b * m * 4, ops32=9.0 * b * m * band)
    if name.startswith("banded_kpconv") or name == "banded_residual_fused":
        ks, tile, bw = a["kernel_size"], a["tile"], a["band_width"]
        if tau is None:
            pairs = _pairs(q, s, kernel_reach(a["radius"], a["sigma"], ks), tile, bw, starts)
        else:  # the aggregated pairs: within tau and the padded reach
            pairs = _pairs(q, s, tau_reach2(a["radius"], a["sigma"], ks) ** 0.5, tile, bw, starts, tau)
        mma16 = a["dtype"] == torch.bfloat16

        def ops(infl, prod):  # the influence math on the CUDA cores, the products on the tensor cores
            return dict(ops32=infl, ops16=prod) if mma16 else dict(ops32=infl, ops_tf32x3=prod)

        if tau is not None:
            pts += tau.numel() * 4 + ks * 3 * 4
        if starts is not None:
            pts += starts.numel() * 4
        if name.startswith("banded_kpconv_transpose"):
            g = a["g_weighted"]
            c = g.shape[-1]
            return _work(pts + g.numel() * 4 + b * n * c * 4, **ops(pairs * ks * INFL_OPS, 2.0 * pairs * ks * c))
        f = a["agg_feats" if name == "banded_residual_fused" else "s_feats"]
        cin = f.shape[-1]
        infl = pairs * ks * INFL_OPS
        agg = 2.0 * pairs * ks * cin
        if name in ("banded_kpconv_aggregate_fused", "banded_kpconv_aggregate_tau"):
            io = pts + f.numel() * f.element_size() + b * m * (ks * cin + 1) * 4
            return _work(io, **ops(infl, agg))
        w = a["weights"]
        cout = w.shape[-1]
        mma = agg + 2.0 * b * m * ks * cin * cout
        io = pts + f.numel() * f.element_size() + w.numel() * 4 + b * m * (cout + 1) * 4
        if name == "banded_residual_fused":
            # and the shortcut: one comparison per in-reach pair and channel
            mp = a["mp_feats"]
            io += (mp.numel() + b * m * mp.shape[-1]) * mp.element_size()
            infl += pairs * mp.shape[-1]
        return _work(io, **ops(infl, mma))
    f = a["s_feats"]
    c = f.shape[-1]
    fbytes = f.numel() * f.element_size()
    # members: d2 <= tau[m] (no radius mask) or in reach
    pairs = _pairs(q, s, None if tau is not None else a["r_active"], a["tile"], a["band_width"], starts, tau)
    pts += (0 if tau is None else tau.numel() * 4) + (0 if starts is None else starts.numel() * 4)
    if name in ("banded_maxpool_fused", "banded_maxpool_tau"):
        return _work(pts + fbytes + b * m * c * f.element_size(), ops32=pairs * c)
    out_bytes = a["out"].numel() * a["out"].element_size()
    if name == "banded_maxpool_tie_count_fused":
        return _work(pts + fbytes + out_bytes + b * m * c * 4, ops32=2.0 * pairs * c)
    return _work(pts + fbytes + out_bytes + b * m * c * 4 + b * n * c * 4, ops32=2.0 * pairs * c)


def call_bound(name: str, args, kwargs=None):
    """Bound of one call of the wrapper ``name`` on these arguments."""
    w = call_work(name, args, kwargs)
    return bound_ms(w["nbytes"], w["ops32"], w["ops16"], w["ops_tf32x3"])


@contextlib.contextmanager
def recording(calls, around=None):
    """Record (name, args, kwargs) of every kernel-wrapper call the model's
    path makes (forward and backward); ``around(name)``, when given, is a
    context manager entered around each call."""
    patched = []
    for name, (mod, fn, _) in kernel_wrappers().items():
        def rec(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, args, kwargs))
            with around(_name) if around is not None else contextlib.nullcontext():
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
    if name == "banded_knn_tau_kernel":
        return f"M {a['q_points'].shape[1]} N {a['s_points'].shape[1]} k {a['k']} bw{a['band_width']}"
    lead = a.get("s_feats", a.get("g_weighted", a.get("agg_feats")))
    band = ("w%d" if a.get("starts") is not None else "bw%d") % a["band_width"]
    extra = f" Cout {a['weights'].shape[-1]}" if "weights" in a else ""
    if "mp_feats" in a:
        extra += f" Cin {a['mp_feats'].shape[-1]}"
    return f"M {a['q_points'].shape[1]} N {a['s_points'].shape[1]} C {lead.shape[-1]}{extra} {band} {lead.dtype}"


def serve_config(residual_fused=False):
    """bench.py:277-282, the serving configuration (and chip_smoke.py's
    serve phases), with or without the fused residual band pass."""
    from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig

    return KITTIConfig(compute_dtype="bfloat16", kpconv_dynamic_plan=SERVE_DYNAMIC_PLAN,
                       kpconv_dynamic_plan_self=SERVE_DYNAMIC_PLAN_SELF, attention="pallas",
                       kpconv_residual_fused=residual_fused)


def record_serve(batch, seed, dev, residual_fused=False):
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize

    cfg = serve_config(residual_fused)
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(dev).eval()
    hb = _frames(cfg, batch, dev)
    draws = make_draws(cfg, batch, torch.Generator(dev).manual_seed(seed), dev)
    calls = []
    with torch.no_grad():
        b = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
        with recording(calls):
            model(b)
    return calls


def t7_model(cfg, seed, dev):
    """The model a reference checkpoint gives, from seeded weights: random
    weights and each KPConv's own rotated and jittered kernel points."""
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import jitter_kernel_points, randomize

    gen = torch.Generator().manual_seed(seed)
    return jitter_kernel_points(randomize(CoFiI2P(cfg), gen), gen).to(dev).eval()


def record_t7(batch, seed, dev):
    from cofii2p_tpu_torch.config import KITTIConfig
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.eval_all import reference_ckpt_config
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws

    cfg = reference_ckpt_config(KITTIConfig(), [], dev)
    model = t7_model(cfg, seed, dev)
    hb = _frames(cfg, batch, dev)
    draws = make_draws(cfg, batch, torch.Generator(dev).manual_seed(seed), dev)
    calls = []
    with torch.no_grad():
        b = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
        with recording(calls):
            model(b)
    return calls


def record_val(batch, seed, dev, residual_fused=False):
    """One fp32 forward of the static-band trainer's validation step
    (train_lib.make_eval_step's model call), with or without the fused
    residual band pass."""
    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.config import KITTIConfig

    cfg = KITTIConfig(kpconv_residual_fused=residual_fused)
    model = train_model(cfg, seed, dev)
    hb = _frames(cfg, batch, dev)
    draws = train_lib.make_train_draws(cfg, batch, torch.Generator(dev).manual_seed(seed), dev)
    calls = []
    with torch.no_grad():
        b = train_lib.prepare_batch(cfg, hb, draws)
        with recording(calls):
            model(b, mode="val", train=False)
    return calls


def library_call(name, args, kwargs):
    """One PyTorch call that computes the same function as the kernel
    wrapper ``name`` on these arguments, or None where there is none: the
    fused attention's ``scaled_dot_product_attention`` (heads second)."""
    if name != "fused_attention":
        return None
    fn = kernel_wrappers()[name][1]
    a = inspect.signature(fn).bind(*args, **kwargs).arguments
    q, k, v = (a[x].transpose(1, 2) for x in ("q", "k", "v"))
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def train_config(path: str):
    """The fp32 KITTI training configuration of a kernel_bench path (and of
    chip_smoke.py's train phases): 'train' static bands, 'fast' train
    --fast's windows, 'knn_train' the k-NN semantics."""
    from cofii2p_tpu_torch.config import KITTIConfig, with_fast_windows

    if path == "fast":
        return with_fast_windows(KITTIConfig())
    if path == "knn_train":
        return KITTIConfig(kpconv_impl="banded_knn")
    return KITTIConfig()


def train_model(cfg, seed, dev):
    """Seeded random weights; under banded_knn every KPConv with its own
    rotated and jittered kernel points, as a reference checkpoint has."""
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import jitter_kernel_points, randomize

    gen = torch.Generator().manual_seed(seed)
    model = randomize(CoFiI2P(cfg), gen)
    if cfg.kpconv_impl == "banded_knn":
        jitter_kernel_points(model, gen)
    return model.to(dev)


def record_train(batch, seed, dev, path="train"):
    from cofii2p_tpu_torch import train_lib

    cfg = train_config(path)
    model = train_model(cfg, seed, dev)
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
    ap.add_argument("--path", choices=("serve", "resfuse", "train", "fast", "knn_train", "t7", "val", "val_resfuse"),
                    default="serve")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="comma-separated wrapper names whose calls are replayed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.path in ("train", "fast", "knn_train"):
        calls = record_train(args.batch, args.seed, dev, args.path)
    elif args.path == "resfuse":
        calls = record_serve(args.batch, args.seed, dev, residual_fused=True)
    elif args.path in ("val", "val_resfuse"):
        calls = record_val(args.batch, args.seed, dev, residual_fused=args.path == "val_resfuse")
    else:
        calls = {"serve": record_serve, "t7": record_t7}[args.path](args.batch, args.seed, dev)
    torch.cuda.synchronize()
    if args.only:
        calls = [c for c in calls if c[0] in args.only.split(",")]

    wrappers = kernel_wrappers()
    totals = {}
    with torch.no_grad():
        for name, a, kw in calls:
            _, kern, plain = wrappers[name]
            k_ms = time_ms(lambda: kern(*a, **kw), args.reps)
            p_ms = time_ms(lambda: plain(*a, **kw), max(1, args.reps // 3))
            b_ms, by = call_bound(name, a, kw)
            # kernel #16 beside the pair it fuses, on the same inputs
            pair_ms = time_ms(lambda: unfused_pair(*a, **kw), args.reps) if name == "banded_residual_fused" else None
            lib = library_call(name, a, kw)
            lib_ms = None if lib is None else time_ms(lib, args.reps)
            t = totals.setdefault(name, [0, 0.0, 0.0, 0.0, 0.0, 0.0])
            t[0] += 1
            t[1] += k_ms
            t[2] += p_ms
            t[3] += b_ms
            t[4] += pair_ms or 0.0
            t[5] += lib_ms or 0.0
            pair = "" if pair_ms is None else f"  pair #1+#3 {pair_ms:8.3f} ms"
            library = "" if lib_ms is None else f"  library {lib_ms:8.3f} ms"
            print(f"{name:32s} {_describe(name, a, kw):52s} kernel {k_ms:8.3f} ms  plain {p_ms:8.3f} ms  "
                  f"bound {b_ms:7.3f} ms ({by}){pair}{library}", flush=True)
    for name, (n, k_ms, p_ms, b_ms, pair_ms, lib_ms) in totals.items():
        pair = f"  pair #1+#3 {pair_ms:8.3f} ms" if name == "banded_residual_fused" else ""
        library = f"  library {lib_ms:8.3f} ms" if name == "fused_attention" else ""
        print(f"TOTAL {name:32s} {n:3d} calls  kernel {k_ms:8.3f} ms  plain {p_ms:8.3f} ms  bound {b_ms:8.3f} ms"
              f"{pair}{library}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{args.path} path, B={args.batch}; {torch.cuda.get_device_name(0)}; nvidia-smi: {smi or 'unavailable'}")


if __name__ == "__main__":
    main()
