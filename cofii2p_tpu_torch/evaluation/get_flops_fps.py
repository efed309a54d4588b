"""Performance measurement CLI: parameter count, end-to-end pipeline and
bare-network frames/s, network FLOPs and activations a frame, peak device
memory and PnP-RANSAC alone (counterpart of
cofii2p_tpu/evaluation/get_flops_fps.py, with the same arguments plus
``--device``):

    python -m cofii2p_tpu_torch.evaluation.get_flops_fps                       # random weights, kitti
    python -m cofii2p_tpu_torch.evaluation.get_flops_fps ref.t7 kitti --batch_size 8
    python -m cofii2p_tpu_torch.evaluation.get_flops_fps "" kitti --batch_size 8 compute_dtype=bfloat16 \\
        kpconv_dynamic_plan=0,192,192,192,0 kpconv_dynamic_plan_self=0,0,192,192,0 attention=pallas
    python -m cofii2p_tpu_torch.evaluation.get_flops_fps "" tiny --device cpu   # tests

Without a checkpoint (or with ``none``/``random``) it measures seeded
random weights, which cost the same.  Times come from
utils/profiling.py::timeit_sync (CUDA events on the card).  The
end-to-end timing is made again with the span recorder on
(utils/profiling.py::recording, no profiler), and its span table
follows: each span's host ms and device ms a request, and the counters
(the RANSAC graph's nodes).

FLOPs follow the convention of ``torch.utils.flop_counter`` (a product is
two operations): the counter's count of the library ops of one test-mode
forward, plus, for each call of a hand-written kernel, the operations
utils/kernel_bench.py::call_work reckons from that call's inputs (the
counter cannot see a kernel launched through ctypes); on the CPU, where a
wrapper runs its plain version, what the counter saw inside the wrapper is
taken out again.  Activations follow fvcore's convention, which the
reference reports: the elements produced by every matmul and convolution
launch, and for each kernel call with a product (the KPConvs, the fused
attention) the elements of its output.  The JAX package's count walks a
``lax.map`` body once rather than once per tile, so its number is not the
reference here (ROADMAP.md, known reference behaviours).  Peak memory is
``torch.cuda.max_memory_allocated`` over one network forward, where
XLA's ``memory_analysis`` served the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cofii2p_tpu_torch.config import apply_overrides, get_config
from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
from cofii2p_tpu_torch.data.loader import BatchLoader
from cofii2p_tpu_torch.evaluation.pipeline import make_draws, make_eval_body
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.pose.ransac import gumbel_noise, ransac_pnp
from cofii2p_tpu_torch.train import _to_device, build_dataset, resolve_device
from cofii2p_tpu_torch.utils import profiling
from cofii2p_tpu_torch.utils.cuda_graphs import CudaGraphed
from cofii2p_tpu_torch.utils.profiling import timeit_sync

aten = torch.ops.aten
# the matmul and convolution ops whose outputs fvcore counts as activations
ACTIVATION_OPS = {
    aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
    aten.convolution.default, aten._convolution.default,
}


def param_count(model: torch.nn.Module) -> int:
    """Parameters as the JAX package counts them: every parameter and each
    KPConv's kernel points, a flax parameter there (frozen by
    stop_gradient) and a buffer in the port."""
    return sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for n, b in model.named_buffers() if n.endswith("kernel_points"))


class ActivationCounter(TorchDispatchMode):
    """Counts the output elements of every matmul and convolution op run
    inside it, except while ``paused``."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused and func in ACTIVATION_OPS:
            self.total += out.numel()
        return out


def count_work(fn):
    """(flops, activations) of ``fn()``, by the conventions of the module
    docstring."""
    from torch.utils.flop_counter import FlopCounterMode

    from cofii2p_tpu_torch.utils.kernel_bench import call_work, recording

    flops = FlopCounterMode(display=False)
    acts = ActivationCounter()
    calls, inside = [], []

    @contextlib.contextmanager
    def kernel_call(name):
        # what the counters see inside a wrapper is its plain version's
        # work (on the CPU): it is replaced by the kernel's own count
        before = flops.get_total_flops()
        acts.paused = True
        try:
            yield
        finally:
            acts.paused = False
            inside.append(flops.get_total_flops() - before)

    with torch.no_grad(), flops, acts, recording(calls, around=kernel_call):
        fn()
    total_flops, total_acts = flops.get_total_flops() - sum(inside), acts.total
    for name, a, kw in calls:
        w = call_work(name, a, kw)
        total_flops += w["ops32"] + w["ops16"] + w["ops_tf32x3"]
        if w["ops16"] or w["ops_tf32x3"]:
            total_acts += _product_elements(name, a, kw)
    return total_flops, total_acts


def _product_elements(name, args, kwargs) -> int:
    """Elements of the product a kernel call writes: (B, M, Cout) of a
    KPConv with its contraction, (B, M, K, C) of an aggregation, (B, N, C)
    of a transpose, the attention's (B, L, H, D)."""
    import inspect

    from cofii2p_tpu_torch.utils.kernel_bench import kernel_wrappers

    a = inspect.signature(kernel_wrappers()[name][1]).bind(*args, **kwargs).arguments
    if name == "fused_attention":
        return a["q"].numel()
    b, m = a["q_points"].shape[:2]
    if "weights" in a:
        return b * m * a["weights"].shape[-1]
    if "g_weighted" in a:
        return b * a["s_points"].shape[1] * a["g_weighted"].shape[-1]
    return b * m * a["kernel_size"] * a["s_feats"].shape[-1]


def span_lines(table: dict, root: str) -> list:
    """The span table (utils/profiling.py) as lines, each span's host and
    device ms a call of ``root``, then the counters."""
    per = table[root]["n"]
    lines = []
    for name, row in table.items():
        if "n" not in row:
            lines.append(f"  counter {name}: {row['value']}")
            continue
        device = "not measured" if row["device_ms"] is None else f"{row['device_ms'] / per:.3f} ms"
        lines.append(f"  span {name}: {row['n'] / per:g} a call, host {row['host_ms'] / per:.3f} ms, "
                     f"device {device}")
    return lines


def timed(fn, *a, warmup=3, iters=10, **kw) -> float:
    """Seconds a call of ``fn``, device-synchronised (utils/profiling.py)."""
    return timeit_sync(fn, *a, warmup=warmup, iters=iters, **kw)


def main(argv=None):
    parser = argparse.ArgumentParser(description="parameters, FLOPs, activations and frames/s of the port")
    parser.add_argument("ckpt", nargs="?", default="")
    parser.add_argument("dataset", nargs="?", default="kitti")
    parser.add_argument("--synthetic", action=argparse.BooleanOptionalAction, default=True,
                        help="synthetic frames (default); --no-synthetic reads the on-disk dataset")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--network", action=argparse.BooleanOptionalAction, default=True,
                        help="also time the bare network forward and count its FLOPs, activations and peak "
                             "memory; --no-network skips them")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu (tests)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    from cofii2p_tpu_torch.evaluation.eval_all import load_weights, reference_ckpt_config

    cfg = apply_overrides(get_config(args.dataset), args.overrides)
    device = resolve_device(args.device)
    if args.ckpt.endswith((".t7", ".pth")):
        cfg = reference_ckpt_config(cfg, args.overrides, device)
    if device.type == "cuda" and cfg.compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ds = build_dataset(args.dataset, cfg, "val", args.synthetic, max(8, args.batch_size))
    loader = BatchLoader(ds, args.batch_size, num_workers=4, drop_last=False)
    hb = _to_device(next(loader.epoch(0)), device)
    has_normals = getattr(ds, "has_normals", True)

    torch.manual_seed(0)
    model = load_weights(args.ckpt, CoFiI2P(cfg)).to(device).eval()
    print(f"params: {param_count(model) / 1e6:.2f}M")

    run = make_eval_body(cfg, model, has_normals)
    gen = torch.Generator(device).manual_seed(0)
    dt = timed(run, hb, gen)
    fps = args.batch_size / dt
    print(f"end-to-end pipeline: {dt * 1e3:.2f} ms/batch, {fps:.2f} frames/s")
    # the same calls with the span recorder on (no profiler), and its table
    with profiling.recording():
        dt_rec = timed(run, hb, gen)
    print(f"end-to-end pipeline, spans recorded: {dt_rec * 1e3:.2f} ms/batch")
    for line in span_lines(profiling.span_table(), "cofii2p.eval"):
        print(line)

    if args.network:
        # the bare network forward on a prepared batch, as the reference's
        # fps_params_flops mode (get_flops_fps.py:14-63)
        draws = make_draws(cfg, args.batch_size, torch.Generator(device).manual_seed(1), device)
        batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"],
                                has_normals=has_normals)

        def forward():
            with torch.no_grad():
                return model(batch, mode="test")

        dt_n = timed(forward)
        print(f"network forward: {dt_n * 1e3 / args.batch_size:.2f} ms/frame, {args.batch_size / dt_n:.2f} frames/s")
        flops, acts = count_work(forward)
        print(f"network flops/frame: {flops / args.batch_size / 1e9:.2f} GFLOPs")
        print(f"network activations/frame: {acts / args.batch_size / 1e6:.2f} M")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            forward()
            peak = torch.cuda.max_memory_allocated(device)
            print(f"network peak memory: {peak / 1e6:.1f} MB (torch.cuda.max_memory_allocated)")
        else:
            print("network peak memory: not measured (no card)")

    # PnP-RANSAC alone at eval scale, one frame, as the pipeline runs it
    # (one captured CUDA graph on the card)
    s = cfg.num_superpoints
    rs = np.random.RandomState(0)
    obj = torch.as_tensor(rs.randn(1, s, 3).astype(np.float32) * 10 + np.float32([0, 0, 30]), device=device)
    uv = torch.as_tensor(rs.rand(1, s, 2).astype(np.float32) * 200, device=device)
    K = torch.tensor([[[300.0, 0, 128], [0, 300.0, 40], [0, 0, 1]]], device=device)
    mask = torch.ones(1, s, device=device)
    noise = gumbel_noise((1, cfg.ransac_hypotheses, s), torch.Generator(device).manual_seed(1), device)
    solve = functools.partial(ransac_pnp, inlier_threshold=cfg.ransac_inlier_px, refine_iters=cfg.ransac_refine_iters)
    dt_pnp = timed(CudaGraphed(solve, "cofii2p.ransac") if device.type == "cuda" else solve, noise, obj, uv, K, mask)
    print(f"pnp-ransac alone: {dt_pnp * 1e3:.2f} ms/frame, {1 / dt_pnp:.2f} frames/s")
    return fps


if __name__ == "__main__":
    main()
