"""Evaluation CLI (counterpart of cofii2p_tpu/evaluation/eval_all.py, with
the same flags plus ``--device``):

    python -m cofii2p_tpu_torch.evaluation.eval_all ref.t7 kitti data_path=/data/kitti_i2p --batch_size 8
    python -m cofii2p_tpu_torch.evaluation.eval_all <port checkpoint> nuscenes data_path=/data/nuscenes_i2p
    python -m cofii2p_tpu_torch.evaluation.eval_all ref.t7 kitti --synthetic --batch_size 8
    python -m cofii2p_tpu_torch.evaluation.eval_all ref.t7 tiny --synthetic --device cpu   # tests

Output-compatible with the reference evaluator: per-frame ``.npy`` dumps
into ``<eval_path>/<dataset>/<timestamp>/`` and the ``{dataset}_t_error.npy``
/ ``{dataset}_r_error.npy`` arrays in the working directory, which
evaluation/calc_result.py and evaluation/ir_rmse.py read.

``<ckpt>`` is a reference ``.t7``/``.pth`` state dict (utils/checkpoint.py::
import_t7, with the k-NN configuration of :func:`reference_ckpt_config`),
one of the port's own training checkpoints, or ``none``/``random`` for
seeded random weights.  The frames are the val split of the on-disk
dataset under ``data_path`` (train.py::build_dataset), or synthetic ones
with ``--synthetic``.  Runs on the card (``--device cuda``, the default)
and raises when there is none; ``--device cpu`` runs the kernels' plain
versions, for tests.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from cofii2p_tpu_torch.config import apply_overrides, get_config
from cofii2p_tpu_torch.data.loader import BatchLoader
from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body, pose_errors_np
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.train import _to_device, build_dataset, resolve_device
from cofii2p_tpu_torch.utils.checkpoint import import_t7, restore_checkpoint
from cofii2p_tpu_torch.utils.metrics import setup_logger


def load_weights(ckpt: str, model: CoFiI2P) -> CoFiI2P:
    """Fill ``model`` from ``ckpt``: ``none``/``random``/empty keep its
    (seeded) initial weights, ``.t7``/``.pth`` is a reference state dict,
    anything else one of the port's training checkpoints."""
    if ckpt in ("none", "random", ""):
        return model
    if ckpt.endswith((".t7", ".pth")):
        return import_t7(ckpt, model)
    restore_checkpoint(ckpt, model)
    return model


def reference_ckpt_config(cfg, overrides, device=None):
    """The configuration a reference checkpoint is evaluated with
    (cofii2p_tpu/evaluation/eval_all.py:50-79); an explicit ``key=value``
    override always wins:

    - ``kpconv_impl='banded_knn'``: the weights were trained on k-NN
      neighbourhoods;
    - ``kpconv_shared_influence=False``: each layer carries its own
      rotated and jittered kernel points;
    - ``fine_decode='reference'``: the published RRE/RTE were measured
      with the reference's swapped fine decode;
    - ``attention='pallas'`` (the fused kernel #4) on the card only, as the
      JAX package selects its fused kernel only on its accelerator; on the
      CPU ``'full'`` stays.  ``device`` defaults to the card when there is
      one.
    """
    keyed = {o.split("=", 1)[0] for o in overrides if "=" in o}
    if "kpconv_impl" not in keyed:
        cfg = cfg.replace(kpconv_impl="banded_knn")
    if "kpconv_shared_influence" not in keyed:
        cfg = cfg.replace(kpconv_shared_influence=False)
    if "fine_decode" not in keyed:
        cfg = cfg.replace(fine_decode="reference")
    on_card = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    if "attention" not in keyed and on_card:
        cfg = cfg.replace(attention="pallas")
    return cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Image-to-Point Cloud Registration evaluation (PyTorch/CUDA)")
    parser.add_argument("ckpt", type=str)
    parser.add_argument("dataset", type=str)
    parser.add_argument("--eval_path", type=str, default="eval_results")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_frames", type=int, default=32)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--max_frames", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu (tests)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    cfg = apply_overrides(get_config(args.dataset), args.overrides)
    device = resolve_device(args.device)
    if args.ckpt.endswith((".t7", ".pth")):
        cfg = reference_ckpt_config(cfg, args.overrides, device)
    logger = setup_logger()
    if device.type == "cuda" and cfg.compute_dtype == "float32":
        # cuDNN convolves fp32 in TF32 unless told not to
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    backend = "pallas (fused kernel #4)" if cfg.attention == "pallas" else cfg.attention
    logger.info("device %s; kpconv_impl %s, attention backend %s, fine_decode %s, %s",
                torch.cuda.get_device_name(device) if device.type == "cuda" else device,
                cfg.kpconv_impl, backend, cfg.fine_decode, cfg.compute_dtype)

    dataset = build_dataset(args.dataset, cfg, "val", args.synthetic, args.synthetic_frames)
    assert len(dataset) > 0
    has_normals = getattr(dataset, "has_normals", True)
    loader = BatchLoader(dataset, args.batch_size, shuffle=False, drop_last=False, num_workers=cfg.num_workers,
                         to_device=device if device.type == "cuda" else None)

    torch.manual_seed(0)
    model = load_weights(args.ckpt, CoFiI2P(cfg)).to(device).eval()
    run = make_eval_body(cfg, model, has_normals)
    gen = torch.Generator(device).manual_seed(7)

    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    eval_path = os.path.join(args.eval_path, args.dataset, ts)
    os.makedirs(eval_path, exist_ok=True)

    t_errs, r_errs = [], []
    success_num = 0
    frame = 0
    done = False
    for i_batch, host_batch in enumerate(loader.epoch(0)):
        hb = _to_device(host_batch, device)
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in run(hb, gen)._asdict().items()}
        b = out["R"].shape[0]
        logger.info("batch %d: %d frames in %.1f ms", i_batch, b, (time.perf_counter() - t0) * 1e3)
        for i in range(b):
            T_pred = np.eye(4, dtype=np.float64)
            T_pred[:3, :3] = out["R"][i]
            T_pred[:3, 3] = out["t"][i]
            P_gt = np.asarray(out["P_gt"][i], np.float64)
            if bool(out["success"][i]):
                success_num += 1
                t_diff, r_diff = pose_errors_np(T_pred, P_gt)
                t_errs.append(t_diff)
                r_errs.append(r_diff)
                logger.info("%d r=%.4f t=%.4f inl=%d", frame, r_diff, t_diff, int(out["num_inliers"][i]))
            K2 = hb["K"][i].cpu().numpy() * 0.5  # PnP intrinsics (/2 image)
            K2[2, 2] = 1.0
            np.save(
                os.path.join(eval_path, "%06d.npy" % frame),
                {
                    "GT_P": P_gt,
                    "pred_P": T_pred,
                    "K": K2,
                    "fine_xy": out["fine_xy"][i].T,
                    "corr_mask": out["corr_mask"][i],
                    "object_points": out["object_points"][i],
                    "superpoints_score": out["pc_score"][i],
                },
            )
            frame += 1
            if args.max_frames and frame >= args.max_frames:
                done = True
                break
        if done:
            break

    t_errs = np.asarray(t_errs)
    r_errs = np.asarray(r_errs)
    print(f"success num / total num: {success_num}/{frame}")
    if len(r_errs):
        print(np.mean(r_errs), np.mean(t_errs))
    np.save(f"{args.dataset}_t_error.npy", t_errs)
    np.save(f"{args.dataset}_r_error.npy", r_errs)
    return r_errs, t_errs


if __name__ == "__main__":
    main()
