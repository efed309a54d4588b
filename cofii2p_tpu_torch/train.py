"""Training CLI: ``python -m cofii2p_tpu_torch.train {kitti|nuscenes|tiny} [options]``
(counterpart of cofii2p_tpu/train.py, with the same flags plus ``--device``).

    python -m cofii2p_tpu_torch.train kitti --synthetic --steps 4 --batch_size 8
    python -m cofii2p_tpu_torch.train tiny --synthetic --steps 2 --device cpu   # tests

Runs on the card (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` runs the kernels' plain versions, for tests.
``--fast`` (the narrow dynamic-window training) is not ported yet.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np
import torch

from cofii2p_tpu_torch import train_lib
from cofii2p_tpu_torch.config import apply_overrides, get_config
from cofii2p_tpu_torch.data.loader import BatchLoader
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from cofii2p_tpu_torch.utils.metrics import MetricWriter, setup_logger

VAL_BATCHES = 6


def build_dataset(name: str, cfg, mode: str, synthetic: bool, length: int = 64):
    if synthetic:
        from cofii2p_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(cfg, mode, length=length)
    raise NotImplementedError(
        f"the {name!r} dataset loaders are not ported yet (ROADMAP queue 1 item 10); use --synthetic"
    )


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trainer runs on the card (--device cpu is for tests)")
    return device


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "index"}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Image-to-Point Cloud Registration (CoFiI2P, PyTorch/CUDA)")
    parser.add_argument("dataset", type=str, help="kitti | nuscenes | tiny")
    parser.add_argument("--ft_from", type=str, help="fine-tune from checkpoint")
    parser.add_argument("--synthetic", action="store_true", help="synthetic data")
    parser.add_argument("--steps", type=int, default=0, help="stop after N steps")
    parser.add_argument("--batch_size", type=int, default=0, help="batch size")
    parser.add_argument("--synthetic_frames", type=int, default=64)
    parser.add_argument("--ckpt_every_steps", type=int, default=0)
    parser.add_argument("--ckpt_every_epochs", type=int, default=1,
                        help="save cadence in epochs (reference saves every epoch)")
    parser.add_argument("--fast", action="store_true",
                        help="train with the w256 dynamic windows (not ported yet: raises)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu (tests)")
    parser.add_argument("overrides", nargs="*", help="config key=value overrides")
    # key=value overrides may come before or after the options
    args = parser.parse_intermixed_args(argv)

    if args.fast:
        raise NotImplementedError(
            "--fast needs the dynamic-window backward kernels #10 (_transpose_agg_dyn) and #14 (_bwd_dyn), "
            "the next slice of ROADMAP queue 2"
        )
    cfg = apply_overrides(get_config(args.dataset), args.overrides)
    batch_size = args.batch_size or cfg.train_batch_size
    device = resolve_device(args.device)

    ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    save_dir = os.path.join(cfg.root_path, cfg.save_path, args.dataset, ts)
    log_dir = os.path.join(cfg.root_path, cfg.log_path, args.dataset, ts)
    logger = setup_logger(log_dir)
    writer = MetricWriter(log_dir)
    logger.info("config: %s", cfg)
    if device.type == "cuda":
        logger.info("device: %s x%d", torch.cuda.get_device_name(device), torch.cuda.device_count())
        if cfg.compute_dtype == "float32":
            # cuDNN convolves fp32 in TF32 unless told not to
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            logger.info("fp32 compute: TF32 off for matmuls and cuDNN convolutions")
    else:
        logger.info("device: %s", device)

    train_ds = build_dataset(args.dataset, cfg, "train", args.synthetic, args.synthetic_frames)
    val_ds = build_dataset(args.dataset, cfg, "val", args.synthetic, max(args.synthetic_frames // 4, 8))
    assert len(train_ds) > 0 and len(val_ds) > 0
    stage = device if device.type == "cuda" else None
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True, num_workers=cfg.num_workers, to_device=stage)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False, num_workers=cfg.num_workers, to_device=stage)

    torch.manual_seed(42)
    model = CoFiI2P(cfg).to(device)
    optimizer = train_lib.make_optimizer(cfg, model.parameters())
    has_normals = getattr(train_ds, "has_normals", True)
    train_step = train_lib.make_train_step(cfg, model, optimizer, has_normals)
    eval_step = train_lib.make_eval_step(cfg, model, has_normals)
    gen = torch.Generator(device).manual_seed(42)

    global_step = 0
    if args.ft_from:
        global_step = restore_checkpoint(args.ft_from, model, optimizer)
        logger.info("restored %s at step %d", args.ft_from, global_step)
    logger.info("parameters: %.2fM", sum(p.numel() for p in model.parameters()) / 1e6)

    last_saved = -1
    stop = False
    # a resumed run continues the LR-decay schedule from its step
    start_epoch = train_lib.resume_epoch(cfg, global_step, len(train_loader))
    for epoch in range(start_epoch, cfg.epoch):
        train_lib.set_learning_rate(optimizer, train_lib.lr_for_epoch(cfg, epoch))
        for host_batch in train_loader.epoch(epoch):
            hb = _to_device(host_batch, device)
            metrics = train_step(hb, train_lib.make_train_draws(cfg, batch_size, gen, device))
            global_step += 1
            if global_step % 10 == 0:
                m = {k: float(v) for k, v in metrics.items()}
                writer.write(global_step, m)
                logger.info("train-%d-%d loss %.4f desc %.4f coarse %.4f fine %.4f", epoch, global_step,
                            m["loss"], m["loss_desc"], m["loss_coarse"], m["loss_fine"])
            if global_step % cfg.val_freq == 0:
                accs = []
                for i, vb in enumerate(val_loader.epoch(0)):
                    if i >= VAL_BATCHES:
                        break
                    r = eval_step(_to_device(vb, device), train_lib.make_train_draws(cfg, batch_size, gen, device))
                    accs.append({k: float(v) for k, v in r.items()})
                mean = {k: float(np.mean([a[k] for a in accs])) for k in accs[0]}
                writer.write(global_step, mean)
                logger.info("val @%d: %s", global_step, mean)
            if args.ckpt_every_steps and global_step % args.ckpt_every_steps == 0:
                save_checkpoint(save_dir, global_step, model, optimizer)
                last_saved = global_step
            if args.steps and global_step >= args.steps:
                stop = True
                break
        if (stop or (epoch + 1) % max(args.ckpt_every_epochs, 1) == 0) and global_step != last_saved:
            path = save_checkpoint(save_dir, global_step, model, optimizer)
            logger.info("saved %s", path)
        if stop:
            break
    writer.close()
    return save_dir


if __name__ == "__main__":
    main()
