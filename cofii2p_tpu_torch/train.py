"""Training CLI: ``python -m cofii2p_tpu_torch.train {kitti|nuscenes|tiny} [options]``
(counterpart of cofii2p_tpu/train.py, with the same flags plus ``--device``).

    python -m cofii2p_tpu_torch.train kitti data_path=/data/kitti_i2p
    python -m cofii2p_tpu_torch.train nuscenes data_path=/data/nuscenes_i2p
    python -m cofii2p_tpu_torch.train kitti --synthetic --steps 4 --batch_size 8
    python -m cofii2p_tpu_torch.train kitti --synthetic --fast --steps 4 --batch_size 8
    python -m cofii2p_tpu_torch.train kitti --synthetic kpconv_impl=banded_knn --steps 4 --batch_size 8
    python -m cofii2p_tpu_torch.train tiny --synthetic --steps 2 --device cpu   # tests
    torchrun --nproc_per_node 4 -m cofii2p_tpu_torch.train kitti --synthetic --batch_size 32   # 4 cards

``kitti`` reads the on-disk KITTI Odometry frames under ``data_path``
(data/kitti.py), ``nuscenes`` the builder's frames (data/nuscenes.py,
written by data/build_nuscenes.py); ``--synthetic`` needs no data.  Runs on
the card (``--device cuda``, the default) and raises when there is none;
``--device cpu`` runs the kernels' plain versions, for tests.
``--fast`` trains with the w256 dynamic windows of config.FAST_DYNAMIC_PLAN
(``with_fast_windows``, after the overrides: an explicit window plan wins,
and a ``banded_knn`` config is left alone).

Data parallelism: under ``torchrun`` (``WORLD_SIZE`` set) each process
joins the process group (NCCL on cards, gloo with ``--device cpu``), takes
the card of its ``LOCAL_RANK`` and its rows of every global batch of
``--batch_size`` (parallel/mesh.py; train_lib.py says why a step equals
the one-process step); a group the caller initialised is used as it is.
Rank 0 alone logs metrics and writes checkpoints.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from cofii2p_tpu_torch import train_lib
from cofii2p_tpu_torch.config import apply_overrides, get_config, with_fast_windows
from cofii2p_tpu_torch.data.loader import BatchLoader
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.parallel.mesh import make_mesh, shard_host_batch
from cofii2p_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from cofii2p_tpu_torch.utils.metrics import MetricWriter, setup_logger

VAL_BATCHES = 6


def build_dataset(name: str, cfg, mode: str, synthetic: bool, length: int = 64):
    if synthetic:
        from cofii2p_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(cfg, mode, length=length)
    if name == "kitti":
        from cofii2p_tpu_torch.data.kitti import KittiDataset

        return KittiDataset(cfg, mode)
    if name == "nuscenes":
        from cofii2p_tpu_torch.data.nuscenes import NuScenesDataset

        return NuScenesDataset(cfg, mode)
    raise ValueError(name)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trainer runs on the card (--device cpu is for tests)")
    return device


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "index"}


def join_process_group(device: torch.device):
    """Under torchrun (WORLD_SIZE set, no group yet) join the process group,
    NCCL for cards and gloo for the CPU, and take this rank's card.  Returns
    (the device to run on, whether this call created the group)."""
    created = False
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        created = True
    if device.type == "cuda" and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    return device, created


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
                        help="train with the w256 dynamic windows (config.FAST_DYNAMIC_PLAN); "
                             "explicit kpconv_dynamic_plan= overrides win")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu (tests)")
    parser.add_argument("overrides", nargs="*", help="config key=value overrides")
    # key=value overrides may come before or after the options
    args = parser.parse_intermixed_args(argv)

    cfg = apply_overrides(get_config(args.dataset), args.overrides)
    if args.fast:
        cfg = with_fast_windows(cfg)
    batch_size = args.batch_size or cfg.train_batch_size
    device, created_group = join_process_group(resolve_device(args.device))
    mesh = make_mesh(device.type)
    n_dev = mesh.size()
    if batch_size % n_dev and batch_size > 1:
        raise ValueError(f"batch_size {batch_size} not divisible by {n_dev} ranks")
    lead = not dist.is_initialized() or dist.get_rank() == 0

    ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    save_dir = os.path.join(cfg.root_path, cfg.save_path, args.dataset, ts)
    log_dir = os.path.join(cfg.root_path, cfg.log_path, args.dataset, ts)
    logger = setup_logger(log_dir if lead else None)
    if not lead:
        logger.setLevel("WARNING")
    writer = MetricWriter(log_dir) if lead else None
    logger.info("config: %s", cfg)
    logger.info("data parallel over %d rank(s)", n_dev)
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
    # staged on the card while the step runs; a rank of several slices it
    stage = device if device.type == "cuda" and n_dev == 1 else None
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True, num_workers=cfg.num_workers, to_device=stage)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False, num_workers=cfg.num_workers, to_device=stage)

    torch.manual_seed(42)
    model = CoFiI2P(cfg).to(device)
    optimizer = train_lib.make_optimizer(cfg, model.parameters())
    has_normals = getattr(train_ds, "has_normals", True)
    train_step = train_lib.make_train_step(cfg, model, optimizer, has_normals, mesh)
    eval_step = train_lib.make_eval_step(cfg, model, has_normals, mesh)
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
            hb = shard_host_batch(host_batch, mesh, device)
            metrics = train_step(hb, train_lib.make_train_draws(cfg, batch_size, gen, device, mesh))
            global_step += 1
            if global_step % 10 == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if writer:
                    writer.write(global_step, m)
                logger.info("train-%d-%d loss %.4f desc %.4f coarse %.4f fine %.4f", epoch, global_step,
                            m["loss"], m["loss_desc"], m["loss_coarse"], m["loss_fine"])
            if global_step % cfg.val_freq == 0:
                accs = []
                for i, vb in enumerate(val_loader.epoch(0)):
                    if i >= VAL_BATCHES:
                        break
                    r = eval_step(shard_host_batch(vb, mesh, device),
                                  train_lib.make_train_draws(cfg, batch_size, gen, device, mesh))
                    accs.append({k: float(v) for k, v in r.items()})
                mean = {k: float(np.mean([a[k] for a in accs])) for k in accs[0]}
                if writer:
                    writer.write(global_step, mean)
                logger.info("val @%d: %s", global_step, mean)
            if args.ckpt_every_steps and global_step % args.ckpt_every_steps == 0:
                if lead:
                    save_checkpoint(save_dir, global_step, model, optimizer)
                last_saved = global_step
            if args.steps and global_step >= args.steps:
                stop = True
                break
        if (stop or (epoch + 1) % max(args.ckpt_every_epochs, 1) == 0) and global_step != last_saved and lead:
            path = save_checkpoint(save_dir, global_step, model, optimizer)
            logger.info("saved %s", path)
        if stop:
            break
    if writer:
        writer.close()
    if created_group:
        dist.destroy_process_group()
    return save_dir


if __name__ == "__main__":
    main()
