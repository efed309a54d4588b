"""Sharded equals single: one data-parallel TinyConfig train step and one
sharded eval step against the same steps in one process (counterpart of
__graft_entry__.py::dryrun_multichip).

    python -m cofii2p_tpu_torch.parallel.dryrun [--n 2]

``n`` CPU processes join a gloo group on a ``FileStore`` (no network);
each holds a replica of the seeded model and its rows of a global batch of
``n`` frames and of the step's draws, takes one train step (gradients
averaged, BatchNorm statistics all-reduced; train_lib.py) and then one
eval step (make_eval_body) on its rows.  The parent takes the train step
alone on the whole batch, and the eval step alone on the whole batch with
the parameters the ranks reached, and asserts:

- the step's losses within 1e-5 rel;
- the rank-averaged gradient against the one-process gradient within
  ``GRAD_TOL`` per tensor (norm-relative): a frame's arithmetic on the CPU
  depends on the batch it sits in by an ulp (the sgemm of
  ``einsum('bmkc,kcd->bmd')`` blocks a 128-row batch otherwise than a
  256-row one), and a LeakyReLU or a max that this moves across its kink
  moves a gradient element of a deep layer, which sums few points at
  TinyConfig; 2.9e-4 of the whole gradient, at most 9.8e-4 of a tensor's,
  on the CPU.  The biases a group norm cancels (models/kpconv.py::
  norm_cancelled_biases) have a gradient of rounding noise alone, so
  theirs is held to ``GRAD_TOL`` of the whole gradient's norm instead;
- the updated parameters within 1e-5 rel (rms-floored) of the
  one-process ones at every element whose gradient the two runs agree on
  (|dg| <= 1e-3 |g|, |g| > 1e-5).  Adam's first step moves a parameter by
  lr * g / (|g| + eps), +-lr wherever |g| >> eps, so an element whose
  gradient is at the level of the runs' difference may move by up to
  2 lr apart, and is held to that;
- the eval outputs: success flags equal, poses within 1e-5.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

TOL = 1e-5
GRAD_TOL = 2e-3


def _host_batch(cfg, batch: int) -> dict:
    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(cfg, "val", length=batch)
    hb = _collate([ds[i] for i in range(batch)])
    hb.pop("index")
    return hb


def train_once(cfg, host: dict, mesh, device="cpu") -> dict:
    """One train step of the seeded model on this rank's rows of ``host``
    and of the draws of a generator seeded 1: the updated state dict, the
    (averaged) gradients and the step's metrics."""
    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.parallel.mesh import shard_host_batch

    torch.manual_seed(0)
    model = CoFiI2P(cfg).to(device)
    optimizer = train_lib.make_optimizer(cfg, model.parameters())
    bsz = host["img"].shape[0]
    draws = train_lib.make_train_draws(cfg, bsz, torch.Generator(device).manual_seed(1), device, mesh)
    metrics = train_lib.make_train_step(cfg, model, optimizer, mesh=mesh)(shard_host_batch(host, mesh, device), draws)
    return {"state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters() if p.grad is not None},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def eval_once(cfg, host: dict, state: dict, mesh, device="cpu") -> dict:
    """make_eval_body with ``state`` on this rank's rows of ``host`` and of
    the draws of a generator seeded 2."""
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws, make_eval_body
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.parallel.mesh import shard_host_batch, shard_tree

    model = CoFiI2P(cfg)
    model.load_state_dict(state)
    bsz = host["img"].shape[0]
    draws = shard_tree(make_draws(cfg, bsz, torch.Generator(device).manual_seed(2), device), bsz, mesh)
    out = make_eval_body(cfg, model.to(device).eval())(shard_host_batch(host, mesh, device), draws=draws)
    return {k: v.cpu() for k, v in out._asdict().items()}


def _worker(rank: int, n: int, store_path: str, out_dir: str) -> None:
    from cofii2p_tpu_torch.config import TinyConfig
    from cofii2p_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * n)))
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank, world_size=n)
    try:
        cfg = TinyConfig()
        host, mesh = _host_batch(cfg, n), make_mesh("cpu")
        res = train_once(cfg, host, mesh)
        res["eval"] = eval_once(cfg, host, res["state"], mesh)
        if rank:  # replicas: rank 0's parameters speak for all
            res = {"eval": res["eval"]}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _rel(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|a - ref| / max(|ref|, rms(ref)), elementwise, float64."""
    a, ref = a.double(), ref.double()
    rms = ref.pow(2).mean().sqrt() + 1e-30
    return (a - ref).abs() / ref.abs().clamp(min=rms)


def dryrun_multiprocess(n: int = 2, workdir: str | None = None) -> dict:
    """Run the check; returns what it measured (and raises AssertionError
    where a reading is over its limit)."""
    from cofii2p_tpu_torch.config import TinyConfig
    from cofii2p_tpu_torch.models.kpconv import norm_cancelled_biases
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.parallel.mesh import make_mesh

    workdir = workdir or tempfile.mkdtemp(prefix="dryrun_")
    os.makedirs(workdir, exist_ok=True)
    torch.multiprocessing.spawn(_worker, args=(n, os.path.join(workdir, "store"), workdir), nprocs=n, join=True)
    parts = [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(n)]

    cfg = TinyConfig()
    host, alone = _host_batch(cfg, n), make_mesh("cpu")
    single = train_once(cfg, host, alone)
    dp = parts[0]
    loss_err = max(abs(dp["metrics"][k] - single["metrics"][k]) / max(abs(single["metrics"][k]), 1e-30)
                   for k in ("loss", "loss_desc", "loss_coarse", "loss_fine"))
    cancelled = {"pc_encoder." + name for name in norm_cancelled_biases(CoFiI2P(cfg).pc_encoder)}
    g_all = torch.cat([g.flatten() for g in single["grads"].values()]).norm()
    grad_err = max(((dp["grads"][k] - g).norm() / (g_all if k in cancelled else g.norm()).clamp(min=1e-30)).item()
                   for k, g in single["grads"].items())
    param_err, undecided, undecided_move = 0.0, 0, 0.0
    for k, ref in single["state"].items():
        if not ref.is_floating_point():
            continue
        err = _rel(dp["state"][k], ref)
        if k in single["grads"]:
            g = single["grads"][k]
            agreed = ((dp["grads"][k] - g).abs() <= 1e-3 * g.abs()) & (g.abs() > 1e-5)
            undecided += int((~agreed).sum())
            if (~agreed).any():
                undecided_move = max(undecided_move, (dp["state"][k] - ref)[~agreed].abs().max().item())
            err = err[agreed]
        param_err = max(param_err, err.max().item() if err.numel() else 0.0)

    ev = {k: torch.cat([p["eval"][k] for p in parts]) for k in parts[0]["eval"]}
    ref_ev = eval_once(cfg, host, dp["state"], alone)
    if not torch.equal(ev["success"], ref_ev["success"]):
        raise AssertionError(f"success flags {ev['success']} sharded, {ref_ev['success']} alone")
    pose_err = max(_rel(torch.nan_to_num(ev[k]), torch.nan_to_num(ref_ev[k])).max().item() for k in ("R", "t"))
    found = dict(losses=loss_err, gradients=grad_err, params=param_err, undecided=undecided,
                 undecided_move=undecided_move, poses=pose_err, success=int(ev["success"].sum()))
    if max(loss_err, param_err, pose_err) > TOL or grad_err > GRAD_TOL or undecided_move > 2 * cfg.lr * (1 + 1e-5):
        raise AssertionError(f"the sharded steps differ from the one-process steps: {found}")
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description="data-parallel step == one-process step, on CPU processes")
    ap.add_argument("--n", type=int, default=2, help="processes")
    args = ap.parse_args(argv)
    found = dryrun_multiprocess(args.n)
    print(f"dryrun_multiprocess({args.n}): sharded train and eval steps equal the one-process steps: " + ", ".join(
        f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}" for k, v in found.items()))


if __name__ == "__main__":
    main()
