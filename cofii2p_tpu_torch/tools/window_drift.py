"""What a band plan changes, measured without RANSAC or training noise
(counterpart of tools/window_drift.py): the same frames, weights and
random draws are forwarded under the static band plan and under each
candidate window plan, and :func:`drift` compares the outputs:

  - coarse-argmax drift: the share of superpoints whose best image token
    (argmax of pc_feature_norm @ img_feature_norm) changed;
  - selection drift: the share of inlier_mask entries that changed (the
    closed-form test-mode selection);
  - fine-cell drift: the share of the superpoints either output selects
    whose fine pixel (fine_match_xy) moved;
  - score drift: the largest |coarse_pc_score| change.

Random weights give drift, not RRE or RTE.

    python -m cofii2p_tpu_torch.tools.window_drift [<ckpt>] [--frames 32] [--batch 8] [--plans w256,w192]
        [--dtype bfloat16] [--knn]
    python -m cofii2p_tpu_torch.tools.window_drift --tiny        # TinyConfig on the CPU

``<ckpt>`` is a port checkpoint or a reference ``.t7`` (eval_all's
load_weights); without one, seeded random weights.  ``--knn`` compares
k-NN window plans (``kpconv_knn_window_plan``, knn256 etc.) on the
configuration a reference checkpoint runs (banded_knn, per-layer kernel
points, the reference fine decode), where 0 drift means exact windows.
"""

from __future__ import annotations

import argparse
import json

import torch

# candidate plans: (kpconv_dynamic_plan, kpconv_dynamic_plan_self)
CATALOG = {
    "w256": ((0, 256, 256, 256, 0), (0, 0, 256, 256, 0)),
    "w192": ((0, 192, 192, 192, 0), (0, 0, 192, 192, 0)),
    "w128": ((0, 128, 128, 128, 0), (0, 0, 128, 128, 0)),
    "c0w256": ((256, 192, 192, 192, 0), (0, 0, 192, 192, 0)),
    "s4w256": ((0, 192, 192, 192, 0), (0, 0, 192, 192, 256)),
    "selfw256": ((0, 192, 192, 192, 0), (256, 256, 192, 192, 256)),
    "all256": ((256, 256, 256, 256, 0), (256, 256, 256, 256, 256)),
    "w8": ((0, 8, 8, 8, 0), (0, 0, 8, 8, 0)),  # tiny smoke
}
# candidate k-NN window plans (kpconv_knn_window_plan)
KNN_CATALOG = {
    "knn640": (640,) * 5,
    "knn512": (512,) * 5,
    "knn384": (384,) * 5,
    "knn256": (256,) * 5,
    "knn192": (192,) * 5,
    "knngrade": (256, 256, 384, 640, 0),
    "knngrade2": (384, 384, 512, 0, 0),
    "knn8": (8,) * 5,  # tiny smoke
}


def outputs(model, batch: dict, cfg) -> dict:
    """What :func:`drift` compares, from one test-mode forward of a
    prepared batch: each superpoint's best image token, the selection
    mask, the fine pixel and the coarse score."""
    from cofii2p_tpu_torch.models.network import fine_match_xy

    with torch.no_grad():
        out = model(batch, mode="test")
        b = out["pc_feature_norm"].shape[0]
        sim = torch.einsum("bsc,blc->bsl", out["pc_feature_norm"].float(),
                           out["img_feature_norm"].reshape(b, -1, cfg.d_model).float())
        fine_xy = fine_match_xy(out["fine_img_patch"], out["fine_pc_feature"], out["fine_center_xy"],
                                cfg.fine_decode)
    return dict(argmax=sim.argmax(-1), mask=out["inlier_mask"], fine_xy=fine_xy,
                score=out["coarse_pc_score"].float())


def selected(a: dict, b: dict) -> int:
    """Superpoints that either output selects (at least 1)."""
    return max(int((a["mask"] | b["mask"]).sum()), 1)


def drift(a: dict, b: dict) -> dict:
    """The four readings between two :func:`outputs`: coarse-argmax drift,
    selection drift, fine-cell drift among the superpoints either selects,
    max score drift."""
    either = a["mask"] | b["mask"]
    moved = (a["fine_xy"] - b["fine_xy"]).abs().amax(-1) > 1e-6
    return dict(argmax=float((a["argmax"] != b["argmax"]).float().mean()),
                selection=float((a["mask"] != b["mask"]).float().mean()),
                fine_cell=float((moved & either).sum()) / selected(a, b),
                score=float((a["score"] - b["score"]).abs().max()))


def main(argv=None):
    from cofii2p_tpu_torch.config import KITTIConfig, TinyConfig
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset
    from cofii2p_tpu_torch.evaluation.eval_all import load_weights
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.train import resolve_device
    from cofii2p_tpu_torch.utils.convert import randomize

    ap = argparse.ArgumentParser(description="drift of window band plans against the static plan")
    ap.add_argument("ckpt", nargs="?", default=None)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--plans", default="w256,w192", help="candidate plans compared with the static bands")
    ap.add_argument("--tiny", action="store_true", help="TinyConfig on the CPU (plans w8 or knn8)")
    ap.add_argument("--tile", type=int, default=0, help="override cfg.kpconv_tile (0 keeps it)")
    ap.add_argument("--knn", action="store_true", help="k-NN window plans on the reference-checkpoint config")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    if args.tiny:
        base = TinyConfig(compute_dtype=args.dtype)
        args.plans = "knn8" if args.knn else "w8"
        args.frames, args.batch, args.device = min(args.frames, 8), min(args.batch, 4), "cpu"
    else:
        base = KITTIConfig(compute_dtype=args.dtype)
    if args.tile:
        base = base.replace(kpconv_tile=args.tile)
    if args.knn:
        base = base.replace(kpconv_impl="banded_knn", kpconv_shared_influence=False, fine_decode="reference")
    device = resolve_device(args.device)
    if device.type == "cuda" and base.compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    ds = SyntheticDataset(base, "val", length=args.frames)
    n_batches = args.frames // args.batch
    hbs = []
    for k in range(n_batches):
        hb = _collate([ds[k * args.batch + i] for i in range(args.batch)])
        hbs.append({key: torch.as_tensor(v).to(device) for key, v in hb.items() if key != "index"})
    gen = torch.Generator(device).manual_seed(7)
    draws = [make_draws(base, args.batch, gen, device) for _ in hbs]
    static = base.replace(kpconv_dynamic_plan=None, kpconv_dynamic_plan_self=None)
    weights = load_weights(args.ckpt or "", randomize(CoFiI2P(static), torch.Generator().manual_seed(0)))
    state = weights.state_dict()

    def outputs_for(cfg) -> dict:
        model = CoFiI2P(cfg)
        model.load_state_dict(state)
        model.to(device).eval()
        outs = []
        for hb, dr in zip(hbs, draws):
            batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, dr["perms"])
            outs.append(outputs(model, batch, cfg))
        return {k: torch.cat([o[k] for o in outs]).cpu() for k in outs[0]}

    ref = outputs_for(static)
    print(f"static reference: {int(ref['mask'].sum())} selected superpoints over {n_batches * args.batch} frames")
    results = {}
    for name in args.plans.split(","):
        if args.knn:
            cand = base.replace(kpconv_knn_window_plan=KNN_CATALOG[name])
        else:
            plan, plan_self = CATALOG[name]
            cand = base.replace(kpconv_dynamic_plan=plan, kpconv_dynamic_plan_self=plan_self)
        d = drift(ref, outputs_for(cand))
        results[name] = d
        print(f"{name:9s}: coarse-argmax drift {d['argmax'] * 100:5.2f}%, selection drift {d['selection'] * 100:5.2f}%, "
              f"fine-cell drift (selected) {d['fine_cell'] * 100:5.2f}%, max score drift {d['score']:.4f}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
