"""Inlier-ratio and reprojection-RMSE curves over pixel thresholds (a
numpy copy of cofii2p_tpu/evaluation/ir_rmse.py).

Re-projects the predicted correspondences' object points of each per-frame
dump of evaluation/eval_all.py with the GT pose and sweeps the pixel
threshold 0..10.2 in steps of 0.2, as the reference's IR_RMSE.py does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def frame_residuals(data: dict) -> np.ndarray:
    gt_P = data["GT_P"]
    K = data["K"]
    obj = np.asarray(data["object_points"])  # (S, 3)
    fine_xy = np.asarray(data["fine_xy"])  # (2, S)
    mask = np.asarray(data.get("corr_mask", np.ones(obj.shape[0], bool))) > 0
    P = np.linalg.inv(gt_P)
    Rinv = np.linalg.inv(P[:3, :3])
    cam = (Rinv @ obj.T) - (Rinv @ P[:3, 3:])
    uvw = K @ cam
    gt_px = uvw[:2] / np.maximum(uvw[2:], 1e-12)
    res = np.sqrt(np.sum((fine_xy - gt_px) ** 2, axis=0))
    return res[mask]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation of CoFiI2P (IR/RMSE)")
    parser.add_argument("dataset", type=str)
    parser.add_argument("--eval_results_path", type=str, default="eval_results")
    parser.add_argument("--run", type=str, default="", help="timestamp subdir; latest if empty")
    args = parser.parse_args(argv)

    base = os.path.join(args.eval_results_path, args.dataset)
    run = args.run or sorted(os.listdir(base))[-1]
    results_path = os.path.join(base, run)
    files = sorted(f for f in os.listdir(results_path) if f.endswith(".npy"))

    residuals = [
        frame_residuals(np.load(os.path.join(results_path, f), allow_pickle=True).item())
        for f in files
    ]
    thresholds = np.arange(0, 10.2, 0.2)
    ir_curve, rmse_curve = [], []
    for thr in thresholds:
        irs = [np.mean(r <= thr) if len(r) else 0.0 for r in residuals]
        rmses = [np.mean(r) if len(r) else 0.0 for r in residuals]
        print(f"{thr} avg ir:", float(np.mean(irs)))
        print(f"{thr} avg rmse:", float(np.mean(rmses)))
        ir_curve.append(np.mean(irs))
        rmse_curve.append(np.mean(rmses))
    np.save(f"cofii2p_{args.dataset}_ir.npy", np.asarray(ir_curve))
    np.save(f"cofii2p_{args.dataset}_rmse.npy", np.asarray(rmse_curve))
    return np.asarray(ir_curve), np.asarray(rmse_curve)


if __name__ == "__main__":
    main()
