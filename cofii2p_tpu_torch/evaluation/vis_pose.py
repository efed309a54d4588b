"""Visualise a registration result: project the cloud with the GT and the
predicted pose and draw both (counterpart of
cofii2p_tpu/evaluation/vis_pose.py), from a per-frame dump of eval_all.

    python -m cofii2p_tpu_torch.evaluation.vis_pose <frame.npy> [--out pose_vis.png]

matplotlib is imported when the figure is drawn, not with the module.
"""

from __future__ import annotations

import argparse

import numpy as np


def project(P: np.ndarray, K: np.ndarray, pts: np.ndarray):
    """World points (N, 3) -> pixels (N, 2) and depths (N,) under the camera
    pose P (4, 4), world-to-camera being inv(P), and intrinsics K (3, 3)."""
    Pi = np.linalg.inv(P)
    cam = pts @ Pi[:3, :3].T + Pi[:3, 3]
    uvz = cam @ K.T
    z = uvz[:, 2]
    uv = uvz[:, :2] / np.maximum(z[:, None], 1e-9)
    return uv, z


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("frame", help="a per-frame .npy dump from eval_all")
    parser.add_argument("--out", default="pose_vis.png")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = np.load(args.frame, allow_pickle=True).item()
    K = np.asarray(d["K"], np.float64)
    obj = np.asarray(d["object_points"], np.float64)
    mask = np.asarray(d.get("corr_mask", np.ones(len(obj), bool))) > 0

    fig, axes = plt.subplots(1, 2, figsize=(12, 4), sharex=True, sharey=True)
    for ax, key, title in ((axes[0], "GT_P", "ground-truth pose"), (axes[1], "pred_P", "predicted pose")):
        uv, z = project(np.asarray(d[key], np.float64), K, obj[mask])
        front = z > 0
        sc = ax.scatter(uv[front, 0], uv[front, 1], c=z[front], s=4, cmap="turbo")
        ax.set_title(title)
        ax.invert_yaxis()
        ax.set_aspect("equal")
    fig.colorbar(sc, ax=axes, label="depth (m)", shrink=0.8)
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
