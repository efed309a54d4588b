"""Plot inlier-ratio curves from saved IR arrays (counterpart of
cofii2p_tpu/evaluation/vis_ir.py): overlays the curves over the
pixel-threshold sweep and writes a figure.

    python -m cofii2p_tpu_torch.evaluation.vis_ir ir1.npy [ir2.npy ...] [--labels a b] [--out ir_curve.png]

matplotlib is imported when the figure is drawn, not with the module.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("ir_files", nargs="+")
    parser.add_argument("--labels", nargs="*", default=None)
    parser.add_argument("--out", default="ir_curve.png")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    thresholds = np.arange(0, 10.2, 0.2)
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, f in enumerate(args.ir_files):
        ir = np.load(f)
        label = args.labels[i] if args.labels and i < len(args.labels) else f.rsplit("/", 1)[-1]
        ax.plot(thresholds[: len(ir)], ir, label=label, linewidth=2)
    ax.set_xlabel("pixel threshold")
    ax.set_ylabel("inlier ratio")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.out, dpi=150)
    plt.close(fig)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
