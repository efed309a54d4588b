"""Success-rate / error aggregation CLI (a numpy copy of
cofii2p_tpu/evaluation/calc_result.py).

Same tables as the reference evaluator: success rate plus mean/std RRE/RTE
at thresholds (inf, inf), (45 deg, 10 m), (10 deg, 5 m), read from the
``{dataset}_{r,t}_error.npy`` arrays that evaluation/eval_all.py writes.
"""

from __future__ import annotations

import argparse

import numpy as np


def report(r_error: np.ndarray, t_error: np.ndarray, r_thrs: float, t_thrs: float):
    succ = np.logical_and(r_error < r_thrs, t_error < t_thrs)
    print("--------------error calculation---------------------")
    print("r_thrs: %.2f, t_thrs: %.2f" % (r_thrs, t_thrs))
    rate = succ.sum() / max(len(succ), 1) * 100.0
    print(
        "rot thrs: %.4f, trans thrs: %.4f, successful rate %0.2f %%"
        % (r_thrs, t_thrs, rate)
    )
    if succ.any():
        print("succ_r_mean: %.2f, succ_r_std: %.2f" % (r_error[succ].mean(), r_error[succ].std()))
        print("succ_t_mean: %.2f, succ_t_std: %.2f" % (t_error[succ].mean(), t_error[succ].std()))
    print("----------Done!----------")
    return rate


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset", nargs="?", default="kitti")
    args = parser.parse_args(argv)
    r_error = np.load(f"{args.dataset}_r_error.npy")
    t_error = np.load(f"{args.dataset}_t_error.npy")
    for r_t, t_t in [(1e5, 1e5), (45, 10), (10, 5)]:
        report(r_error, t_error, r_t, t_t)


if __name__ == "__main__":
    main()
