"""The numbers that decide ``correct``, each against a limit of its own.

Serving: the program's answers for a seeded sample of the window's
requests against the plain reference's answers for the same frames,
weights and draws, recomputed from scratch in fp32 with TF32 off:

- ``prep``: sample prep (pose inversion, Morton pyramid, sampling): the
  largest gap in the ground-truth pose or a super-point's coordinates;
- ``score``: the network's coarse stage: the largest gap in a
  super-point's overlap score;
- ``coarse``: the share of super-points whose best image cell differs;
- ``fine``: the fine match, among super-points whose best cell agrees:
  the share whose pixel inside the cell differs;
- ``selection``: the share of correspondence-mask entries that differ;
- ``pose``: the pose solver: the reference solver is run on the
  program's own correspondences and draws (it follows the program from
  there, since a different coarse cell changes every later stage), and
  the largest gap of an entry of R, or of t relative to max(1, |t|), is
  taken; an entry finite on one side only, or a frame whose success flag
  or inlier count differs, reads 1.
"""

from __future__ import annotations

import torch

SERVE_NUMBERS = ("prep", "score", "coarse", "fine", "selection", "pose")


def _cells(xy: torch.Tensor) -> torch.Tensor:
    """The /8 image cell (as 4 * cell on the /2 image) a fine pixel lies in:
    fine_xy = 4 * cell - 2 + (0..3)."""
    return torch.floor((xy + 2.0) / 4.0)


def _entry_gap(p: torch.Tensor, r: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per frame, the largest gap of (B, n) entries over ``scale`` (B,):
    two non-finite entries agree, a finite and a non-finite one read 1."""
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    gap = torch.where(fp & fr, (p - r).abs() / scale[:, None], torch.zeros_like(p))
    gap = torch.where(fp != fr, torch.ones_like(p), gap)
    return gap.amax(1)


def pose_gap(prog: dict, ref: dict) -> float:
    R_p, t_p, R_r, t_r = (x.float().cpu() for x in (prog["R"], prog["t"], ref["R"], ref["t"]))
    b = R_p.shape[0]
    t_scale = torch.nan_to_num(t_r, nan=0.0, posinf=0.0, neginf=0.0).abs().amax(1).clamp(min=1.0)
    gap = torch.maximum(_entry_gap(R_p.reshape(b, 9), R_r.reshape(b, 9), torch.ones(b)),
                        _entry_gap(t_p, t_r, t_scale))
    differ = (prog["success"].cpu() != ref["success"].cpu()) | (
        prog["num_inliers"].cpu().long() != ref["num_inliers"].cpu().long())
    gap[differ] = torch.maximum(gap[differ], torch.ones(()))
    return float(gap.max())


def serve_numbers(prog: dict, ref: dict, pose_ref: dict) -> dict:
    """The six numbers of one request (module docstring)."""
    f = {k: (v.float() if v.is_floating_point() else v) for k, v in prog.items()}
    prep = max(float((f["P_gt"] - ref["P_gt"]).abs().max()),
               float((f["object_points"] - ref["object_points"]).abs().max()))
    score = float((f["pc_score"] - ref["pc_score"]).abs().max())
    cp, cr = _cells(f["fine_xy"]), _cells(ref["fine_xy"])
    same = (cp == cr).all(-1)
    moved = ((f["fine_xy"] - ref["fine_xy"]).abs() > 1e-6).any(-1)
    return dict(
        prep=prep, score=score, coarse=float((~same).float().mean()),
        fine=float((moved & same).sum()) / max(int(same.sum()), 1),
        selection=float((prog["corr_mask"] != ref["corr_mask"]).float().mean()),
        pose=pose_gap(prog, pose_ref),
    )


def worst(rows: list) -> dict:
    """Each number's largest reading over the checked requests or steps."""
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


def judge(numbers: dict, limits: dict) -> list:
    """(name, value, limit, within) of every number the cell's limits name
    (a cell may leave out a number that does not separate the program from
    its control); a limit without a number is an error."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits name numbers the run did not read: {sorted(missing)}")
    return [(k, numbers[k], limits[k], numbers[k] <= limits[k]) for k in limits]
