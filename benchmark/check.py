"""The comparison that decides ``correct``: the numbers, and their limits
from ``benchmark/checks/<cell>.json`` (each limit with the readings it
was set from, PERF.md section 2).

Training, over the first three steps of the one object the window runs:
- ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss (``first_loss_gap``: the first step's);
- ``grad_gap``: the worst leaf's |program norm - reference norm| of the
  first step's gradient as the optimizer got it, before its global-norm
  clip (the program's read from its AdamW state: m / (1 - beta1) times
  the clip's divisor, max(1, norm / clip)), over the larger of that
  leaf's reference norm and the median leaf's;
- ``update_gap``: the same of each parameter's change after the three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone);
- ``grad_gap_median``, ``update_gap_median``: the median leaf's gap.

Which of these a cell compares, and each one's limit, its checks file
says; the others are worked out and not compared.

Evaluation, over batches of the window sampled from the seed: each of
the reference's detections is matched to the program's nearest of the
same label within ``MATCH_M`` metres (centre to centre);
- ``missed``: the share of the reference's detections left unmatched;
- ``score_gap``: the median |score difference| of the matched;
- ``centre_gap``: the median centre distance of the matched, in metres;
- ``missed_top``: as ``missed``, of the reference's detections that score
  at least its median score (worked out to compare, not compared).
"""

from __future__ import annotations

import json

import numpy as np

from benchmark.spec import HERE

MATCH_M = 0.5
MOVING = 1e-3  # of the median leaf's reference gradient


def limits(cell: str) -> dict:
    path = HERE / "checks" / f"{cell}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def rated(cell: str, values: dict) -> list:
    """[(name, value, limit)] of the numbers the cell's checks file
    compares; without the file, every number, each without a limit."""
    lim = limits(cell)
    return [(k, float(v), lim.get(k)) for k, v in values.items() if k in lim or not lim]


def gaps(program: dict, reference: dict, names) -> list:
    """Each leaf's |program norm - reference norm| over the larger of its
    reference norm and the median leaf's."""
    names = list(names)
    if not names:
        return [0.0]
    med = float(np.median([reference[n] for n in names]))
    return [abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names]


def train_values(p_losses, p_grad, p_update, ref: dict) -> dict:
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p_losses, ref["losses"]))
    med = float(np.median(list(ref["first_grad"].values())))
    moving = [n for n, g in ref["first_grad"].items() if g >= MOVING * med]
    g, u = gaps(p_grad, ref["first_grad"], ref["first_grad"]), gaps(p_update, ref["update"], moving)
    return {"loss_gap": loss_gap, "first_loss_gap": abs(p_losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": max(g), "grad_gap_median": float(np.median(g)),
            "update_gap": max(u), "update_gap_median": float(np.median(u))}


def frame_values(prog: dict, ref: dict, floor: float = -np.inf) -> tuple:
    """(reference detections, of them unmatched, matched score gaps,
    matched centre distances) of one frame, over the reference's
    detections that score ``floor`` or more.  ``prog`` and ``ref`` hold
    numpy ``boxes`` (n, 9), ``scores`` and ``labels`` of valid detections."""
    missed, gaps, dists, total = 0, [], [], 0
    for box, score, label in zip(ref["boxes"], ref["scores"], ref["labels"]):
        if score < floor:
            continue
        total += 1
        same = np.nonzero(prog["labels"] == label)[0]
        if not len(same):
            missed += 1
            continue
        d = np.hypot(prog["boxes"][same, 0] - box[0], prog["boxes"][same, 1] - box[1])
        j = int(np.argmin(d))
        if d[j] > MATCH_M:
            missed += 1
            continue
        gaps.append(abs(float(prog["scores"][same[j]]) - float(score)))
        dists.append(float(d[j]))
    return total, missed, gaps, dists


def eval_values(frames: list) -> dict:
    """``frames``: (program, reference) detection dicts."""
    total = missed = 0
    gaps, dists = [], []
    for prog, ref in frames:
        n, m, g, d = frame_values(prog, ref)
        total, missed = total + n, missed + m
        gaps += g
        dists += d
    if not total:
        return {"missed": float("nan"), "score_gap": float("nan"), "centre_gap": float("nan"),
                "missed_top": float("nan")}
    floor = float(np.median(np.concatenate([np.asarray(ref["scores"], dtype=np.float64) for _, ref in frames])))
    top = [frame_values(prog, ref, floor) for prog, ref in frames]
    return {"missed": missed / total, "score_gap": float(np.median(gaps)) if gaps else 1.0,
            "centre_gap": float(np.median(dists)) if dists else MATCH_M,
            "missed_top": sum(t[1] for t in top) / max(sum(t[0] for t in top), 1)}


def correct(checks: list) -> bool:
    """Every number within its limit; a number without a limit, or one
    that is not finite, fails."""
    return bool(checks) and all(lim is not None and np.isfinite(v) and v <= lim for _, v, lim in checks)
