"""Static-shape batch assembly (host side, NumPy).

The port's own copy of pillarnext_tpu/data/collate.py: every sample's
points are padded (or randomly subsampled) to a fixed ``max_points``
capacity with a validity mask, so the batch is a dense (B, N, D) array +
(B, N) mask.  Per-task target lists become stacked arrays.
"""

from __future__ import annotations

import numpy as np


def pad_points(
    points: np.ndarray, max_points: int, rng: np.random.Generator | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pad (N, D) points to (max_points, D) + mask; random subsample on
    overflow (the reference never drops in-range points — overflow should be
    sized away via config; subsampling is the graceful fallback)."""
    n, d = points.shape
    out = np.zeros((max_points, d), points.dtype)
    mask = np.zeros((max_points,), bool)
    if n > max_points:
        rng = rng or np.random.default_rng()
        sel = rng.choice(n, max_points, replace=False)
        out[:] = points[sel]
        mask[:] = True
    else:
        out[:n] = points
        mask[:n] = True
    return out, mask


def collate(batch: list[dict], max_points: int, rng: np.random.Generator | None = None) -> dict:
    """Merge per-sample dicts into batched arrays.

    - 'token'  -> list of tokens
    - 'points' -> (B, N, D) float32 + 'points_mask' (B, N) bool
    - per-task target lists (hm/anno_box/ind/mask/cat/gt_boxes) -> lists of
      stacked (B, ...) arrays, one entry per task group
    - everything else -> stacked
    """
    out: dict = {}
    keys = batch[0].keys()
    for key in keys:
        vals = [b[key] for b in batch]
        if key == "token":
            out[key] = vals
        elif key == "points":
            padded = [pad_points(np.asarray(v, np.float32), max_points, rng) for v in vals]
            out["points"] = np.stack([p for p, _ in padded])
            out["points_mask"] = np.stack([m for _, m in padded])
        elif isinstance(vals[0], list):
            num_tasks = len(vals[0])
            out[key] = [
                np.stack([np.asarray(v[t]) for v in vals]) for t in range(num_tasks)
            ]
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out
