"""CenterNet gaussian heatmap utilities (host side, NumPy).

The port's own copy of pillarnext_tpu/core/gaussian.py: the CornerNet
three-case radius and the max-composited gaussian stamp used by the target
assigner (data/assign.py).
"""

from __future__ import annotations

import numpy as np


def gaussian_radius(det_size: tuple[float, float], min_overlap: float = 0.5) -> float:
    """CornerNet radius: the largest stamp radius keeping IoU >= min_overlap
    for the three corner-shift cases (center_utils.py:12-32)."""
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1**2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2**2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3**2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape: tuple[int, int], sigma: float = 1.0) -> np.ndarray:
    """Unnormalized 2-D gaussian patch (center_utils.py:35-41)."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> np.ndarray:
    """Stamp a gaussian onto ``heatmap`` (H, W) at integer ``center`` (x, y),
    compositing with elementwise max (center_utils.py:44-60). In place."""
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top : y + bottom, x - left : x + right]
    masked_gaussian = gaussian[radius - top : radius + bottom, radius - left : radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap
