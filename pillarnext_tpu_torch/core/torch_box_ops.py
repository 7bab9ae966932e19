"""Rotated BEV box geometry on tensors.

Counterpart of pillarnext_tpu/core/jax_box_ops.py: the branch-free
boundary-integral overlap (:154-222) and ``boxes_iou_bev`` (:275).  Every op
is elementwise over broadcast shapes, so a batch of IoU matrices is one
call.  Box convention: [x, y, z, dx, dy, dz, yaw], yaw CCW around +z.
"""

from __future__ import annotations

import torch

_EPS_DIST = 1e-5  # on-boundary margin, in metres of point-to-edge distance


def _corners_xy(x, y, dx, dy, yaw):
    """CCW corner component lists ([x0..x3], [y0..y3])."""
    hx, hy = dx * 0.5, dy * 0.5
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = (hx, -hx, -hx, hx)
    ly = (hy, hy, -hy, -hy)
    cx = [lxi * c - lyi * s + x for lxi, lyi in zip(lx, ly)]
    cy = [lxi * s + lyi * c + y for lxi, lyi in zip(lx, ly)]
    return cx, cy


def _boundary_integral(px, py, qx, qy, inclusive: bool):
    """Sum over P's edges of the line integral of (x dy - y dx) restricted
    to Q's interior, by clipping each edge's parameter interval.  Edges
    exactly on Q's boundary count as inside when ``inclusive``."""
    ex = [qx[(k + 1) % 4] - qx[k] for k in range(4)]
    ey = [qy[(k + 1) % 4] - qy[k] for k in range(4)]
    scale = [ex[k].abs() + ey[k].abs() + 1e-12 for k in range(4)]
    s = [
        [ex[k] * (py[i] - qy[k]) - ey[k] * (px[i] - qx[k]) for k in range(4)]
        for i in range(4)
    ]
    total = None
    for i in range(4):
        j = (i + 1) % 4
        t_lo, t_hi = None, None
        for k in range(4):
            s0, s1 = s[i][k], s[j][k]
            denom = s1 - s0
            margin = _EPS_DIST * scale[k]
            degen = denom.abs() < margin
            tc = -s0 / torch.where(degen, margin, denom)
            degen_empty = degen & ((s0 < -margin) if inclusive else (s0 < margin))
            zero, one = torch.zeros_like(tc), torch.ones_like(tc)
            lo_k = torch.where(~degen & (denom > 0), tc, torch.where(degen_empty, 2.0 * one, zero))
            hi_k = torch.where(~degen & (denom < 0), tc, torch.where(degen_empty, -one, one))
            t_lo = lo_k if t_lo is None else torch.maximum(t_lo, lo_k)
            t_hi = hi_k if t_hi is None else torch.minimum(t_hi, hi_k)
        t_lo = t_lo.clamp(0.0, 1.0)
        t_hi = torch.maximum(t_hi.clamp(0.0, 1.0), t_lo)
        dx, dy = px[j] - px[i], py[j] - py[i]
        x0, y0 = px[i] + t_lo * dx, py[i] + t_lo * dy
        x1, y1 = px[i] + t_hi * dx, py[i] + t_hi * dy
        contrib = x0 * y1 - x1 * y0
        total = contrib if total is None else total + contrib
    return total


def overlap_core(ax, ay, adx, ady, ayaw, bx, by, bdx, bdy, byaw):
    """Exact BEV intersection area of rotated rectangles (Green's theorem:
    A's edges inside B plus B's edges inside A); broadcast shapes."""
    cax, cay = _corners_xy(ax, ay, adx, ady, ayaw)
    cbx, cby = _corners_xy(bx, by, bdx, bdy, byaw)
    ia = _boundary_integral(cax, cay, cbx, cby, inclusive=True)
    ib = _boundary_integral(cbx, cby, cax, cay, inclusive=False)
    return torch.clamp(0.5 * (ia + ib), min=0.0)


def _comps(boxes):
    return boxes[..., 0], boxes[..., 1], boxes[..., 3], boxes[..., 4], boxes[..., 6]


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., M, 7) x (..., N, 7) -> (..., M, N) BEV overlap areas."""
    a = tuple(c[..., :, None] for c in _comps(boxes_a))
    b = tuple(c[..., None, :] for c in _comps(boxes_b))
    return overlap_core(*a, *b)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., M, 7) x (..., N, 7) -> (..., M, N) rotated BEV IoU."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    sa = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    sb = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return inter / torch.clamp(sa + sb - inter, min=1e-8)
