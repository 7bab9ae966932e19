"""NumPy box geometry for the host-side data pipeline.

The port's own copy of pillarnext_tpu/core/box_ops.py.  Box convention
(LiDAR frame), matching the reference framework (det3d/core/bbox/box_np_ops.py):

    [x, y, z, size_x(l), size_y(w), size_z(h), (vx, vy,) yaw]

- 7-dim boxes carry no velocity; 9-dim boxes carry (vx, vy) at columns 6:8.
- yaw is counter-clockwise around +z; the last column is always yaw.
- z is the box *center* height.

These run in the data-loading workers (augmentation, GT paste).
``points_in_rbbox`` and ``box_collision_test`` always run the native C++
library (core/native_geometry.py), which raises if it cannot be built; the
vectorised NumPy versions beside them are the tests' oracles.
"""

from __future__ import annotations

import numpy as np

from pillarnext_tpu_torch.core import native_geometry

__all__ = [
    "flip",
    "scaling",
    "rotate",
    "translate",
    "yaw_rotation",
    "corners_nd",
    "rotation_2d",
    "rotation_3d",
    "center_to_corner_box2d",
    "center_to_corner_box3d",
    "corner_to_standup_nd",
    "points_in_rbbox",
    "box_collision_test",
]


def _wrap_yaw(yaw: np.ndarray) -> np.ndarray:
    """Wrap yaw angles into (-pi, pi]. Operates in place on a copy-safe array."""
    yaw = np.where(yaw > np.pi, yaw - 2 * np.pi, yaw)
    yaw = np.where(yaw < -np.pi, yaw + 2 * np.pi, yaw)
    return yaw


def flip(boxes: np.ndarray, axis: str) -> np.ndarray:
    """Mirror boxes across an axis (reference semantics: box_np_ops.py:5-26).

    axis='x' mirrors the scene across the x-axis (y -> -y): yaw -> -yaw,
    vy -> -vy.  axis='y' mirrors across the y-axis (x -> -x):
    yaw -> pi - yaw, vx -> -vx.  Mutates and returns ``boxes``.
    """
    if axis == "x":
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, -1] = -boxes[:, -1]
        if boxes.shape[1] > 7:
            boxes[:, 7] = -boxes[:, 7]
    elif axis == "y":
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, -1] = np.pi - boxes[:, -1]
        if boxes.shape[1] > 7:
            boxes[:, 6] = -boxes[:, 6]
    else:
        raise ValueError(f"unknown flip axis {axis!r}")
    boxes[:, -1] = _wrap_yaw(boxes[:, -1])
    return boxes


def scaling(boxes: np.ndarray, factor: float) -> np.ndarray:
    """Uniformly scale everything but the yaw column (box_np_ops.py:29-31)."""
    boxes[:, :-1] *= factor
    return boxes


def rotate(boxes: np.ndarray, angle: float) -> np.ndarray:
    """Global yaw rotation of centers, velocities, and headings
    (box_np_ops.py:34-41)."""
    boxes[:, :3] = yaw_rotation(boxes[:, :3], angle)
    if boxes.shape[1] > 7:
        vel3 = np.concatenate(
            [boxes[:, 6:8], np.zeros((boxes.shape[0], 1), dtype=boxes.dtype)], axis=1
        )
        boxes[:, 6:8] = yaw_rotation(vel3, angle)[:, :2]
    boxes[:, -1] += angle
    return boxes


def translate(boxes: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """Translate box centers (box_np_ops.py:44-46)."""
    boxes[:, :3] += offset
    return boxes


def yaw_rotation(points: np.ndarray, yaw: float) -> np.ndarray:
    """Rotate Nx3 points counter-clockwise around +z by ``yaw``
    (box_np_ops.py:125-137)."""
    c, s = np.cos(yaw), np.sin(yaw)
    rot_t = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], dtype=points.dtype)
    return points @ rot_t


def corners_nd(dims: np.ndarray, origin: float = 0.5) -> np.ndarray:
    """Axis-aligned corner offsets for N boxes of n-d ``dims``.

    2-D output order is clockwise from the minimum corner:
    (x0,y0), (x0,y1), (x1,y1), (x1,y0) — matching box_np_ops.py:49-84 so that
    downstream collision tests agree on winding.
    """
    ndim = dims.shape[1]
    if ndim == 2:
        corners_norm = np.array(
            [[0, 0], [0, 1], [1, 1], [1, 0]], dtype=dims.dtype
        )
    elif ndim == 3:
        corners_norm = np.array(
            [
                [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
                [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0],
            ],
            dtype=dims.dtype,
        )
    else:
        raise ValueError("only 2-d / 3-d boxes supported")
    corners_norm = corners_norm - np.asarray(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, -1, ndim)


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate (N, P, 2) point sets counter-clockwise by per-box ``angles``
    (box_np_ops.py:158-168)."""
    c, s = np.cos(angles), np.sin(angles)
    # x' = x*c - y*s ; y' = x*s + y*c   (counter-clockwise)
    x = points[..., 0] * c[:, None] - points[..., 1] * s[:, None]
    y = points[..., 0] * s[:, None] + points[..., 1] * c[:, None]
    return np.stack([x, y], axis=-1)


def rotation_3d(points: np.ndarray, yaw: np.ndarray) -> np.ndarray:
    """Rotate (N, P, 3) point sets around +z by per-box ``yaw``
    (box_np_ops.py:140-155)."""
    out = points.copy()
    out[..., :2] = rotation_2d(points[..., :2], yaw)
    return out


def center_to_corner_box2d(boxes: np.ndarray) -> np.ndarray:
    """BEV corners (N, 4, 2) from [cx, cy, dx, dy, yaw] boxes
    (box_np_ops.py:105-119)."""
    corners = corners_nd(boxes[:, 2:4])
    corners = rotation_2d(corners, boxes[:, -1])
    return corners + boxes[:, :2].reshape(-1, 1, 2)


def center_to_corner_box3d(boxes: np.ndarray) -> np.ndarray:
    """3-D corners (N, 8, 3) from [x, y, z, dx, dy, dz, ..., yaw] boxes
    (box_np_ops.py:87-102); z origin is the box center."""
    corners = corners_nd(boxes[:, 3:6])
    corners = rotation_3d(corners, boxes[:, -1])
    return corners + boxes[:, :3].reshape(-1, 1, 3)


def corner_to_standup_nd(corners: np.ndarray) -> np.ndarray:
    """Axis-aligned bounding boxes (N, 2*ndim) = [mins, maxs] of corner sets
    (box_np_ops.py:171-181)."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=1)


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Boolean (N, M) table: point i inside rotated box j
    (box_np_ops.py:184-212), by the native library.  ``boxes`` are
    [x, y, z, dx, dy, dz, (...,) yaw] with z the box center."""
    return native_geometry.points_in_rbbox(points, boxes)


def points_in_rbbox_np(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Pure-NumPy reference for :func:`points_in_rbbox` (vectorized)."""
    if boxes.shape[0] == 0 or points.shape[0] == 0:
        return np.zeros((points.shape[0], boxes.shape[0]), dtype=bool)
    shift = points[:, None, :3] - boxes[None, :, :3]  # (N, M, 3)
    c = np.cos(boxes[:, -1])[None, :]
    s = np.sin(boxes[:, -1])[None, :]
    local_x = shift[..., 0] * c + shift[..., 1] * s
    local_y = -shift[..., 0] * s + shift[..., 1] * c
    half = boxes[None, :, 3:6] / 2.0
    return (
        (np.abs(shift[..., 2]) <= half[..., 2])
        & (np.abs(local_x) <= half[..., 0])
        & (np.abs(local_y) <= half[..., 1])
    )


def box_collision_test(corners_a: np.ndarray, corners_b: np.ndarray) -> np.ndarray:
    """Pairwise BEV convex-quad collision matrix (N, K) from corner sets
    (N, 4, 2) x (K, 4, 2) — reference semantics box_np_ops.py:215-302.

    Collision = any edge pair properly intersects, OR one quad's corner lies
    strictly inside the other.  By the native library.
    """
    return native_geometry.box_collision_test(corners_a, corners_b)


def box_collision_test_np(corners_a: np.ndarray, corners_b: np.ndarray) -> np.ndarray:
    """Vectorized NumPy reference for :func:`box_collision_test`."""
    n, k = corners_a.shape[0], corners_b.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)

    # AABB prefilter.
    sa = corner_to_standup_nd(corners_a)  # (N, 4): xmin ymin xmax ymax
    sb = corner_to_standup_nd(corners_b)
    iw = np.minimum(sa[:, None, 2], sb[None, :, 2]) - np.maximum(
        sa[:, None, 0], sb[None, :, 0]
    )
    ih = np.minimum(sa[:, None, 3], sb[None, :, 3]) - np.maximum(
        sa[:, None, 1], sb[None, :, 1]
    )
    aabb = (iw > 0) & (ih > 0)

    # Edge-pair proper intersection: segments (A,B) of a vs (C,D) of b.
    nxt = [1, 2, 3, 0]
    a0 = corners_a[:, :, None, None, :]          # (N, 4, 1, 1, 2)  A
    a1 = corners_a[:, nxt][:, :, None, None, :]  # B
    b0 = corners_b[None, None, :, :, :]          # (1, 1, K, 4, 2)  C
    b1 = corners_b[:, nxt][None, None, :, :, :]

    def _gt_cross(p, q, r):
        """sign test: (q - p) x (r - p) > 0, broadcast."""
        return (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]) > (
            r[..., 1] - p[..., 1]
        ) * (q[..., 0] - p[..., 0])

    # Matches the reference's strict orientation test (box_np_ops.py:241-258).
    acd = _gt_cross(a0, b1, b0)
    bcd = _gt_cross(a1, b1, b0)
    abc = _gt_cross(a0, b0, a1)
    abd = _gt_cross(a0, b1, a1)
    seg_int = (acd != bcd) & (abc != abd)  # (N, 4, K, 4)
    any_edge = seg_int.any(axis=(1, 3))  # (N, K)

    # Containment: corner of b strictly inside quad a (all cross < 0 with the
    # clockwise winding produced by corners_nd), and vice versa.
    def _contains(quads, pts):
        """quads (Q, 4, 2) clockwise; pts (P, 4, 2) -> (Q, P) all-corners-inside."""
        edge_a = quads[:, :, :]  # (Q, 4, 2) corner k
        edge_b = quads[:, nxt, :]  # corner k+1
        vec = -(edge_a - edge_b)  # reference negates for clockwise winding
        # cross = vec.y * (corner.x - pt.x) - vec.x * (corner.y - pt.y) < 0
        dx = edge_a[:, None, None, :, 0] - pts[None, :, :, None, 0]
        dy = edge_a[:, None, None, :, 1] - pts[None, :, :, None, 1]
        cross = vec[:, None, None, :, 1] * dx - vec[:, None, None, :, 0] * dy
        inside = (cross < 0).all(axis=3)  # (Q, P, 4): pt l inside quad
        return inside.all(axis=2)  # all 4 pts of P inside -> (Q, P)

    a_contains_b = _contains(corners_a, corners_b)  # (N, K)
    b_contains_a = _contains(corners_b, corners_a).T  # (N, K)

    return aabb & (any_edge | a_contains_b | b_contains_a)
