"""The work of the MVF detector (``reference.mvf.MVFDetector``) on a batch,
from its grids and widths: FLOPs (multiply-adds count two) and the bytes
of the towers' maps.

Counted: each view's PFN layers and the two PointNets at every valid
point, each view's tower convs at every cell of their output maps (a
stride-s conv's output has 1 / s^2 of its input's cells), and the ASPP
neck and the head at the BEV (``counts.dense_neck_head_flops``).  The
decoration, the densifies, the readbacks and the coarse max are
elementwise and left out.  A training step counts its backward as twice
its forward, as ``counts.train_step_flops`` does.  The counts read the
same work whatever implements it.
"""

from __future__ import annotations

from benchmark import counts


def tower_convs(view, h: int, w: int) -> list:
    """(output cells of one frame, C_in, C_out, k) of each conv of a
    view's tower (``reference.mvf.View``) over an (h, w) grid."""
    out = []
    for stage, stride in zip(view.blocks, view.strides):
        h, w = -(-h // stride), -(-w // stride)
        for j, block in enumerate(stage):
            weights = [block.conv.weight] if j == 0 else [block.block1.conv.weight, block.conv2.weight]
            out += [(h * w, int(wt.shape[1]), int(wt.shape[0]), int(wt.shape[-1])) for wt in weights]
    return out


def tower_flops(det, batch: int) -> float:
    """Both towers' forward FLOPs on ``batch`` frames."""
    rd = det.reader
    return sum(2.0 * batch * cells * k * k * ci * co
               for view, grid in ((rd.pillar_view, rd.pillar_grid), (rd.cylinder_view, rd.cylinder_grid))
               for cells, ci, co, k in tower_convs(view, *grid))


def tower_bytes(det, batch: int, elem: int) -> float:
    """Both towers' forward bytes on ``batch`` frames: each conv reads its
    input map and weight once and writes its output map once, ``elem``
    bytes an element (a residual block's identity read and BatchNorm and
    ReLU fused into the convs around them)."""
    rd = det.reader
    total = 0.0
    for view, (h, w) in ((rd.pillar_view, rd.pillar_grid), (rd.cylinder_view, rd.cylinder_grid)):
        cells_in = h * w
        for cells, ci, co, k in tower_convs(view, h, w):
            total += elem * (batch * (cells_in * ci + cells * co) + k * k * ci * co)
            cells_in = cells
    return total


def point_flops(det, points: int) -> float:
    """The PFN layers of both views and the two PointNets at ``points``
    valid points."""
    rd = det.reader
    layers = [layer.linear.weight for view in (rd.pillar_view, rd.cylinder_view) for layer in view.pfn]
    layers += [rd.pointnet1.linear.weight, rd.pointnet2.linear.weight]
    return sum(2.0 * points * wt.shape[0] * wt.shape[1] for wt in layers)


def valid_points(det, points, mask) -> int:
    """Points in the mask and inside ``pc_range``."""
    pr = det.reader.pc_range
    ok = mask.bool()
    for a in range(3):
        ok = ok & (points[..., a] >= pr[a]) & (points[..., a] < pr[a + 3])
    return int(ok.sum())


def forward_flops(det, points, mask) -> float:
    b = int(points.shape[0])
    h, w = det.reader.pillar_grid
    ds = det.reader.pillar_view.ds
    return (point_flops(det, valid_points(det, points, mask)) + tower_flops(det, b)
            + counts.dense_neck_head_flops(det, b, h // ds, w // ds))


def train_step_flops(det, points, mask) -> float:
    return 3.0 * forward_flops(det, points, mask)
