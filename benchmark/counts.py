"""The yardstick's arithmetic: the work of the reference model on a batch,
the least bytes and operations of the program's kernels, and the card's
published peaks.

FLOPs count multiply-adds as two.  A SubM or strided sparse conv counts,
at each active output site, its active input taps x C_in x C_out; the
dense neck and head count every cell of their maps; a training step
counts its backward as twice its forward.  The active sets are the
reference's own (``reference.model``'s rulebooks), so the count is the
same whatever the program's backbone runs as (masked-dense, tiles or
sparse).  Kernel bytes count each input read once and each output row
written once, for what these inputs need: the valid indices' distinct
rows, the occupied pillars.
"""

from __future__ import annotations

import torch

from benchmark.reference import model as ref

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def valid_taps(book: list) -> int:
    """Active (output, input) pairs of a rulebook, over its taps."""
    return sum(len(o) for o, _ in book)


@torch.no_grad()
def forward_flops(det: ref.Detector, points: torch.Tensor, mask: torch.Tensor) -> float:
    """The reference forward's FLOPs on one batch."""
    prec = ref.Precision()
    total = 0.0
    rd = det.reader
    if isinstance(rd, ref.PillarReader):
        n = int(mask.sum())  # every point of these frames lies in the grid
        for layer in rd.pfn_layers:
            o, i = layer.linear.weight.shape
            total += 2.0 * n * i * o
        st = rd(points, mask, prec)
    else:
        st = rd(points, mask, prec)
    bb = det.backbone
    for stage in bb.blocks:
        first = stage[0]
        if first.stride is not None:
            coords, shape, rows = ref.strided_rulebook(st, first.kernel, first.stride, first.padding)
            o, i = first.conv.weight.shape[:2]
            total += 2.0 * valid_taps(rows) * i * o
            st = ref.Sparse(coords, st.feats.new_zeros((len(coords), 1)), shape)
        rows = ref.subm_rulebook(st, first.kernel)
        taps_n = valid_taps(rows)
        convs = [first.conv.weight] if first.stride is None else []
        for blk in stage[1:]:
            convs += [blk.block1.conv.weight, blk.conv2.weight]
        for w in convs:
            total += 2.0 * taps_n * w.shape[0] * w.shape[1]
    if bb.dims == 3:
        coords, shape, rows = ref.strided_rulebook(st, (3, 1, 1), (2, 1, 1), (0, 0, 0))
        c = bb.extra_conv[0].weight.shape[0]
        total += 2.0 * valid_taps(rows) * c * c
        st = ref.Sparse(coords, None, shape)
        w = bb.mapping.conv.weight
    else:
        w = bb.mapping[0].weight
    total += 2.0 * len(st.coords) * w.shape[0] * w.shape[1]
    b, d, h, wd = st.shape
    total += dense_neck_head_flops(det, b, h, wd)
    return total


def dense_neck_head_flops(det: ref.Detector, b: int, h: int, w: int) -> float:
    """ASPP at (h, w) and the head (shared conv at (h, w), each task's
    deblock and branches at the deblock's resolution), every cell."""
    neck = det.neck
    c = neck.weight.shape[0]
    cells = b * h * w
    neck_macs = 2 * 9 * c * c + c * c + 4 * 9 * c * c + 6 * c * c
    head = det.head
    hc = head.shared_conv["0"].weight.shape[0]
    macs = cells * (neck_macs + 9 * c * hc)
    for task in head.tasks:
        s = task.deblock.stride
        up = cells * s * s
        macs += up * hc * hc  # ConvTranspose k = s: one input tap an output cell
        for name in task.names:
            br = getattr(task, name)
            for i in range(br.n_conv):
                wt = getattr(br, str(3 * i)).weight
                macs += up * wt.shape[0] * wt.shape[1] * wt.shape[2] * wt.shape[3]
    return 2.0 * macs


def train_step_flops(det, points, mask) -> float:
    return 3.0 * forward_flops(det, points, mask)


def least_seconds(nbytes: float, flops: float = 0.0, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The roofline's least time: the larger of bytes over the card's
    bandwidth and operations over its peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def gather_cost(m: int, distinct_rows: int, row_bytes: int) -> tuple:
    """Kernel 2, ``out[i] = table[idx[i]]`` or a zero row: (bytes, flops).
    It reads m int32 indices and each valid index's distinct rows once,
    and writes m rows."""
    return 4.0 * m + float(distinct_rows) * row_bytes + float(m) * row_bytes, 0.0


def pfn_cost(points: int, pillars: int, df: int, c0: int, c1: int, elem: int) -> tuple:
    """Kernel 1, the two-layer PFN over the slot-sorted points: (bytes,
    flops).  It reads each valid point's features and slot once and
    writes each occupied pillar's row; the two Linear layers are df -> c0
    and 2 c0 -> c1 a point."""
    nbytes = float(points) * (df * elem + 4) + float(pillars) * c1 * elem
    return nbytes, 2.0 * points * (df * c0 + 2 * c0 * c1)
