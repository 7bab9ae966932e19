"""The yardstick's counts on tiny hand-counted shapes."""

from __future__ import annotations

import torch

from benchmark import counts
from benchmark.reference import model as ref


def sparse(sites, shape, c=1):
    coords = torch.tensor(sites, dtype=torch.long)
    keys = ref.grid_keys(coords, shape)
    order = torch.argsort(keys)
    return ref.Sparse(coords[order], torch.ones(len(sites), c), shape)


def test_subm_taps():
    """Two neighbouring sites of a 4 x 4 grid: each reads itself and the
    other through a 3 x 3 SubM kernel."""
    st = sparse([[0, 0, 1, 1], [0, 0, 1, 2]], (1, 1, 4, 4))
    book = ref.subm_rulebook(st, (1, 3, 3))
    assert len(book) == 9
    assert counts.valid_taps(book) == 4
    # the centre tap reads the site itself; the right tap reads the right neighbour
    assert [t.tolist() for t in book[4]] == [[0, 1], [0, 1]]
    assert [t.tolist() for t in book[5]] == [[0], [1]]


def test_strided_taps():
    """A 3 x 3, stride 2, padding 1 conv: (1, 1) reaches outputs (0..1,
    0..1) by one tap each, (1, 2) reaches (0..1, 1): 4 outputs, 6 taps."""
    st = sparse([[0, 0, 1, 1], [0, 0, 1, 2]], (1, 1, 4, 4))
    coords, shape, rows = ref.strided_rulebook(st, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    assert shape == (1, 1, 2, 2)
    assert coords[:, 2:].tolist() == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert counts.valid_taps(rows) == 6


def test_3d_extra_conv_taps():
    """(3, 1, 1) / (2, 1, 1) with no padding over depth 5: a site at z = 2
    reaches z_out = 0 (tap 2) and z_out = 1 (tap 0)."""
    st = sparse([[0, 2, 0, 0]], (1, 5, 1, 1))
    coords, shape, rows = ref.strided_rulebook(st, (3, 1, 1), (2, 1, 1), (0, 0, 0))
    assert shape == (1, 2, 1, 1)
    assert coords[:, 1].tolist() == [0, 1]
    assert counts.valid_taps(rows) == 2


def test_dense_neck_head_flops():
    """ASPP of C = 8 and one task of one class with one 2-conv branch, at
    a 2 x 3 map, stride 2: every cell counted."""
    det = ref.Detector.__new__(ref.Detector)
    torch.nn.Module.__init__(det)
    det.neck = ref.ASPP(8)
    det.head = ref.Head(8, [["car"]], {}, 2, head_conv=4)
    cells = 2 * 3
    neck = cells * (2 * 9 * 64 + 64 + 4 * 9 * 64 + 6 * 64)
    shared = cells * 9 * 8 * 4
    up = cells * 4
    task = up * 4 * 4 + up * 9 * 4 * (4 + 1)
    assert counts.dense_neck_head_flops(det, 1, 2, 3) == 2.0 * (neck + shared + task)


def test_kernel_costs():
    # kernel 2: 10 indices, 3 distinct rows of 256 bytes, 10 rows written
    assert counts.gather_cost(10, 3, 256) == (40.0 + 3 * 256 + 10 * 256, 0.0)
    # kernel 1: 100 points of 10 bf16 features and an int32 slot, 7 pillars of 64
    nbytes, flops = counts.pfn_cost(100, 7, 10, 32, 64, 2)
    assert nbytes == 100 * (20 + 4) + 7 * 64 * 2
    assert flops == 2.0 * 100 * (10 * 32 + 64 * 64)
    assert counts.least_seconds(3.35e12, 0.0) == 1.0
    assert counts.least_seconds(0.0, 989e12) == 1.0
