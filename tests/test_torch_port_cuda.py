"""The port's CUDA kernels vs their plain versions on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built from
``pillarnext_tpu_torch/csrc`` on first use) and skip elsewhere.  Run them on
the card with::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU, and the GPU
machine need not have JAX.)

They cover widths and dtypes the flagship smoke test (chip_smoke.py) does
not: every padded width of kernel 1 in f32 and bf16, pillars that cross
its 128-point windows at every offset, one pillar of 5000 points, all
points in the dump slot, one point, a capacity far above the occupied
slots, two launches bit for bit; row sizes of 2 to 512 bytes for kernel 2,
a table offset by one row, odd row counts, narrow and wide
channels, one huge segment and empty input for kernel 3 (and its
gradient), and segment layouts at its tile and thread-group boundaries
(``segment_layout``, which the CPU tests share) in widths 1, 3, 32 and 64,
NaN and -inf inside a segment, misaligned rows, three device launches a
call without a host synchronisation, and a sum run twice bit for bit;
empty inputs and the overflow slot, a narrowed flagship whose
detections on the card must match the CPU's, and one narrowed f32 train
step on the card against the same step on the CPU.  Then: both readers
bit-identical from call to call at full grids (the segment sums are
kernel 3's, not atomics), an f32 model that keeps TF32 off by itself
under PyTorch's default flags, a narrowed voxel18 f32 train step on the
card against the CPU, and kernel 2 at voxel18 training's densify shapes.
MVF: the narrowed MVF detector on the card against the CPU, its f32 BEV
bit-identical with the kernels and with their plain versions, and kernel 2
as its pillar densify at full size (4,194,304 rows of 48 bf16 channels).
Distributed: a synced BatchNorm over two gloo ranks on the card against
one process.  The tile-stack SubM's row movements (ops/tile_subm.py) with
kernel 2 against their plain versions, backwards included.  The rotated
and circle NMS kernel (csrc/nms.cu) against the host-driven chunk loop on
the same card over random scenes of 1 to 1000 candidates in 1 to 40 lanes,
against the native greedy NMS, on a suppression chain across the chunk
boundaries, on bad input, and under sync debug mode "error".  A trace
giving kernel 2's and the NMS kernel's device time to their launch op.  No
test here sets a TF32 flag.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain
from pillarnext_tpu_torch.ops.pfn import pfn_two_layer, pfn_two_layer_plain
from pillarnext_tpu_torch.ops import kernels
from pillarnext_tpu_torch.ops.segscan import (
    THREADS,
    TILE,
    device_launches,
    pillar_max_broadcast,
    sorted_segment_bcast,
    sorted_segment_bcast_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _pfn_inputs(device, n, cap, df, c0, c1, dtype, seed, slot=None):
    g = torch.Generator().manual_seed(seed)
    if slot is None:
        slot = torch.sort(torch.randint(0, cap + 1, (n,), generator=g)).values
    slot = torch.as_tensor(slot).to(torch.int32)
    n = slot.shape[0]
    feats = (torch.randn(n, df, generator=g) * 5).to(dtype)
    w0 = torch.randn(df, c0, generator=g) / df**0.5
    w1 = torch.randn(2 * c0, c1, generator=g) / (2 * c0) ** 0.5
    bn0 = torch.stack([torch.rand(c0, generator=g) + 0.5, 0.2 * torch.randn(c0, generator=g)])
    bn1 = torch.stack([torch.rand(c1, generator=g) + 0.5, 0.2 * torch.randn(c1, generator=g)])
    return [t.to(device) for t in (feats, slot, w0, bn0, w1, bn1)]


@pytest.mark.parametrize("c0,c1", [(8, 16), (32, 64), (48, 96), (64, 128), (17, 33)])
def test_pfn_two_layer_f32(device, c0, c1):
    args = _pfn_inputs(device, 5000, 1500, 10, c0, c1, torch.float32, seed=c0 + c1)
    before = pfn_two_layer.launches
    got = pfn_two_layer(*args, 1500)
    want = pfn_two_layer_plain(*args, 1500)
    torch.cuda.synchronize()
    assert pfn_two_layer.launches == before + 1
    assert got.shape == (1501, c1)
    assert torch.equal((got == 0).all(1), (want == 0).all(1))
    assert torch.all(got[-1] == 0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_pfn_two_layer_bf16_and_overflow(device):
    # slots drawn up to cap: the dump slot cap collects points and stays 0
    args = _pfn_inputs(device, 8000, 700, 13, 32, 64, torch.bfloat16, seed=3)
    got = pfn_two_layer(*args, 700)
    want = pfn_two_layer_plain(*args, 700)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.all(got[-1] == 0)
    a, b = got.float(), want.float()
    hi = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-9)
    ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(hi)) - 7)
    assert float(ulps.max()) <= 1.0


def _assert_pfn_matches(got, want):
    """Kernel 1's bars: the same zero rows; f32 within atol = rtol = 1e-5,
    bf16 within 1 ulp of the larger magnitude, floored at 2^-9."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal((got == 0).all(1), (want == 0).all(1))
    assert torch.all(got[-1] == 0)
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        a, b = got.float(), want.float()
        hi = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-9)
        assert float(((a - b).abs() / torch.exp2(torch.floor(torch.log2(hi)) - 7)).max()) <= 1.0


@pytest.mark.parametrize("c0,c1", [(8, 16), (32, 64), (48, 96), (64, 128), (17, 33)])
def test_pfn_two_layer_bf16_widths(device, c0, c1):
    args = _pfn_inputs(device, 5000, 1500, 10, c0, c1, torch.bfloat16, seed=c0 * c1)
    _assert_pfn_matches(pfn_two_layer(*args, 1500), pfn_two_layer_plain(*args, 1500))


def _slot_stream(case):
    """(ascending slots, cap) of one pillar layout."""
    rng = np.random.default_rng(11)
    if case == "sizes_1_to_300":
        # every pillar size 1..300, in order and shuffled twice, so pillars
        # start and end at every offset of the 128-point windows
        sizes = np.concatenate([np.arange(1, 301), rng.permutation(300) + 1, rng.permutation(300) + 1])
        return np.repeat(np.arange(len(sizes)), sizes), len(sizes) + 3
    if case == "one_pillar_5000":
        return np.concatenate([np.zeros(5000, np.int64), [1, 1, 2], np.full(200, 4)]), 10
    if case == "all_dump":
        return np.full(3000, 100), 100
    if case == "one_point":
        return np.array([2]), 4
    if case == "cap_far_above":
        return np.sort(rng.integers(0, 300, 2000)), 200_000
    if case == "gaps_and_dump":
        return np.sort(rng.integers(0, 1001, 1500)), 1000
    raise ValueError(case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "case", ["sizes_1_to_300", "one_pillar_5000", "all_dump", "one_point", "cap_far_above", "gaps_and_dump"]
)
def test_pfn_two_layer_pillar_layouts(device, dtype, case):
    slot, cap = _slot_stream(case)
    args = _pfn_inputs(device, 0, cap, 10, 32, 64, dtype, seed=5, slot=slot)
    before = pfn_two_layer.launches
    got = pfn_two_layer(*args, cap)
    want = pfn_two_layer_plain(*args, cap)
    torch.cuda.synchronize()
    assert pfn_two_layer.launches == before + 1
    _assert_pfn_matches(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pfn_two_layer_deterministic(device, dtype):
    slot, cap = _slot_stream("sizes_1_to_300")
    args = _pfn_inputs(device, 0, cap, 10, 32, 64, dtype, seed=6, slot=slot)
    first = pfn_two_layer(*args, cap)
    second = pfn_two_layer(*args, cap)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       second.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_pfn_two_layer_rejects_bad_input(device):
    feats, slot, w0, bn0, w1, bn1 = _pfn_inputs(device, 100, 50, 10, 8, 16, torch.float32, seed=4)
    with pytest.raises(ValueError):
        pfn_two_layer(feats.half(), slot, w0, bn0, w1, bn1, 50)
    with pytest.raises(ValueError):
        pfn_two_layer(feats.t(), slot, w0, bn0, w1, bn1, 50)
    with pytest.raises(ValueError):  # the kernel stages rows with 16-byte copies
        shifted = torch.empty(feats.numel() + 1, device=device)[1:].view_as(feats).copy_(feats)
        pfn_two_layer(shifted, slot, w0, bn0, w1, bn1, 50)
    with pytest.raises(RuntimeError):  # c0 > 64 is outside the kernel's widths
        big = _pfn_inputs(device, 100, 50, 10, 80, 16, torch.float32, seed=5)
        pfn_two_layer(*big, 50)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,r,c", [(100_000, 3000, 64), (5000, 70, 3), (4097, 1, 5), (0, 10, 8)])
def test_row_gather_bit_exact(device, dtype, m, r, c):
    rng = np.random.default_rng(m + r + c)
    table = torch.from_numpy(rng.standard_normal((r, c)).astype(np.float32)).to(device, dtype)
    idx = torch.from_numpy(rng.integers(-3, r + 3, m).astype(np.int32)).to(device)
    before = monotone_row_gather.launches
    got = monotone_row_gather(table, idx)
    want = monotone_row_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert monotone_row_gather.launches == before + (1 if m else 0)
    assert got.shape == (m, c) and got.dtype == dtype
    assert torch.equal(got, want)


# (dtype, channels): rows of 2, 6, 10, 12, 20, 48, 96, 128 and 512 bytes (48
# and 96: MVF's back-gathers and densify, 16-byte chunks at 3 and 6 a row)
_ROW_WIDTHS = [
    (torch.bfloat16, 1), (torch.bfloat16, 3), (torch.bfloat16, 5), (torch.bfloat16, 6),
    (torch.bfloat16, 10), (torch.bfloat16, 24), (torch.bfloat16, 48), (torch.bfloat16, 64),
    (torch.bfloat16, 256), (torch.float32, 3), (torch.float32, 5), (torch.float32, 12),
    (torch.float32, 24), (torch.float32, 32), (torch.float32, 128),
]


@pytest.mark.parametrize("m", [0, 1, 4099, 100_003])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "table[1:]"])
@pytest.mark.parametrize("dtype,c", _ROW_WIDTHS, ids=lambda v: str(v).replace("torch.", ""))
def test_row_gather_row_widths(device, dtype, c, offset, m):
    """Bit-exact at every row width, on a table offset by one row (so 16-byte
    alignment fails for narrow rows), at row counts that are not a multiple
    of a thread's group of rows, with indices out of range on both sides."""
    rng = np.random.default_rng(m + c + offset)
    r = 777
    base = torch.from_numpy(rng.standard_normal((r + offset, c)).astype(np.float32)).to(device, dtype)
    table = base[offset:]
    idx = torch.from_numpy(rng.integers(-5, r + 5, m).astype(np.int32)).to(device)
    before = monotone_row_gather.launches
    got = monotone_row_gather(table, idx)
    want = monotone_row_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert monotone_row_gather.launches == before + (1 if m else 0)
    assert got.shape == (m, c) and got.dtype == dtype
    assert torch.equal(got, want)


def test_row_gather_rejects_bad_input(device):
    table = torch.zeros(10, 8, device=device)
    with pytest.raises(ValueError):
        monotone_row_gather(table, torch.zeros(5, dtype=torch.int64, device=device))
    with pytest.raises(ValueError):
        monotone_row_gather(table.half(), torch.zeros(5, dtype=torch.int32, device=device))


def test_small_flagship_gpu_matches_cpu(device):
    """The narrowed flagship (tests/test_torch_port_e2e.py's config, f32)
    gives the same detections on the card, through both kernels, as on the
    CPU, at the bars of tests/test_detection_parity.py."""
    from pathlib import Path

    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    flagship = (
        Path(__file__).resolve().parent.parent
        / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
    )
    cfg = load_experiment(flagship, [
        f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
        "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
        "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32", "model.neck.in_channels=32",
        "model.head.in_channels=32", "+model.head.share_conv_channel=32", "model.dtype=float32",
    ])["model"]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pts, mask = lidar_like_points(2, 3000, pc, seed=0)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.inference_mode():
        want = model.predict(pts, mask)
        launches = (pfn_two_layer.launches, monotone_row_gather.launches)
        got = model.to(device).predict(pts.to(device), mask.to(device))
    assert pfn_two_layer.launches > launches[0]
    assert monotone_row_gather.launches > launches[1]
    _assert_same_detections({k: v.cpu() for k, v in got.items()}, want)


def _assert_same_detections(got, want):
    """The same detection set at the bars of tests/test_detection_parity.py."""
    assert int(want["valid"].sum()) >= 8
    for i in range(want["valid"].shape[0]):
        gv, wv = got["valid"][i], want["valid"][i]
        assert int(gv.sum()) == int(wv.sum())
        gs, ws = got["scores"][i][gv], want["scores"][i][wv]
        gl, wl = got["label_preds"][i][gv], want["label_preds"][i][wv]
        go = np.lexsort((-gs.numpy(), gl.numpy()))
        wo = np.lexsort((-ws.numpy(), wl.numpy()))
        np.testing.assert_array_equal(gl.numpy()[go], wl.numpy()[wo])
        np.testing.assert_allclose(gs.numpy()[go], ws.numpy()[wo], atol=2e-3, rtol=1e-3)
        # boxes pair by nearness within their label, one to one: two boxes
        # whose scores tie to ~1e-6 can sort in either order on the two
        # devices; each box keeps its own score
        gb, wb = got["box3d_lidar"][i][gv].numpy(), want["box3d_lidar"][i][wv].numpy()
        dist = np.abs(gb[:, None, :] - wb[None, :, :]).max(-1)
        dist[gl.numpy()[:, None] != wl.numpy()[None, :]] = np.inf
        pair = dist.argmin(1)
        assert len(set(pair.tolist())) == len(pair)
        np.testing.assert_allclose(gb, wb[pair], atol=2e-2, rtol=1e-3)
        np.testing.assert_allclose(gs.numpy(), ws.numpy()[pair], atol=2e-3, rtol=1e-3)


def test_voxel_and_pillar_coords_on_the_card_match_the_quotient(device):
    """Points whose quotient by the voxel size sits within one bit of a
    cell boundary (x * (1 / 0.075) rounds to the next cell where x / 0.075
    does not): the card gives the cell of the true f32 quotient, as the
    CPU and the JAX package do."""
    from pillarnext_tpu_torch.ops import voxelize

    grid = voxelize.VoxelGrid.create((0.075, 0.075, 0.2), (0.0, 0.0, 0.0, 100.8, 100.8, 8.0))
    x = np.array([59.55, 50.175, 86.85, 74.25, 72.75], np.float32)
    z = np.array([6.7999997, 5.2, 5.2, 6.7999997, 1.0], np.float32)
    xyz = torch.from_numpy(np.stack([x, x[::-1].copy(), z], 1))
    valid = torch.ones(5, dtype=torch.bool)
    want = [np.floor(xyz[:, i].numpy() / np.float32(v)).astype(np.int32)
            for i, v in enumerate(grid.voxel_size)]
    for coords in (voxelize.voxel_coords, voxelize.pillar_coords):
        got = coords(grid, xyz.to(device), valid.to(device))
        for g, w in zip(got[:-1], want):
            np.testing.assert_array_equal(g.cpu().numpy(), w)


def test_small_voxel18_gpu_matches_cpu(device):
    """The narrowed voxel18 (tests/test_torch_port_voxel_e2e.py's config,
    f32) gives the same detections on the card, with kernel 2 as its
    densify, as on the CPU; its BEV on the card is bit-identical with
    kernel 2 and with the plain gather."""
    from pathlib import Path

    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    voxel18 = (
        Path(__file__).resolve().parent.parent
        / "pillarnext_tpu/configs/experiments/nusc_det_voxel18_aspp_iou_sp.yaml"
    )
    cfg = load_experiment(voxel18, [
        f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,0.2]",
        "model.reader.voxel_capacity=4096", "model.backbone.ds_num_filters=[8,12,16,16]",
        "model.backbone.out_channels=16", "model.neck.in_channels=32",
        "model.head.in_channels=32", "+model.head.share_conv_channel=32", "model.dtype=float32",
    ])["model"]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pts, mask = lidar_like_points(2, 3000, pc, seed=0)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.inference_mode():
        want = model.predict(pts, mask)
        launches = monotone_row_gather.launches
        model = model.to(device)
        got = model.predict(pts.to(device), mask.to(device))
        assert monotone_row_gather.launches == launches + 1
        sb = model.reader(pts.to(device), mask.to(device))
        assert torch.equal(model.backbone(sb), model.backbone(sb, plain=True))
    _assert_same_detections({k: v.cpu() for k, v in got.items()}, want)


def _sorted_segments(n, huge, seed):
    """Sorted int32 segment ids: runs of ~5 rows, the last ``huge`` rows
    one segment (the dump slot of masked points)."""
    g = torch.Generator().manual_seed(seed)
    real = n - huge
    seg = torch.sort(torch.randint(0, max(real // 5, 1), (real,), generator=g)).values
    return torch.cat([seg, torch.full((huge,), max(real // 5, 1) + 3)]).to(torch.int32)


def _assert_bcast_matches(got, want, x, seg, reduce):
    """Non-finite values where the plain version has them; max bit-exact;
    sum within 1e-5 of the segment's sum of |x| in f32, within one bf16
    ulp in bf16."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan, inf = torch.isnan(want), torch.isinf(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[inf], want[inf])
    got, want = got.masked_fill(nan | inf, 0), want.masked_fill(nan | inf, 0)
    if reduce == "max":
        assert torch.equal(got, want)
        return
    err = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        # f32 sums in another order: within 1e-5 of the segment's sum of |x|
        mag = sorted_segment_bcast_plain(x.abs().nan_to_num(), seg, "sum")
        assert bool((err <= 1e-5 * mag).all())
    else:
        a, b = got.float(), want.float()
        hi = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-9)
        assert float(((a - b).abs() / torch.exp2(torch.floor(torch.log2(hi)) - 7)).max()) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduce", ["max", "sum"])
@pytest.mark.parametrize("n,c,huge", [(1, 3, 0), (257, 32, 0), (4097, 64, 3000), (100_003, 32, 60_000),
                                      (70_001, 3, 20)])
def test_sorted_segment_bcast_matches_plain(device, dtype, reduce, n, c, huge):
    seg = _sorted_segments(n, huge, seed=n + c).to(device)
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(n, c, generator=g) * 3).to(device, dtype)
    before = sorted_segment_bcast.launches
    got = sorted_segment_bcast(x, seg, reduce)
    want = sorted_segment_bcast_plain(x, seg, reduce)
    torch.cuda.synchronize()
    assert sorted_segment_bcast.launches == before + 1
    _assert_bcast_matches(got, want, x, seg, reduce)


SEGMENT_LAYOUTS = ("tile_ends", "group_ends", "run_over_3_tiles", "all_singletons", "one_run_tile",
                   "below_one_tile", "one_tile_plus_one", "dump_tail")


def group_rows(c: int, itemsize: int) -> int:
    """Rows that one thread group of csrc/segscan.cu owns in a full tile,
    for rows of ``c`` values at a 16-byte-aligned address."""
    row = c * itemsize
    vb = next(v for v in (16, 8, 4, 2) if v >= itemsize and row % v == 0)
    return -(-TILE // (THREADS // min(row // vb, THREADS)))


def segment_layout(kind: str, group: int = 32, seed: int = 0) -> np.ndarray:
    """A sorted int32 segment stream whose runs meet kernel 3's boundaries,
    built from its tile rows (``TILE``) and a thread group's rows
    (``group``)."""
    rng = np.random.default_rng(seed)
    t = TILE

    def runs(n):
        return np.cumsum(rng.random(n) < 0.3)

    if kind == "tile_ends":  # runs end on every tile boundary
        n = 3 * t + 5
        seg = np.cumsum((rng.random(n) < 0.2) | (np.arange(n) % t == 0))
    elif kind == "group_ends":  # runs of exactly one group's rows
        n = 2 * t + 3
        seg = np.arange(n) // group
    elif kind == "run_over_3_tiles":  # one run from mid tile 0 into tile 2
        n = 4 * t
        seg = runs(n)
        seg[t // 2:t // 2 + 2 * t + 7] = seg[t // 2]
    elif kind == "all_singletons":
        n = 2 * t + 1
        seg = np.arange(n) * 2
    elif kind == "one_run_tile":  # tile 1 is one run from its first row to its last
        n = 3 * t
        seg = runs(n) * 3
        seg[t:2 * t] = seg[t - 1] + 1
        seg[2 * t:] += 2
    elif kind == "below_one_tile":
        n = t - 5
        seg = runs(n)
    elif kind == "one_tile_plus_one":  # the second tile is one row of its own run
        n = t + 1
        seg = runs(n)
        seg[-1] = seg[-2] + 1
    elif kind == "dump_tail":  # the last two thirds one run, as the dump slot
        n = 2 * t + 100
        seg = runs(n)
        seg[n // 3:] = seg[n // 3 - 1] + 1
    else:
        raise ValueError(kind)
    return seg.astype(np.int32)


@pytest.mark.parametrize("kind", SEGMENT_LAYOUTS)
@pytest.mark.parametrize("c", [1, 3, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sorted_segment_bcast_layouts(device, kind, c, dtype):
    seg = torch.from_numpy(segment_layout(kind, group_rows(c, dtype.itemsize))).to(device)
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(seg.shape[0], c, generator=g) * 3).to(device, dtype)
    for reduce in ("max", "sum"):
        got = sorted_segment_bcast(x, seg, reduce)
        want = sorted_segment_bcast_plain(x, seg, reduce)
        torch.cuda.synchronize()
        _assert_bcast_matches(got, want, x, seg, reduce)


@pytest.mark.parametrize("kind", ["run_over_3_tiles", "tile_ends", "group_ends"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sorted_segment_bcast_nan_and_inf(device, kind, dtype):
    """A NaN inside one segment, -inf inside another and a segment of -inf
    only: max propagates the NaN and keeps -inf, as the plain version."""
    seg_np = segment_layout(kind, group_rows(32, dtype.itemsize), seed=1)
    seg = torch.from_numpy(seg_np).to(device)
    x = torch.randn(seg.shape[0], 32, generator=torch.Generator().manual_seed(5))
    x[TILE + 3, 4] = float("nan")
    x[TILE // 2 + 1, 7] = float("-inf")
    x[np.flatnonzero(seg_np == seg_np[-1]), 9] = float("-inf")
    x = x.to(device, dtype)
    for reduce in ("max", "sum"):
        got = sorted_segment_bcast(x, seg, reduce)
        want = sorted_segment_bcast_plain(x, seg, reduce)
        torch.cuda.synchronize()
        assert bool(torch.isnan(got).any()) and bool(torch.isinf(got).any())
        _assert_bcast_matches(got, want, x, seg, reduce)


@pytest.mark.parametrize("c", [3, 5, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sorted_segment_bcast_misaligned_rows(device, c, dtype):
    """``x[1:]`` of an odd-width tensor: rows off the 16-byte grid take the
    kernel's narrower vectors."""
    seg = torch.from_numpy(segment_layout("run_over_3_tiles", seed=2)).to(device)
    n = seg.shape[0]
    base = (torch.randn(n + 1, c, generator=torch.Generator().manual_seed(c)) * 3).to(device, dtype)
    x = base[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    for reduce in ("max", "sum"):
        got = sorted_segment_bcast(x, seg, reduce)
        want = sorted_segment_bcast_plain(x, seg, reduce)
        torch.cuda.synchronize()
        _assert_bcast_matches(got, want, x, seg, reduce)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sorted_segment_bcast_sum_is_deterministic(device, dtype):
    """No atomics: the same sum run twice gives the same bits, and every
    row of a segment gets the same bits."""
    seg = _sorted_segments(300_000, 100_000, seed=3).to(device)
    x = torch.randn(300_000, 32, generator=torch.Generator().manual_seed(4)).to(device, dtype)
    a = sorted_segment_bcast(x, seg, "sum")
    b = sorted_segment_bcast(x, seg, "sum")
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = seg[1:] != seg[:-1]
    rank = torch.cumsum(first, 0) - 1
    assert torch.equal(a, a[first.nonzero()[:, 0]][rank])


def test_sorted_segment_bcast_launches_and_no_host_sync(device, monkeypatch):
    """At the train shape (1.2M x 32) one call is three device launches
    (tile kernel, the entries' tile kernel, fill) and no host synchronisation."""
    n = 1_200_000
    seg = _sorted_segments(n, 400_000, seed=6).to(device)
    x = torch.randn(n, 32, generator=torch.Generator().manual_seed(6)).to(device, torch.bfloat16)
    sorted_segment_bcast(x, seg, "max")  # builds the library outside the sync check
    torch.cuda.synchronize()
    names = []
    launch = kernels.launch
    monkeypatch.setattr(kernels, "launch", lambda name, *args: (names.append(name), launch(name, *args)))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sorted_segment_bcast(x, seg, "max")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert names == ["pnx_segscan_tiles", "pnx_segscan_tiles", "pnx_segscan_fill"]
    assert device_launches(n) == 3
    assert torch.equal(out, sorted_segment_bcast_plain(x, seg, "max"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sorted_segment_bcast_recursive_entries(device, dtype, monkeypatch):
    """One row past TILE^2 / 2 the entries span two tiles and are resolved
    recursively (five launches: three tile passes, two fills).  One run
    goes from tile 1000 to the end, across the entries' tile boundary, and
    another spans 290 tiles."""
    n = TILE * TILE // 2 + 1
    rng = np.random.default_rng(7)
    seg_np = np.cumsum(rng.random(n) < 0.3)
    seg_np[10 * TILE + 5:300 * TILE + 9] = seg_np[10 * TILE + 5]
    seg_np[1000 * TILE + 17:] = seg_np[1000 * TILE + 16] + 1
    seg = torch.from_numpy(seg_np.astype(np.int32)).to(device)
    x = (torch.randn(n, 1, generator=torch.Generator().manual_seed(7)) * 3).to(device, dtype)
    names = []
    launch = kernels.launch
    monkeypatch.setattr(kernels, "launch", lambda name, *args: (names.append(name), launch(name, *args)))
    for reduce in ("max", "sum"):
        names.clear()
        got = sorted_segment_bcast(x, seg, reduce)
        want = sorted_segment_bcast_plain(x, seg, reduce)
        torch.cuda.synchronize()
        assert names == ["pnx_segscan_tiles"] * 3 + ["pnx_segscan_fill"] * 2
        _assert_bcast_matches(got, want, x, seg, reduce)
    assert device_launches(n) == 5 and device_launches(n - 1) == 3


def test_sorted_segment_bcast_empty_and_bad_input(device):
    empty = torch.zeros((0, 8), device=device)
    before = sorted_segment_bcast.launches
    out = sorted_segment_bcast(empty, torch.zeros((0,), dtype=torch.int32, device=device), "max")
    assert out.shape == (0, 8) and sorted_segment_bcast.launches == before
    x = torch.zeros(10, 4, device=device)
    with pytest.raises(ValueError):
        sorted_segment_bcast(x, torch.zeros(10, dtype=torch.int64, device=device), "max")
    with pytest.raises(ValueError):
        sorted_segment_bcast(x.half(), torch.zeros(10, dtype=torch.int32, device=device), "max")
    with pytest.raises(ValueError):
        sorted_segment_bcast(x, torch.zeros(10, dtype=torch.int32, device=device), "min")


def test_pillar_max_broadcast_gradient_matches_plain(device):
    seg = _sorted_segments(50_000, 20_000, seed=7).to(device)
    g = torch.Generator().manual_seed(8)
    x = torch.relu(torch.randn(50_000, 32, generator=g)).to(device).requires_grad_()
    cot = torch.randn(50_000, 32, generator=g).to(device)
    out = pillar_max_broadcast(x, seg)
    out.backward(cot)
    got = x.grad.clone()
    x.grad = None
    want_out = pillar_max_broadcast(x, seg, plain=True)
    want_out.backward(cot)
    assert torch.equal(out, want_out)
    torch.testing.assert_close(got, x.grad, atol=1e-5 * float(x.grad.abs().max()), rtol=1e-5)


def test_small_flagship_train_step_gpu_matches_cpu(device):
    """One f32 train step of the narrowed flagship on the card (kernels 2
    and 3) and on the CPU (plain versions): same loss to 1e-5, same
    telemetry, and the step went through both kernels."""
    from pathlib import Path

    from pillarnext_tpu_torch.data.synthetic import synthetic_batches
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
    from pillarnext_tpu_torch.utils.config import load_experiment

    pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    flagship = (
        Path(__file__).resolve().parent.parent
        / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
    )
    cfg = load_experiment(flagship, [
        f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
        "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
        "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32", "model.neck.in_channels=32",
        "model.head.in_channels=32", "+model.head.share_conv_channel=32", "model.dtype=float32",
    ])
    batch = synthetic_batches(cfg, 1, 2, 3000, seed=1, n_objects=4, max_points=4000)[0]
    results = {}
    for dev in ("cpu", device):
        model = build_model(cfg["model"], device=dev, generator=torch.Generator().manual_seed(0), train=True)
        opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
        launches = (monotone_row_gather.launches, sorted_segment_bcast.launches)
        scalars, _ = train_step(model, opt, batch_to_device(batch, dev))
        results[str(dev)] = (
            float(scalars["loss"]),
            {k: int(v) for k, v in scalars["telemetry"].items()},
            (monotone_row_gather.launches - launches[0], sorted_segment_bcast.launches - launches[1]),
        )
    cpu, gpu = results["cpu"], results[str(device)]
    assert gpu[0] == pytest.approx(cpu[0], rel=1e-5)
    assert gpu[1] == cpu[1]
    assert cpu[2] == (0, 0) and gpu[2][0] > 0 and gpu[2][1] > 0


# ------------------------------------------ determinism, f32 math, voxel18 training

REPO_CONFIGS = __import__("pathlib").Path(__file__).resolve().parent.parent / "pillarnext_tpu/configs/experiments"
SMALL_VOXEL18 = [
    "model.reader.pc_range=[-8.0,-8.0,-5.0,8.0,8.0,3.0]", "model.reader.voxel_size=[0.25,0.25,0.2]",
    "model.reader.voxel_capacity=4096", "model.backbone.ds_num_filters=[8,12,16,16]",
    "model.backbone.out_channels=16", "model.neck.in_channels=32",
    "model.head.in_channels=32", "+model.head.share_conv_channel=32", "model.dtype=float32",
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_readers_are_bit_identical_from_call_to_call(device, dtype):
    """Both readers at their configs' full grids on one 200k-point frame,
    called twice: the voxel reader's mean table and the pillar reader's
    decorated features (its cluster mean) are the same bits, because the
    segment sums run through kernel 3's sorted sum instead of atomics."""
    from pillarnext_tpu_torch.models.pillar_encoder import PillarFeatureNet
    from pillarnext_tpu_torch.models.voxel_encoder import VoxelFeatureNet
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    vr = load_experiment(REPO_CONFIGS / "nusc_det_voxel18_aspp_iou_sp.yaml")["model"]["reader"]
    pr = load_experiment(REPO_CONFIGS / "nusc_det_pp18_aspp_iou_sp.yaml")["model"]["reader"]
    pts, mask = lidar_like_points(1, 200_000, vr["pc_range"], seed=0)
    pts, mask = torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)
    voxel = VoxelFeatureNet(vr["voxel_size"], vr["pc_range"], voxel_capacity=vr["voxel_capacity"],
                            output="sparse", dtype=dtype)
    pillar = PillarFeatureNet(5, pr["num_filters"], pr["voxel_size"], pr["pc_range"],
                              pillar_capacity=pr["pillar_capacity"], output="sparse", dtype=dtype).to(device)
    launches = sorted_segment_bcast.launches
    with torch.inference_mode():
        tables = [voxel(pts, mask).table for _ in range(2)]
        feats = [pillar.decorate(pts, mask)[0] for _ in range(2)]
    assert sorted_segment_bcast.launches == launches + 4
    assert tables[0].dtype == feats[0].dtype == dtype
    assert int((tables[0] != 0).any(1).sum()) > 100_000  # ~140k occupied voxels
    assert torch.equal(tables[0], tables[1])
    assert torch.equal(feats[0], feats[1])


def test_f32_flagship_without_tf32_flags_matches_cpu(device):
    """An f32 model turns TF32 off for its own calls: with PyTorch's flags
    as they come (cuDNN TF32 on), the narrowed flagship's predict on the
    card matches the CPU at the flagship e2e bars (box 1e-2, score 1e-3),
    its convolutions ran with TF32 off, and the flags are as before after."""
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    cfg = load_experiment(REPO_CONFIGS / "nusc_det_pp18_aspp_iou_sp.yaml", [
        f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
        "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
        "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32", "model.neck.in_channels=32",
        "model.head.in_channels=32", "+model.head.share_conv_channel=32", "model.dtype=float32",
    ])["model"]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    assert flags == (True, False), "not PyTorch's default TF32 flags"
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pts, mask = lidar_like_points(2, 3000, pc, seed=0)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    seen = []
    with torch.inference_mode():
        want = model.predict(pts, mask)
        model = model.to(device)
        hook = model.neck.register_forward_hook(
            lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
        got = model.predict(pts.to(device), mask.to(device))
        hook.remove()
    assert seen == [False]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    got = {k: v.cpu() for k, v in got.items()}
    assert int(want["valid"].sum()) >= 8
    for i in range(want["valid"].shape[0]):
        gv, wv = got["valid"][i], want["valid"][i]
        assert int(gv.sum()) == int(wv.sum())
        gb, wb = got["box3d_lidar"][i][gv].numpy(), want["box3d_lidar"][i][wv].numpy()
        gl, wl = got["label_preds"][i][gv].numpy(), want["label_preds"][i][wv].numpy()
        dist = np.abs(gb[:, None, :] - wb[None, :, :]).max(-1)
        dist[gl[:, None] != wl[None, :]] = np.inf
        pair = dist.argmin(1)
        assert len(set(pair.tolist())) == len(pair)
        np.testing.assert_allclose(gb, wb[pair], atol=1e-2)
        np.testing.assert_allclose(got["scores"][i][gv].numpy(), want["scores"][i][wv].numpy()[pair],
                                   atol=1e-3)


def test_small_voxel18_train_step_gpu_matches_cpu(device):
    """One f32 train step of the narrowed voxel18 on the card (kernel 2's
    densify and its backward, kernel 3's voxel mean) and on the CPU (plain
    versions), same weights and batch: loss within 1e-4 relative, every
    gradient within 1e-3 of its largest CPU magnitude, same telemetry."""
    from pillarnext_tpu_torch.data.synthetic import synthetic_batches
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
    from pillarnext_tpu_torch.utils.config import load_experiment

    cfg = load_experiment(REPO_CONFIGS / "nusc_det_voxel18_aspp_iou_sp.yaml", SMALL_VOXEL18)
    batch = synthetic_batches(cfg, 1, 2, 3000, seed=1, n_objects=4, max_points=4000)[0]
    results = {}
    for dev in ("cpu", device):
        model = build_model(cfg["model"], device=dev, generator=torch.Generator().manual_seed(0), train=True)
        opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
        launches = (monotone_row_gather.launches, sorted_segment_bcast.launches)
        scalars, _ = train_step(model, opt, batch_to_device(batch, dev))
        results[str(dev)] = (
            float(scalars["loss"]),
            {k: int(v) for k, v in scalars["telemetry"].items()},
            (monotone_row_gather.launches - launches[0], sorted_segment_bcast.launches - launches[1]),
            {n: p.grad.cpu() for n, p in model.named_parameters()},
        )
    cpu, gpu = results["cpu"], results[str(device)]
    assert gpu[0] == pytest.approx(cpu[0], rel=1e-4)
    assert gpu[1] == cpu[1] and gpu[1]["stage1_overflow"] == 0
    assert cpu[2] == (0, 0) and gpu[2] == (2, 1)  # densify + its backward; the voxel mean
    for name, g in cpu[3].items():
        assert float((gpu[3][name] - g).abs().max()) <= 1e-3 * float(g.abs().max()) + 1e-6, name


def test_densify_at_voxel18_training_shapes_is_bit_identical(device):
    """Kernel 2 as voxel18 training's densify, at B = 4: 4 x 2 x 168 x 168
    = 225,792 dense rows of 128 bf16 channels from a 191,692-row extra-conv
    table, forward and backward, against the plain version bit for bit."""
    from pillarnext_tpu_torch.ops.compact import invert_slot_map
    from pillarnext_tpu_torch.ops.densify import densify

    dense_rows, cap, c = 4 * 2 * 168 * 168, 191_692, 128
    g = torch.Generator().manual_seed(11)
    occupied = torch.sort(torch.randperm(dense_rows, generator=g)[:150_000]).values
    slot_id = torch.cat([occupied, torch.full((cap - 150_000,), dense_rows)]).to(torch.int32).to(device)
    slot_of_dense, valid = invert_slot_map(slot_id, dense_rows)
    table = torch.randn(cap + 1, c, generator=g).to(device, torch.bfloat16)
    table[-1] = 0
    table[:cap][~valid] = 0
    cot = torch.randn(dense_rows, c, generator=g).to(device, torch.bfloat16)
    out = {}
    for plain in (False, True):
        t = table.clone().requires_grad_()
        launches = monotone_row_gather.launches
        dense = densify(t, slot_of_dense, slot_id, plain=plain)
        dense.backward(cot)
        out[plain] = (dense.detach(), t.grad, monotone_row_gather.launches - launches)
    assert out[False][2] == 2 and out[True][2] == 0
    assert out[False][0].shape == (dense_rows, c)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    assert int((out[False][1][:cap][valid] != 0).any(1).sum()) == 150_000


SMALL_MVF = [
    "model.reader.pc_range=[-8.0,-8.0,-10.0,8.0,8.0,10.0]", "model.reader.voxel_size=[0.25,0.25,20.0]",
    "model.reader.cylinder_size=[5.625,0.375,10.0]",
    "model.reader.cylinder_range=[-180.0,-3.0,0.0,180.0,3.0,10.0]",
    "model.reader.num_filters=[8,8]", "model.reader.ds_num_filters=[8,12,16,16]",
    "model.reader.out_channels=16", "model.reader.pillar_capacity=4096",
    "model.reader.cylinder_capacity=1024", "model.neck.in_channels=16",
    "model.head.in_channels=16", "+model.head.share_conv_channel=16", "model.dtype=float32",
]


def test_small_mvf_gpu_matches_cpu(device):
    """The narrowed MVF detector (tests/test_torch_port_mvf.py's config,
    f32, TF32 off by ``model.precision()`` as its predict runs) on the
    card, through kernels 2 and 3, against the CPU: the BEV
    within atol 1e-4 + rtol 1e-5, and bit-identical between the kernels
    and their plain versions on the card."""
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    cfg = load_experiment(REPO_CONFIGS / "waymo_det_mvf18_aspp_iou_car.yaml", SMALL_MVF)["model"]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pts, mask = lidar_like_points(2, 3000, [-8.0, -8.0, -10.0, 8.0, 8.0, 10.0], seed=0)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.inference_mode(), model.precision():
        want = model.reader(pts, mask)
        model = model.to(device)
        launches = (monotone_row_gather.launches, sorted_segment_bcast.launches)
        got = model.reader(pts.to(device), mask.to(device))
        # per view: the cluster-mean gather, the PFN back-gather, the densify;
        # per view one decoration mean
        assert (monotone_row_gather.launches - launches[0], sorted_segment_bcast.launches - launches[1]) == (6, 2)
        plain = model.reader(pts.to(device), mask.to(device), plain=True)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-5)


def test_densify_at_mvf_pillar_shape_is_bit_identical(device):
    """Kernel 2 as MVF's pillar densify at the Waymo grid: 2048^2 =
    4,194,304 dense rows of 48 bf16 channels (96-byte rows, 403 MB) from an
    86,017-row table with ~65k occupied slots, against the plain version."""
    from pillarnext_tpu_torch.ops.compact import invert_slot_map
    from pillarnext_tpu_torch.ops.densify import densify

    dense_rows, cap, c = 2048 * 2048, 86_016, 48
    g = torch.Generator().manual_seed(12)
    occupied = torch.sort(torch.randperm(dense_rows, generator=g)[:65_300]).values
    slot_id = torch.cat([occupied, torch.full((cap - 65_300,), dense_rows)]).to(torch.int32).to(device)
    slot_of_dense, valid = invert_slot_map(slot_id, dense_rows)
    table = torch.randn(cap + 1, c, generator=g).to(device, torch.bfloat16)
    table[-1] = 0
    launches = monotone_row_gather.launches
    with torch.inference_mode():
        got = densify(table, slot_of_dense, slot_id)
        want = densify(table, slot_of_dense, slot_id, plain=True)
    assert monotone_row_gather.launches == launches + 1
    assert got.shape == (dense_rows, c)
    assert torch.equal(got, want)
    assert int((got != 0).any(1).sum()) == 65_300


# ------------------------------------------ MVF training: the new backwards


def test_coarse_max_backward_on_the_card_matches_the_cpu(device):
    """MVF's coarse max (``segment_max`` over ids that do not ascend:
    integer tie counts) at 300,000 rows of 32 bf16 channels with many
    ties: the card's forward and backward equal the CPU's bit for bit.
    Over the same rows sorted by id, the gradient is the same bits,
    permuted, and no kernel launches: the count is an int32
    ``scatter_add_`` in any order."""
    from pillarnext_tpu_torch.ops.scatter import segment_max

    g = torch.Generator().manual_seed(21)
    n, c, segs = 300_000, 32, 20_000
    data = torch.randint(0, 6, (n, c), generator=g).to(torch.bfloat16)
    ids = torch.randint(0, segs, (n,), generator=g).to(torch.int32)
    cot = torch.randn(segs, c, generator=g).to(torch.bfloat16)

    def run(x, seg):
        x = x.clone().requires_grad_()
        out = segment_max(x, seg, segs)
        out.backward(cot.to(x.device))
        return out.detach().cpu(), x.grad.cpu()

    want = run(data, ids)
    got = run(data.to(device), ids.to(device))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[1] != 0).sum()) > segs * c  # ties split
    order = torch.sort(ids, stable=True).indices
    launches = sorted_segment_bcast.launches
    by_sorted = run(data[order].to(device), ids[order].to(device))
    assert sorted_segment_bcast.launches == launches
    assert torch.equal(by_sorted[0], want[0]) and torch.equal(by_sorted[1], want[1][order])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_readback_backward_is_the_same_bits_twice(device, dtype):
    """MVF's bilinear readback (``_bilinear``) of 300,000 points from a
    (2, 64, 64, 48) map, edge clamps included: its backward on the card
    (kernel 3's sorted sum) gives the same bits twice, one kernel 3 launch
    each, and agrees with the CPU's (f32: 1e-5 of the largest magnitude;
    bf16: 1e-2, one rounding of sums in another order)."""
    from pillarnext_tpu_torch.models.mvf_encoder import _bilinear

    g = torch.Generator().manual_seed(22)
    n = 300_000
    image = torch.randn(2, 64, 64, 48, generator=g).to(dtype)
    u = torch.rand(n, generator=g) * 66 - 1
    v = torch.rand(n, generator=g) * 66 - 1
    batch = torch.randint(0, 2, (n,), generator=g).to(torch.int32)
    cot = torch.randn(n, 48, generator=g)

    def run(dev):
        x = image.to(dev).detach().requires_grad_()
        _bilinear(x, batch.to(dev), u.to(dev), v.to(dev)).backward(cot.to(dev))
        return x.grad.cpu()

    want = run("cpu")
    launches = sorted_segment_bcast.launches
    first, second = run(device), run(device)
    assert sorted_segment_bcast.launches == launches + 2
    assert torch.equal(first, second)
    bar = (1e-5 if dtype == torch.float32 else 1e-2) * float(want.float().abs().max())
    assert float((first.float() - want.float()).abs().max()) <= bar


def test_recomputed_block_updates_bn_statistics_once(device):
    """A ResidualBlock of MVF's pillar tower (48 channels, f32, TF32 off) in
    training through ``layers.recomputed``: it runs twice (the forward and
    its recompute in the backward), its running statistics are those of one
    plain forward, bit for bit, and its gradients agree with the plain
    block's to 1e-5 of their largest magnitude."""
    import copy

    from pillarnext_tpu_torch.models.detector import full_f32
    from pillarnext_tpu_torch.models.layers import ResidualBlock, recomputed

    g = torch.Generator().manual_seed(23)
    block = ResidualBlock(48).to(device).train()
    plain = copy.deepcopy(block)
    x = torch.randn(2, 48, 128, 128, generator=g).to(device).to(memory_format=torch.channels_last)
    cot = torch.randn(2, 48, 128, 128, generator=g).to(device)
    calls = []
    block.register_forward_pre_hook(lambda *_: calls.append(1))
    with full_f32():
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        recomputed(block, xa).backward(cot)
        plain(xb).backward(cot)
    assert len(calls) == 2
    for (name, a), b in zip(block.named_buffers(), plain.buffers()):
        assert torch.equal(a, b), name
    for (name, a), b in zip([("x", xa)] + list(block.named_parameters()), [xb] + list(plain.parameters())):
        assert float((a.grad - b.grad).abs().max()) <= 1e-5 * float(b.grad.abs().max()), name


def test_small_mvf_train_step_gpu_matches_cpu(device):
    """One f32 train step of the narrowed MVF on the card (kernels 2 and 3,
    the towers recomputed) and on the CPU (plain versions), same weights and
    batch: loss within 1e-4 relative, same telemetry.  Per view: kernel 2's
    cluster-mean gather, densify and densify backward; kernel 3's
    decoration mean, the PFN's max broadcast and its backward's two sums,
    and the readback's backward sum."""
    from pillarnext_tpu_torch.data.synthetic import synthetic_batches
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
    from pillarnext_tpu_torch.utils.config import load_experiment

    cfg = load_experiment(REPO_CONFIGS / "waymo_det_mvf18_aspp_iou_car.yaml", SMALL_MVF)
    batch = synthetic_batches(cfg, 1, 2, 3000, seed=3, n_objects=4, max_points=4000)[0]
    results = {}
    for dev in ("cpu", device):
        model = build_model(cfg["model"], device=dev, generator=torch.Generator().manual_seed(0), train=True)
        opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
        launches = (monotone_row_gather.launches, sorted_segment_bcast.launches)
        scalars, _ = train_step(model, opt, batch_to_device(batch, dev))
        results[str(dev)] = (
            float(scalars["loss"]),
            {k: int(v) for k, v in scalars["telemetry"].items()},
            (monotone_row_gather.launches - launches[0], sorted_segment_bcast.launches - launches[1]),
        )
    cpu, gpu = results["cpu"], results[str(device)]
    assert gpu[0] == pytest.approx(cpu[0], rel=1e-4)
    assert gpu[1] == cpu[1] and gpu[1]["cylinder_overflow"] == 0
    assert cpu[2] == (0, 0) and gpu[2] == (6, 10)


def test_synced_batchnorm_on_the_card_matches_one_process(device, tmp_path):
    """Two ranks over gloo, both on the card (gloo all-reduces CUDA
    tensors and lets ranks share a card, which NCCL refuses), each with
    its rows: a synced BatchNorm's output, input gradients, summed weight
    and bias gradients and running statistics equal one BatchNorm over
    every row on the card within 1e-6 (masked with 37 and 5 valid rows,
    masked with none on one rank, unmasked)."""
    import importlib.util
    from pathlib import Path

    # by path: the machine may hold another package named ``tests``
    spec = importlib.util.spec_from_file_location("torch_dist_worker", Path(__file__).with_name("torch_dist_worker.py"))
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    cases = worker.bn_inputs()
    procs = worker.spawn({"device": "cuda:0", "timeout_s": 60, "cases": cases}, tmp_path)
    ranks = worker.collect(procs, tmp_path, 180)
    for name, case in cases.items():
        ref = worker.bn_reference(case, device)
        outs = [out[name] for out in ranks]
        assert not any("error" in o for o in outs), [o.get("error") for o in outs]
        for r, out in enumerate(outs):
            torch.testing.assert_close(out["y"], ref["y"][r].cpu(), rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(out["x_grad"], ref["x_grad"][r].cpu(), rtol=1e-6, atol=1e-6)
            for k in ("running_mean", "running_var"):
                torch.testing.assert_close(out[k], ref[k].cpu(), rtol=1e-6, atol=1e-6)
        for k in ("weight_grad", "bias_grad"):
            torch.testing.assert_close(outs[0][k] + outs[1][k], ref[k].cpu(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tile_gathers_on_the_card_match_plain(device, dtype):
    """ops/tile_subm.py's row movements through kernel 2 on the card (pack,
    unpack, stack-to-dense, the halo and their backwards) give the bits of
    their plain versions, at 64 channels over a 2 x 256^2 grid with an
    overflowing and a full tile capacity."""
    from pillarnext_tpu_torch.ops import tile_subm
    from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map

    g = torch.Generator().manual_seed(0)
    b, h, w, cap = 2, 256, 256, 12000
    ids = torch.unique(torch.randint(0, b * h * w, (14000,), generator=g)).to(torch.int32)
    _, _, slot_id, _ = compactify(ids, b * h * w, cap)
    sod, _ = invert_slot_map(slot_id, b * h * w)
    table = torch.randn(cap + 1, 64, generator=g).to(dtype)
    table[cap] = 0
    for tile_cap in (400, 2048):
        maps = [tile_subm.build_tile_map(s.to(d), i.to(d), b, (h, w), cap, 8, tile_cap)
                for s, i, d in ((sod, slot_id, "cpu"), (sod, slot_id, device))]
        outs = []
        for tm, plain in ((maps[1], False), (maps[1], True)):
            x = table.to(device).requires_grad_(True)
            stack = tile_subm.pack_stack(x, tm, plain)
            halo = tile_subm.halo_gather(stack, tm, plain)
            dense = tile_subm.stack_to_dense(stack, tm, plain)
            back = tile_subm.unpack_stack(stack, tm, plain)
            cot = torch.randn(halo.shape, generator=torch.Generator().manual_seed(1)).to(dtype).to(device)
            ((halo * cot).sum() + dense.float().square().sum() + back.sum()).backward()
            outs.append([t.detach().cpu() for t in (stack, halo, dense, back, x.grad)])
        for a, k in zip(*outs):
            assert torch.equal(a, k)
        assert int(maps[1].n_tiles) == int(maps[0].n_tiles) > 400
        for field in ("tile_sod", "tile_id", "nbr", "row_of_slot", "halo_rows", "halo_sources", "row_of_dense"):
            assert torch.equal(getattr(maps[1], field).cpu(), getattr(maps[0], field)), field


# ---------------------------------------------------------------- rotated / circle NMS (csrc/nms.cu)

def _nms_scene(lanes, n, seed, spread=30.0, ties=False):
    """(L, N, 7) boxes in clusters over +-spread m, (L, N) scores with ~15%
    invalid rows, (L,) thresholds mixed per lane (0 and 0.55 included)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-spread, spread, (lanes, max(n // 5, 1), 2))
    pick = rng.integers(0, centres.shape[1], (lanes, n))
    boxes = np.zeros((lanes, n, 7), np.float32)
    boxes[..., :2] = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 0.8, (lanes, n, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (lanes, n))
    boxes[..., 3:6] = rng.uniform(0.4, 6.0, (lanes, n, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (lanes, n))
    scores = (rng.choice(np.float32([0.2, 0.5, 0.9]), (lanes, n)) if ties
              else rng.random((lanes, n), np.float32))
    scores[rng.random((lanes, n)) < 0.15] = -1e9
    thresh = rng.choice(np.float32([0.0, 0.1, 0.2, 0.35, 0.55]), lanes)
    return boxes, scores.astype(np.float32), thresh


def _sorted_rows(boxes, scores, pre):
    from pillarnext_tpu_torch.core import nms

    k = min(pre, boxes.shape[1])
    top, order = torch.sort(scores, dim=1, descending=True, stable=True)
    order = order[:, :k]
    rows = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    return rows, top[:, :k] > nms.NEG_INF / 2, order


def _lanes_clear_of_ties(boxes, scores, thresh, pre, margin):
    """Lanes in which no pair of valid candidates has a nonzero IoU (the
    port's formula, on the card) within ``margin`` of the lane's threshold."""
    from pillarnext_tpu_torch.core import torch_box_ops

    rows, valid, _ = _sorted_rows(boxes, scores, pre)
    iou = torch_box_ops.boxes_iou_bev(rows, rows)
    near = ((iou - thresh[:, None, None]).abs() < margin) & (iou != 0)
    near &= valid[:, :, None] & valid[:, None, :] & torch.ones_like(near[0]).triu(1)
    return ~near.flatten(1).any(1)


def _streamed_nms(boxes, scores, thresh, pre, post, circle=False):
    """The host-driven chunk loop (``_streamed`` + ``_select``) on the same
    card: ``_chunked_nms``, the CPU's path."""
    from pillarnext_tpu_torch.core import nms, torch_box_ops

    th = thresh.reshape(-1, 1, 1)
    if circle:
        r2 = torch.square(th)
        return nms._chunked_nms(boxes[..., :2], scores, pre, post,
                                lambda a, b: torch.square(a[..., :, None, :] - b[..., None, :, :]).sum(-1) < r2)
    return nms._chunked_nms(boxes, scores, pre, post, lambda a, b: torch_box_ops.boxes_iou_bev(a, b) > th)


@pytest.mark.parametrize("lanes,n,pre,post,ties", [
    (1, 1, 1000, 83, False), (40, 1000, 1000, 83, False), (40, 1000, 1000, 1000, True),
    (7, 300, 1000, 500, False), (13, 777, 500, 20, True), (3, 129, 100, 5, False), (40, 64, 1000, 83, True),
])
def test_nms_kernel_matches_the_chunk_loop(device, lanes, n, pre, post, ties):
    """The kernel's (sel, sel_valid) equal ``_streamed`` + ``_select`` on the
    card, lane for lane, wherever no pair's IoU lies within 1e-5 of the
    lane's threshold; post_max below and above the kept count."""
    from pillarnext_tpu_torch.core import nms

    b, s, t = _nms_scene(lanes, n, seed=lanes * 1000 + n, ties=ties)
    boxes, scores, thresh = (torch.from_numpy(x).to(device) for x in (b, s, t))
    before = nms.card_greedy_nms.launches
    sel, sel_valid = nms.rotated_nms(boxes, scores, thresh, pre, post)
    torch.cuda.synchronize()
    assert nms.card_greedy_nms.launches == before + 1
    want, want_valid = _streamed_nms(boxes, scores, thresh, pre, post)
    clear = _lanes_clear_of_ties(boxes, scores, thresh, pre, 1e-5)
    assert clear.float().mean() >= 0.5
    assert torch.equal(sel_valid[clear], want_valid[clear])
    assert torch.equal(sel[clear], want[clear])
    assert sel.dtype == torch.int64 and sel_valid.dtype == torch.bool and sel.shape == (lanes, post)
    assert torch.all(sel[~sel_valid] == 0)


def test_nms_kernel_matches_the_native_greedy_nms(device):
    """Against ``native_geometry.rotated_nms`` (exact polygon clipping, the
    reference kernel's semantics) on the same score-sorted boxes, in every
    lane where the exact IoU and the port's f32 boundary integral put no
    pair of valid candidates on opposite sides of the threshold (the two
    differ by up to ~1e-2 m^2 on thin boxes, tests/test_torch_port_data.py)."""
    from pillarnext_tpu_torch.core import native_geometry, nms, torch_box_ops

    lanes, n, th = 12, 400, 0.3
    b, s, _ = _nms_scene(lanes, n, seed=11, spread=12.0)
    boxes, scores = torch.from_numpy(b).to(device), torch.from_numpy(s).to(device)
    sel, sel_valid = nms.rotated_nms(boxes, scores, torch.full((lanes,), th, device=device), n, n)
    torch.cuda.synchronize()
    rows, valid, order = (t.cpu() for t in _sorted_rows(boxes, scores, n))
    port = (torch_box_ops.boxes_iou_bev(rows.to(device), rows.to(device)) > th).cpu().numpy()
    compared = 0
    for lane in range(lanes):
        live = order[lane][valid[lane]].numpy()
        r7 = rows[lane][valid[lane]].numpy()
        inter = native_geometry.boxes_overlap_bev(r7, r7)
        area = r7[:, 3] * r7[:, 4]
        exact = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-8) > th
        m = len(live)
        if (np.triu(exact != port[lane][:m, :m], 1)).any():
            continue
        want = live[native_geometry.rotated_nms(r7, th)]
        assert 5 < len(want) < m
        np.testing.assert_array_equal(sel[lane][sel_valid[lane]].cpu().numpy(), want)
        compared += 1
    assert compared >= lanes // 2


def test_nms_kernel_keeps_a_chain_across_the_old_chunk_boundary(device):
    """A chain of 1000 unit boxes 0.6 m apart (neighbours' IoU 0.25 > 0.2):
    greedy keeps every other one, so kept rows cross the chunk loop's
    128-candidate boundaries and the kernel's 64-row words."""
    from pillarnext_tpu_torch.core import nms

    n = 1000
    boxes = torch.zeros(2, n, 7)
    boxes[..., 0] = torch.arange(n, dtype=torch.float32) * 0.6
    boxes[..., 3:6] = 1.0
    boxes[1, :, 1] = 5.0
    scores = torch.linspace(1.0, 0.1, n).repeat(2, 1)
    sel, sel_valid = nms.rotated_nms(boxes.to(device), scores.to(device), 0.2, n, 600)
    torch.cuda.synchronize()
    assert torch.equal(sel_valid.sum(1).cpu(), torch.tensor([500, 500]))
    assert torch.equal(sel[:, :500].cpu(), torch.arange(0, n, 2).repeat(2, 1))
    want, want_valid = _streamed_nms(boxes.to(device), scores.to(device), torch.full((2,), 0.2, device=device),
                                     n, 600)
    assert torch.equal(sel, want) and torch.equal(sel_valid, want_valid)


@pytest.mark.parametrize("lanes,n,post", [(40, 1000, 83), (5, 200, 300), (1, 70, 1)])
def test_circle_nms_kernel_matches_the_chunk_loop(device, lanes, n, post):
    from pillarnext_tpu_torch.core import nms

    b, s, _ = _nms_scene(lanes, n, seed=n + post, ties=lanes == 5)
    radius = np.random.default_rng(n).choice(np.float32([0.5, 1.0, 3.0]), lanes)
    centres, scores, r = (torch.from_numpy(x).to(device) for x in (b[..., :2].copy(), s, radius))
    sel, sel_valid = nms.circle_nms(centres, scores, r, n, post)
    torch.cuda.synchronize()
    want, want_valid = _streamed_nms(centres, scores, r, n, post, circle=True)
    assert torch.equal(sel, want) and torch.equal(sel_valid, want_valid)


def test_nms_kernel_rejects_bad_input(device):
    from pillarnext_tpu_torch.core import nms

    b, s, t = _nms_scene(4, 100, seed=5)
    boxes, scores, thresh = (torch.from_numpy(x).to(device) for x in (b, s, t))
    rows, valid, order = _sorted_rows(boxes, scores, 100)
    ok = dict(rows=rows, valid=valid, order=order, thresh=thresh, post_max=10, circle=False)
    nms.card_greedy_nms(**ok)
    for bad, match in (
        (dict(rows=rows.cpu()), "CUDA"),
        (dict(rows=rows.double()), "dtype"),
        (dict(rows=rows.transpose(0, 1).contiguous().transpose(0, 1)), "contiguous"),
        (dict(circle=True), "2 values"),
        (dict(valid=valid[:, :50].contiguous()), "shapes"),
        (dict(valid=valid.to(torch.uint8)), "dtype"),
        (dict(order=order.to(torch.int32)), "order"),
        (dict(order=order.t().contiguous().t()), "order"),
        (dict(thresh=thresh[:3].contiguous()), "shapes"),
        (dict(thresh=thresh.double()), "dtype"),
        (dict(post_max=-1), "sizes"),
    ):
        with pytest.raises(ValueError, match=match):
            nms.card_greedy_nms(**{**ok, **bad})
    big = torch.zeros(1, nms.MAX_CARD_CANDIDATES + 1, 7, device=device)
    with pytest.raises(ValueError, match="sizes"):
        nms.card_greedy_nms(big, torch.ones(big.shape[:2], dtype=torch.bool, device=device),
                         torch.zeros(big.shape[:2], dtype=torch.int64, device=device), thresh[:1], 10, False)
    with pytest.raises(ValueError, match="dtype"):
        nms.rotated_nms(boxes.to(torch.bfloat16), scores, thresh, 100, 10)
    sel, sel_valid = nms.rotated_nms(boxes[:, :0], scores[:, :0], thresh, 100, 10)  # no candidates
    torch.cuda.synchronize()
    assert sel.shape == (4, 10) and not sel_valid.any() and not sel.any()


def test_nms_kernel_never_synchronises(device, monkeypatch):
    """Under sync debug mode "error", a rotated and a circle NMS at the eval
    shape (40 lanes of 1000 candidates) with thresholds on the card, and one
    with a float threshold from the host, run without a synchronisation:
    one kernel entry call each."""
    from pillarnext_tpu_torch.core import nms

    b, s, t = _nms_scene(40, 1000, seed=9)
    boxes, scores, thresh = (torch.from_numpy(x).to(device) for x in (b, s, t))
    nms.rotated_nms(boxes, scores, thresh, 1000, 83)  # builds the library outside the sync check
    torch.cuda.synchronize()
    names = []
    launch = kernels.launch
    monkeypatch.setattr(kernels, "launch", lambda name, *args: (names.append(name), launch(name, *args)))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = nms.rotated_nms(boxes, scores, thresh, 1000, 83)
        circ = nms.circle_nms(boxes, scores, thresh * 4, 1000, 83)
        flt = nms.rotated_nms(boxes, scores, 0.2, 1000, 83)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert names == ["pnx_nms"] * 3
    want = _streamed_nms(boxes, scores, thresh, 1000, 83)
    clear = _lanes_clear_of_ties(boxes, scores, thresh, 1000, 1e-5)
    assert torch.equal(out[0][clear], want[0][clear]) and torch.equal(out[1][clear], want[1][clear])
    assert torch.equal(circ[0], _streamed_nms(boxes, scores, thresh * 4, 1000, 83, circle=True)[0])
    assert flt[1].any()


def test_kernel_device_time_belongs_to_its_launch_op(device):
    """A trace gives each kernel's device time to the op ``pnx::launch`` it
    was launched in, and so to the spans around the call: kernel 2 and the
    NMS kernel here (kernels 1-4 share ``kernels.launch``).  Up to three
    windows, as torch.profiler at times loses a record."""
    from torch.profiler import ProfilerActivity, profile

    from pillarnext_tpu_torch.core import nms
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather
    from pillarnext_tpu_torch.utils import profiling

    table = torch.randn(4096, 64, device=device)
    idx = torch.arange(0, 8192, 3, dtype=torch.int32, device=device)
    b, s, t = _nms_scene(4, 200, seed=3)
    boxes, scores, thresh = (torch.from_numpy(x).to(device) for x in (b, s, t))

    def calls():
        with profiling.annotate("gather_span"):
            monotone_row_gather(table, idx)
        with profiling.annotate("nms_span"):
            nms.rotated_nms(boxes, scores, thresh, 200, 83)
        torch.cuda.synchronize()

    calls()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            calls()
        host = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]
        ops = [e.device_time_total for e in host if e.name == "pnx::launch"]
        spans = {e.name: e.device_time_total for e in host if e.name.endswith("_span")}
        if len(ops) == 2 and all(t > 0 for t in ops):
            break
    assert len(ops) == 2 and all(t > 0 for t in ops), ops
    assert spans["gather_span"] >= ops[0] and spans["nms_span"] >= ops[1]
