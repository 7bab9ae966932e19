"""The port's voxel reader and 3-D sparse ops vs the JAX package, on the CPU.

Same seeded numpy inputs on the 32 x 32 x 24 grid of
tests/test_voxel_mirror_parity.py through both packages:

- the voxel reader (``output="sparse"``): ``slot_id``, ``slot_of_dense``,
  ``valid`` and the ``voxel_active`` / ``voxel_overflow`` counters exactly
  equal, the mean table within 2e-5 (f32 sums in another order), also
  when the table overflows;
- 3-D ``downsample_active_set`` and the strided tap tables, (3,3,3)/(2,2,2)
  with padding 1 and the extra z-downsample (3,1,1)/(2,1,1) with padding 0,
  with and without an overflowing output table: every integer output exactly
  equal;
- the 3-D neighbour table exactly, and SubM with K = 27 within 1e-4.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.voxel_encoder import VoxelFeatureNet as JaxVoxelFeatureNet
from pillarnext_tpu.ops import sparse_down as jax_down
from pillarnext_tpu.ops import subm_conv as jax_subm
from pillarnext_tpu.ops import voxelize as jax_voxelize
from pillarnext_tpu_torch.models.voxel_encoder import VoxelFeatureNet
from pillarnext_tpu_torch.ops import sparse_down, subm_conv, voxelize
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map

VOXEL = [0.4, 0.4, 0.25]
PC_RANGE = [-6.4, -6.4, -3.0, 6.4, 6.4, 3.0]  # grid 32 x 32 x 24
GRID = (24, 32, 32)  # (D, H, W)
B = 2


def make_points(b=B, n=600, seed=0):
    """Points of tests/test_voxel_mirror_parity.py, plus rows outside the
    grid in x and in z that the reader must drop."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n, 5), np.float32)
    pts[..., :2] = rng.uniform(-6, 6, (b, n, 2))
    pts[..., 2] = rng.uniform(-2.8, 2.8, (b, n))
    pts[..., 3:] = rng.uniform(0, 1, (b, n, 2))
    pts[:, :10, 0] = rng.uniform(6.5, 9.0, (b, 10))
    pts[:, 10:20, 2] = rng.uniform(3.1, 4.0, (b, 10))
    mask = rng.uniform(size=(b, n)) < 0.9
    return pts, mask


def test_voxel_coords_and_segment_ids_exact():
    pts, mask = make_points()
    grid = voxelize.VoxelGrid.create(VOXEL, PC_RANGE)
    jgrid = jax_voxelize.VoxelGrid.create(VOXEL, PC_RANGE)
    assert grid.num_voxels == jgrid.num_voxels == int(np.prod(GRID))
    xyz, valid = pts[..., :3].reshape(-1, 3), mask.reshape(-1)
    got = voxelize.voxel_coords(grid, torch.from_numpy(xyz), torch.from_numpy(valid))
    want = jax_voxelize.voxel_coords(jgrid, jnp.asarray(xyz), jnp.asarray(valid))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[3].numpy()[:20].any(), "points outside x or z must be invalid"
    np.testing.assert_array_equal(
        voxelize.voxel_segment_ids(grid, *got).numpy(),
        np.asarray(jax_voxelize.voxel_segment_ids(jgrid, *want)),
    )


@pytest.mark.parametrize("capacity", [2048, 300])
def test_voxel_reader_matches_jax(capacity):
    """capacity 300 per sample overflows (~500 occupied voxels each)."""
    pts, mask = make_points()
    jreader = JaxVoxelFeatureNet(
        voxel_size=VOXEL, pc_range=PC_RANGE, voxel_capacity=capacity, output="sparse"
    )
    jsb, jtel = jreader.apply({}, jnp.asarray(pts), jnp.asarray(mask), mutable="telemetry")
    reader = VoxelFeatureNet(VOXEL, PC_RANGE, voxel_capacity=capacity, output="sparse")
    tel = {}
    sb = reader(torch.from_numpy(pts), torch.from_numpy(mask), telemetry=tel)

    assert sb.spatial == tuple(jsb.spatial) == GRID and sb.batch == jsb.batch == B
    for name in ("slot_id", "slot_of_dense", "valid"):
        np.testing.assert_array_equal(getattr(sb, name).numpy(), np.asarray(getattr(jsb, name)))
    np.testing.assert_allclose(sb.table.numpy(), np.asarray(jsb.table), atol=2e-5, rtol=2e-5)
    assert not sb.table[-1].any(), "the dump row must be zero"
    jt = jtel["telemetry"]
    for name in ("voxel_active", "voxel_overflow"):
        assert int(tel[name]) == int(np.asarray(jt[name][0])), name
    assert (int(tel["voxel_overflow"]) > 0) == (capacity == 300)


def test_voxel_reader_capacity_argument_and_dense_output():
    pts, mask = make_points()
    reader = VoxelFeatureNet(VOXEL, PC_RANGE, voxel_capacity=2048, output="sparse")
    assert reader.capacity == 2048
    sb = reader(torch.from_numpy(pts), torch.from_numpy(mask), capacity=300)
    assert sb.capacity == 300 * B
    # the dense volume is the sparse table densified (its own table cannot overflow)
    dense = VoxelFeatureNet(VOXEL, PC_RANGE, output="dense")(torch.from_numpy(pts), torch.from_numpy(mask))
    full = VoxelFeatureNet(VOXEL, PC_RANGE, voxel_capacity=2048, output="sparse")(
        torch.from_numpy(pts), torch.from_numpy(mask))
    assert dense.shape == (B, *GRID, 5)
    assert torch.equal(dense, full.to_dense())
    with pytest.raises(ValueError, match="output"):
        VoxelFeatureNet(VOXEL, PC_RANGE, output="volume")


def _active_set_3d(seed, n_sites, cap):
    """slot_id, slot_of_dense (port tensors and JAX arrays) of a clustered
    3-D active set over (B, *GRID)."""
    rng = np.random.default_rng(seed)
    cell = int(np.prod(GRID))
    ids = []
    for b in range(B):
        centres = rng.integers(0, GRID, (5, 3))
        zyx = centres[rng.integers(0, 5, n_sites)] + rng.integers(-3, 4, (n_sites, 3))
        ok = ((zyx >= 0) & (zyx < GRID)).all(1)
        zyx = zyx[ok]
        ids.append(b * cell + (zyx[:, 0] * GRID[1] + zyx[:, 1]) * GRID[2] + zyx[:, 2])
    ids = np.concatenate(ids).astype(np.int32)
    _, _, slot_id, n = compactify(torch.from_numpy(ids), B * cell, cap)
    assert int(n) <= cap
    sod, valid = invert_slot_map(slot_id, B * cell)
    return slot_id, sod, valid


DOWN_CASES = [
    ((3, 3, 3), (2, 2, 2), None, 4000),
    ((3, 3, 3), (2, 2, 2), None, 500),  # the output table overflows
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 4000),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 300),  # the output table overflows
]


@pytest.mark.parametrize("kernel_shape,stride,padding,cap_out", DOWN_CASES)
def test_downsample_3d_and_tables_exact(kernel_shape, stride, padding, cap_out):
    cap_in = 1200
    slot_id, sod, _ = _active_set_3d(1, 300, cap_in)
    got = sparse_down.downsample_active_set(
        sod, cap_in, B, GRID, kernel_shape, stride, cap_out, padding
    )
    want = jax_down.downsample_active_set(
        jnp.asarray(sod.numpy()), cap_in, B, GRID, kernel_shape, stride, cap_out, padding
    )
    out_slot_id, out_sod, out_valid, out_sp, n_out = got
    assert tuple(out_sp) == tuple(want[3])
    if padding is not None:
        assert out_sp == (11, 32, 32)  # D = 24 -> 11 at padding 0 (13 at padding 1)
    for a, b in zip((out_slot_id, out_sod, out_valid, n_out), (want[0], want[1], want[2], want[4])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (int(n_out) > cap_out) == (cap_out < 1000)

    fwd, rev = sparse_down.build_down_neighbor_tables(
        sod, out_slot_id, slot_id, B, GRID, kernel_shape, stride, padding
    )
    jfwd, jrev = jax_down.build_down_neighbor_tables(
        jnp.asarray(sod.numpy()), want[0], want[1], jnp.asarray(slot_id.numpy()),
        B, GRID, kernel_shape, stride, padding,
    )
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jfwd))
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    np.testing.assert_array_equal(
        sparse_down.down_neighbor_table(sod, out_slot_id, cap_in, B, GRID, kernel_shape, stride, padding).numpy(),
        np.asarray(jfwd),
    )


def test_neighbor_table_3d_and_subm_k27():
    cap = 1200
    slot_id, sod, valid = _active_set_3d(2, 300, cap)
    offsets = subm_conv.subm_offsets_3d(3)
    np.testing.assert_array_equal(offsets, jax_subm.subm_offsets_3d(3))
    nbr = subm_conv.build_neighbor_table(sod, slot_id, GRID, offsets, cap)
    jnbr = jax_subm.build_neighbor_table(
        jnp.asarray(sod.numpy()), jnp.asarray(slot_id.numpy()), GRID, offsets, cap
    )
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    assert nbr.shape == (cap, 27)

    rng = np.random.default_rng(3)
    feats = rng.standard_normal((cap, 8)).astype(np.float32) * valid.numpy()[:, None]
    table = np.concatenate([feats, np.zeros((1, 8), np.float32)])
    kernel = rng.standard_normal((27, 8, 12)).astype(np.float32) / np.sqrt(27 * 8)
    got = subm_conv.subm_conv(torch.from_numpy(table), nbr, torch.from_numpy(kernel)).numpy()
    want = np.asarray(jax_subm.subm_conv(jnp.asarray(table), jnbr, jnp.asarray(kernel)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.all(got[~valid.numpy()] == 0)
