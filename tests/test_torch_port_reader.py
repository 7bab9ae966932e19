"""The port's pillar reader vs the JAX package, on the CPU.

Voxelize and compact outputs must be exactly equal.  The compact PFN table
from the port (the plain version of kernel 1, which CPU tensors take) is
held against JAX ``PillarFeatureNet`` both on its XLA path
(``PNX_PALLAS_PFN=0``) and through the Pallas kernel in interpret mode
(``PNX_PALLAS_PFN=interpret``, as tests/test_pallas_pfn.py runs it), at
``atol = rtol = 2e-5`` (f32 reassociation), with zero rows and the dump
row exactly equal.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.pillar_encoder import PillarFeatureNet as JaxPFN
from pillarnext_tpu.ops import compact as jax_compact
from pillarnext_tpu.ops import voxelize as jax_voxelize
from pillarnext_tpu.utils.synth import lidar_like_points
from pillarnext_tpu_torch.models.pillar_encoder import PillarFeatureNet
from pillarnext_tpu_torch.ops import compact, voxelize
from tests.torch_threads import one_torch_thread  # noqa: F401

PC = (-25.0, -25.0, -5.0, 25.0, 25.0, 3.0)
VS = (0.4, 0.4, 8.0)


def _points(batch, n, seed, masked_sample=None):
    pts, mask = lidar_like_points(batch, n, PC, seed=seed)
    rng = np.random.default_rng(seed)
    # out-of-range and padded rows exercise the dump segment
    pts[:, : n // 20, 0] = rng.uniform(26.0, 30.0, (batch, n // 20))
    mask[:, -n // 20 :] = False
    if masked_sample is not None:
        mask[masked_sample] = False
    return pts, mask


def test_voxelize_and_compact_exact():
    pts, mask = _points(2, 3000, seed=0)
    grid = voxelize.VoxelGrid.create(VS, PC)
    jgrid = jax_voxelize.VoxelGrid.create(VS, PC)
    assert grid.bev_shape == jgrid.bev_shape
    xyz = pts[..., :3].reshape(-1, 3)
    valid = mask.reshape(-1)

    px, py, v = voxelize.pillar_coords(grid, torch.from_numpy(xyz), torch.from_numpy(valid))
    jpx, jpy, jv = jax_voxelize.pillar_coords(jgrid, jnp.asarray(xyz), jnp.asarray(valid))
    for a, b in ((px, jpx), (py, jpy), (v, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sid = voxelize.pillar_segment_ids(grid, px, py, v)
    np.testing.assert_array_equal(
        sid.numpy(), np.asarray(jax_voxelize.pillar_segment_ids(jgrid, jpx, jpy, jv))
    )

    hw = grid.num_pillars
    ids = np.where(valid & v.numpy(), np.repeat(np.arange(2), 3000) * hw + sid.numpy(), 2 * hw)
    ids = ids.astype(np.int32)
    for cap in (4096, 64):
        got = compact.compactify(torch.from_numpy(ids), 2 * hw, cap)
        want = jax_compact.compactify(jnp.asarray(ids), 2 * hw, cap)
        for name, a, b in zip(("order", "sorted_slot", "slot_id", "n_unique"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        sod, occ = compact.invert_slot_map(got[2], 2 * hw)
        jsod, jocc = jax_compact.invert_slot_map(want[2], 2 * hw, cap)
        np.testing.assert_array_equal(sod.numpy(), np.asarray(jsod))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def _port_reader(jvars, capacity):
    net = PillarFeatureNet(5, (16, 16), VS, PC, pillar_capacity=capacity, output="sparse")
    sd = {}
    for i in range(2):
        p = jvars["params"][f"pfn_layers_{i}"]
        s = jvars["batch_stats"][f"pfn_layers_{i}"]
        sd[f"pfn_layers.{i}.linear.weight"] = np.asarray(p["Dense_0"]["kernel"]).T
        bn, st = p["MaskedBatchNorm_0"], s["MaskedBatchNorm_0"]
        sd[f"pfn_layers.{i}.norm.weight"] = bn["scale"]
        sd[f"pfn_layers.{i}.norm.bias"] = bn["bias"]
        sd[f"pfn_layers.{i}.norm.running_mean"] = st["mean"]
        sd[f"pfn_layers.{i}.norm.running_var"] = st["var"]
    net.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return net.eval()


def _random_bn(variables, seed):
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.array, variables)
    for i in range(2):
        bn = v["params"][f"pfn_layers_{i}"]["MaskedBatchNorm_0"]
        st = v["batch_stats"][f"pfn_layers_{i}"]["MaskedBatchNorm_0"]
        c = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
        st["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return v


@pytest.mark.parametrize(
    "batch,capacity,masked_sample",
    [(2, 4096, None), (1, 64, None), (2, 256, 1)],
    ids=["two-samples", "overflow-cap64", "fully-masked-sample"],
)
def test_pfn_table_matches_jax(batch, capacity, masked_sample):
    pts, mask = _points(batch, 3000, seed=capacity, masked_sample=masked_sample)
    jnet = JaxPFN(
        num_input_features=5, num_filters=(16, 16), voxel_size=VS, pc_range=PC,
        pillar_capacity=capacity, dtype=None, output="sparse",
    )
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    variables = _random_bn(jnet.init(jax.random.PRNGKey(0), jp, jm), seed=capacity)

    telemetry = {}
    with torch.no_grad():
        sb = _port_reader(variables, capacity)(
            torch.from_numpy(pts), torch.from_numpy(mask), telemetry=telemetry
        )
    got = sb.table.numpy()
    n_occupied = int(telemetry["pillar_active"])
    cap = min(capacity * batch, 125 * 125 * batch)
    assert int(telemetry["pillar_overflow"]) == max(n_occupied - cap, 0)
    assert got.shape == (cap + 1, 16)
    assert np.abs(got[-1]).max() == 0.0  # dump row exactly zero

    for mode in ("0", "interpret"):
        os.environ["PNX_PALLAS_PFN"] = mode
        try:
            jsb = jnet.apply(variables, jp, jm)
        finally:
            os.environ.pop("PNX_PALLAS_PFN", None)
        want = np.asarray(jsb.table, np.float32)
        np.testing.assert_array_equal(sb.slot_of_dense.numpy(), np.asarray(jsb.slot_of_dense))
        np.testing.assert_array_equal(sb.valid.numpy(), np.asarray(jsb.valid))
        np.testing.assert_array_equal(
            np.abs(got).sum(-1) == 0, np.abs(want).sum(-1) == 0, err_msg=f"zero rows, mode {mode}"
        )
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"mode {mode}")
