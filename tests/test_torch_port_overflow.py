"""Overflowed train tables: the port drops the sites JAX drops, and the
sites that survive carry JAX's features (CPU).

One train-mode forward of the flagship (reader and backbone, the
all-sparse train path) in both packages, weights carried across by
``load_jax_variables``, on one frame of 9,000 uniform points over a
512 x 512 grid of 0.25 m pillars (+-64 m): the reader's train capacity
(8,192 pillars a sample) and ``stage_capacity_frac`` [1, 1, 0.5, 0.5] make
the reader and the stride-2 tables of stages 1 and 2 overflow.  A strided
table never has fewer than 4,096 rows (or the whole grid), so stage 2 can
overflow only where its grid holds more than 4,096 sites: the narrow
test grid (+-8 m, 64 x 64) cannot show it.

Checks: every ``*_active`` / ``*_overflow`` counter equals JAX's sown
telemetry; the reader's table and the backbone's dense output agree at the
port's backbone bar (``atol = rtol = 1e-3``), with the same active sites.
The port had read the dump row of its point gathers (the cluster mean's
and the eval PFN's back-gather) as zeros, where JAX's ``jnp.take`` reads
what the overflowed points put there: in training those points then
entered the PFN's batch statistics with other features, and every
surviving pillar moved (``test_reading_the_dump_row_as_zero_misses_jax``
keeps that version and shows the difference).  Last, JAX's scene of the
flagship overfit at the flagship's grid and train capacities: JAX's
voxelization, compaction and ``downsample_active_set`` drop the same
stage-1 and stage-2 sites as the port's ops (the ops alone: a full-size
forward is not run on the CPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.ops import compact as jax_compact
from pillarnext_tpu.ops import sparse_down as jax_down
from pillarnext_tpu.ops import voxelize as jax_vox
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu_torch.models.resnet import SparseResNet
from pillarnext_tpu_torch.ops import compact, scatter, sparse_down, voxelize
from pillarnext_tpu_torch.tools import overfit_sanity
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES
from tests.test_torch_port_train import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

EXTENT = 64.0
N_POINTS = 9000
OVERFLOW = [
    *(o for o in OVERRIDES if not o.startswith("model.reader.pc_range")),
    f"model.reader.pc_range={[-EXTENT, -EXTENT, -5.0, EXTENT, EXTENT, 3.0]}",
    "+model.reader.train_pillar_capacity=8192",
    "model.backbone.stage_capacity_frac=[1.0,1.0,0.5,0.5]",
]
COUNTERS = ("pillar", "stage1", "stage2", "stage3")


def _frame():
    rng = np.random.default_rng(0)
    pts = np.zeros((1, N_POINTS, 5), np.float32)
    pts[..., :2] = rng.uniform(-EXTENT, EXTENT, (1, N_POINTS, 2))
    pts[..., 2] = rng.normal(-1.0, 0.5, (1, N_POINTS))
    pts[..., 3] = rng.uniform(0.0, 1.0, (1, N_POINTS))
    return pts, np.ones((1, N_POINTS), bool)


def _port_forward(cfg, variables, pts, mask):
    model = build_model(cfg["model"], device="cpu", train=True)
    load_jax_variables(model, variables)
    tel = {}
    with torch.no_grad():
        sb = model.reader(torch.from_numpy(pts), torch.from_numpy(mask), telemetry=tel)
        out = model.backbone(sb, telemetry=tel)
    return sb.table.numpy(), out.numpy(), {k: int(v) for k, v in tel.items()}


@pytest.fixture(scope="module")
def runs():
    cfg = load_experiment(FLAGSHIP, OVERFLOW)
    pts, mask = _frame()
    jmodel = jax_builders.build_model(cfg["model"], train=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask))
    variables = random_variables(shapes, 0)

    def reader_and_backbone(mdl, p, m, train):
        sb = mdl.reader(p, m, train)
        return sb.table, mdl.backbone(sb, train)

    (table, out), col = jax.jit(lambda v, p, m: jmodel.apply(
        v, p, m, True, method=reader_and_backbone, mutable=["batch_stats", "telemetry"]))(
        variables, jnp.asarray(pts), jnp.asarray(mask))
    tel = {k: int(np.asarray(v[0])) for group in col["telemetry"].values() for k, v in group.items()}
    jax_run = {"table": np.asarray(table), "out": np.asarray(out), "telemetry": tel}
    return {"cfg": cfg, "variables": variables, "frame": (pts, mask), "jax": jax_run,
            "port": dict(zip(("table", "out", "telemetry"), _port_forward(cfg, variables, pts, mask)))}


def test_overflow_counts_equal_jax(runs):
    jt, pt = runs["jax"]["telemetry"], runs["port"]["telemetry"]
    for name in COUNTERS:
        for kind in ("active", "overflow"):
            assert pt[f"{name}_{kind}"] == jt[f"{name}_{kind}"], (name, kind, pt, jt)
    # not vacuous: the reader and stages 1 and 2 drop sites
    assert all(jt[f"{name}_overflow"] > 0 for name in ("pillar", "stage1", "stage2")), jt


def test_surviving_sites_match_jax(runs):
    j, p = runs["jax"], runs["port"]
    np.testing.assert_allclose(p["table"], j["table"], atol=1e-3, rtol=1e-3)
    active_j, active_p = (j["out"] != 0).any(-1), (p["out"] != 0).any(-1)
    np.testing.assert_array_equal(active_p, active_j)
    assert active_p.sum() > 1000
    np.testing.assert_allclose(p["out"], j["out"], atol=1e-3, rtol=1e-3)


def test_reading_the_dump_row_as_zero_misses_jax(runs, monkeypatch):
    """The port's gathers before the repair: the dump row read as zeros.
    The same sites are dropped, but the overflowed points' features, and
    with them the batch statistics of every PFN layer, differ from JAX's."""
    real = scatter.gather_segments

    def dump_as_zero(table, seg, plain=False):
        return real(torch.cat([table[:-1], table.new_zeros((1, table.shape[1]))]), seg, plain)

    monkeypatch.setattr(scatter, "gather_segments", dump_as_zero)
    table, out, tel = _port_forward(runs["cfg"], runs["variables"], *runs["frame"])
    assert tel == runs["port"]["telemetry"]
    assert np.abs(table - runs["jax"]["table"]).max() > 1e-2
    assert not np.allclose(out, runs["jax"]["out"], atol=1e-3, rtol=1e-3)


def _port_drops(ids, grid, cap, fracs):
    """The port's compaction and ``downsample_active_set`` over per-point
    pillar ids, at the capacities the port's backbone gives its tables
    (``SparseResNet.table_capacities``): (active, dropped) of the pillars,
    then of each strided stage's sites."""
    _, _, slot_id, n = compact.compactify(torch.from_numpy(ids), grid.num_pillars, cap)
    sod, _ = compact.invert_slot_map(slot_id, grid.num_pillars)
    spatial = (grid.size_y, grid.size_x)
    bb = SparseResNet([1] * 4, [1, 2, 2, 2], [8] * 4, 8, stage_capacity_frac=[1.0, *fracs])
    caps = bb.table_capacities(cap, 1, spatial)
    rows, drops = cap, [(int(n), max(int(n) - cap, 0))]
    for i in (1, 2, 3):
        cap_out = caps[f"stage{i}"]
        _, sod, _, spatial, n = sparse_down.downsample_active_set(sod, rows, 1, spatial, (3, 3), (2, 2), cap_out)
        spatial, rows = tuple(spatial), cap_out
        drops.append((int(n), max(int(n) - cap_out, 0)))
    return drops


def _jax_drops(ids, grid, cap, fracs):
    """The same by JAX's ops, at JAX's table sizes
    (pillarnext_tpu/models/resnet.py:757-760)."""
    _, _, slot_id, n = jax.jit(jax_compact.compactify, static_argnums=(1, 2))(
        jnp.asarray(ids), grid.num_pillars, cap)
    sod = jax_compact.invert_slot_map(slot_id, grid.num_pillars, cap)[0]
    rows, spatial, drops = cap, (grid.size_y, grid.size_x), [(int(n), max(int(n) - cap, 0))]
    for frac in fracs:
        cap_out = min(max(int(cap * frac), 4096), (spatial[0] + 1) // 2 * ((spatial[1] + 1) // 2))
        _, sod, _, spatial, n = jax_down.downsample_active_set(sod, rows, 1, spatial, (3, 3), (2, 2), cap_out)
        rows = cap_out
        drops.append((int(n), max(int(n) - cap_out, 0)))
    return drops


def test_overfit_scene_drops_what_jax_drops():
    """JAX's overfit scene (tools/overfit_sanity.py:57-83, the port's copy)
    at the flagship's 1344^2 grid, train capacity 73,728 and stage
    fractions.  JAX bins the points under ``jit``, where XLA divides by the
    cell size as a product with its reciprocal (ROADMAP, known defects of
    the reference): the pillars of the points that land in another cell
    than the port's true quotient puts them in lie within 1e-4 of a cell
    edge.  Over the port's pillars JAX's compaction and
    ``downsample_active_set`` keep and drop exactly the port's pillars and
    stage-1, -2 and -3 sites; over its own, stages 1 and 2 drop sites
    too."""
    cfg = load_experiment(FLAGSHIP)["model"]
    cap = int(cfg["reader"]["train_pillar_capacity"])
    fracs = [float(f) for f in cfg["backbone"]["stage_capacity_frac"][1:]]
    pts, _, _ = overfit_sanity.scene()
    grid = voxelize.VoxelGrid.create(cfg["reader"]["voxel_size"], cfg["reader"]["pc_range"])
    px, py, valid = voxelize.pillar_coords(grid, torch.from_numpy(pts[:, :3]), torch.ones(len(pts), dtype=torch.bool))
    port_ids = voxelize.pillar_segment_ids(grid, px, py, valid).numpy()
    jgrid = jax_vox.VoxelGrid.create(cfg["reader"]["voxel_size"], cfg["reader"]["pc_range"])

    @jax.jit
    def jax_ids(xyz):
        jx, jy, jvalid = jax_vox.pillar_coords(jgrid, xyz, jnp.ones(xyz.shape[0], bool))
        return jax_vox.pillar_segment_ids(jgrid, jx, jy, jvalid)

    jids = np.asarray(jax_ids(jnp.asarray(pts[:, :3])))
    moved = np.nonzero(jids != port_ids)[0]
    cells = (pts[moved, :2] - np.asarray(grid.pc_range[:2])) / np.asarray(grid.voxel_size[:2])
    assert len(moved) <= 5 and np.all(np.abs(cells - np.round(cells)).min(axis=1) < 1e-4), (moved, cells)

    port = _port_drops(port_ids, grid, cap, fracs)
    jax_own = _jax_drops(jids, grid, cap, fracs)
    print(f"overfit scene, (active, dropped) of pillars and stage 1-3 sites: port {port}, JAX {jax_own}")
    assert _jax_drops(port_ids, grid, cap, fracs) == port
    assert port[1][1] > 0 and port[2][1] > 0 and jax_own[1][1] > 0 and jax_own[2][1] > 0
