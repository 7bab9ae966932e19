"""One train step of the narrowed two-task Waymo configs in both packages, on the CPU.

The Waymo pp18 (waymo_det_pp18_aspp_iou_car_sp) and voxel18
(waymo_det_voxel18_aspp_iou_car) YAMLs narrowed as
tests/test_torch_port_waymo_e2e.py narrows them (``NARROWED``: +-8 m at
0.25 m cells, voxel18 with the config's 40 levels of 0.15 m, narrow
widths, float32), B = 2, each a parametrised case: the config's own
``train_pillar_capacity`` (pp18) and ``stage_capacity_frac`` (voxel18),
the two tasks [vehicle], [pedestrian, cyclist] with their labels on the
out_size_factor-4 grid, the Waymo head and its losses.  One batch of
seeded synthetic scenes with Waymo's class names, one set of weights drawn
with numpy and carried to the port by its exporter; JAX runs
``make_train_step`` with an optimizer that only records the gradients.
The bars are tests/test_torch_port_voxel_train.py's (``check_*``), at data
and weight seed 0.  At each of the 12 data / weight seeds 0-3 x 0-2,
``ReluTrace`` shows that every gradient gap is a ReLU input on opposite
sides of 0 in the two packages, within rounding of 0 (pp18 at data seed
1 / weight seed 0, voxel18 at 1 / 2 miss the bar by 178x and 10.6x with
the port's own masks).
"""

from __future__ import annotations

import pytest

from tests.test_torch_port_voxel_train import (
    ReluTrace,
    VoxelPair,
    check_adamw,
    check_bn_statistics,
    check_flips,
    check_gradients,
    check_loss_and_logs,
    flip_sweep,
    one_step,
    relu_flips,
)
from tests.test_torch_port_waymo_e2e import NARROWED
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 0


@pytest.fixture(scope="module", params=sorted(NARROWED))
def pair(request):
    path, pc, overrides = NARROWED[request.param]
    out = VoxelPair(path, [f"model.reader.pc_range={pc}", *overrides])
    out.family = request.param
    return out


@pytest.fixture(scope="module")
def steps(pair):
    return {**one_step(pair, SEED, SEED), "family": pair.family, "cfg": pair.cfg}


def test_waymo_train_step_loss_and_logs_match_jax(steps):
    check_loss_and_logs(steps, 2)


def test_waymo_train_step_gradients_match_jax(steps):
    checked, nonzero = check_gradients(steps)
    assert checked > 100
    backbone = {n for n, _ in steps["model"].named_parameters() if n.startswith(("reader.", "backbone."))}
    assert backbone <= nonzero, sorted(backbone - nonzero)[:5]


def test_waymo_train_step_bn_statistics_match_jax(steps):
    assert check_bn_statistics(steps) > 50


def test_waymo_train_step_adamw_parameters_match_jax(steps):
    check_adamw(steps)


def test_waymo_train_step_telemetry_matches_jax(steps):
    got = {k: int(v) for k, v in steps["scalars"]["telemetry"].items()}
    want = {k: int(v) for k, v in steps["jax"]["telemetry"].items()}
    assert got == want
    assert int(steps["scalars"]["overflow"]) == steps["jax"]["overflow"] == 0
    tables = {"pp18": ("pillar", "stage1", "stage2", "stage3"),
              "voxel18": ("voxel", "stage1", "stage2", "stage3", "extra")}[steps["family"]]
    assert sorted(got) == sorted(f"{t}_{k}" for t in tables for k in ("active", "overflow"))
    assert all(got[f"{t}_active"] > 0 for t in tables)


def test_waymo_train_labels_on_the_head_grid(steps):
    """Waymo's class names in two tasks; the targets on the out_size_factor-4
    grid, which the head's maps match; pp18 trains at its config's
    ``train_pillar_capacity`` (77,824 a sample, capped here by the 64 x 64
    grid as in JAX)."""
    model, batch, cfg = steps["model"], steps["batch"], steps["cfg"]
    grid = model.reader.grid
    assert cfg["data"]["train_dataset"]["prepare_label"]["centermap"]["tasks"] == [
        ["vehicle"], ["pedestrian", "cyclist"]]
    assert [hm.shape[1:] for hm in batch["hm"]] == [(grid.size_y // 4, grid.size_x // 4, n) for n in (1, 2)]
    assert sum(int(m.sum()) for m in batch["mask"]) >= 4
    if steps["family"] == "pp18":
        assert model.reader.train_pillar_capacity == 77824


@pytest.fixture(scope="module")
def trace(pair):
    return ReluTrace(pair)


@pytest.mark.parametrize("weight_seed", range(3))
@pytest.mark.parametrize("data_seed", range(4))
def test_waymo_relu_flips_explain_every_gradient_gap(trace, data_seed, weight_seed):
    """At each of the 12 data / weight seeds: the loss within 1e-5
    relative, and every gradient gap is a ReLU flip (``check_flips``);
    where nothing flips, the port's own step meets the bar."""
    r = relu_flips(trace, data_seed, weight_seed)
    assert r["loss_rel"] <= 1e-5, r["loss_rel"]
    check_flips(r)
    if not r["flips"]:
        assert r["free"] <= 1.0, r


if __name__ == "__main__":  # JAX_PLATFORMS=cpu PYTHONPATH=tests python -m tests.test_torch_port_waymo_train
    for family, (path, pc, overrides) in sorted(NARROWED.items()):
        print(family)
        flip_sweep(ReluTrace(VoxelPair(path, [f"model.reader.pc_range={pc}", *overrides])))
