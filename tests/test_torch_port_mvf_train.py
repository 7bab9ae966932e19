"""One train step of the narrowed MVF (waymo_det_mvf18_aspp_iou_car) in both packages, on the CPU.

The MVF YAML narrowed as tests/test_torch_port_mvf.py narrows it (+-8 m at
0.25 m pillars, a 64 x 16 cylinder grid, the config's four tower stages
and strides, narrow widths, float32), B = 2: both views' PFN layers with
kernel 3's max broadcast, kernel 2's densifies and their backwards (plain
versions on the CPU), the towers with every block recomputed in the
backward (``layers.recomputed``), the readback's sorted-sum backward
(``_Bilinear``), the PointNets' masked statistics, the coarse max's
backward over ids that do not ascend, ASPP, the two-task Waymo CenterHead
and its losses.  One batch of seeded synthetic scenes, one set of weights
drawn with numpy and carried to the port by its own ``export_mvfnext``.
JAX runs ``make_train_step`` (every tower block rematerialised) with an
optimizer that only records the gradients; the port runs
``train_state.train_step``.  The bars are those of
tests/test_torch_port_voxel_train.py (``check_*``): loss 1e-5 relative,
per-task logs 1e-4, every gradient within 1e-3 of its largest JAX
magnitude, BN running statistics 1e-5 (a second update by the recompute
would move them by ~1e-3), parameters after AdamW 1e-5, telemetry equal.
The weights need no calibration here: a train-mode forward normalises by
the batch's statistics.

Two f32 implementations can put a ReLU input on opposite sides of 0, and
every gradient below it then moves by far more than the bar (at 8 of the
12 data / weight seeds 0-3 x 0-2, by 2.4-167x the bar).  The full
comparison runs at data seed 3, weight seed 0, where no ReLU input
flips.  At every one of the 12 seeds ``ReluTrace`` records each ReLU
input in both packages: each input whose sign differs lies within the
rounding noise of its call (|x| <= 1.9e-4 where the call's largest
entry is 4.8-28), and with its ReLU masks pinned to JAX's the port's step
meets the gradient bar (at most 0.53 of it).  Seeds 0 and 1 also hold
the loss to 1e-5.

Also: ``segment_max``'s backward over unsorted ids with ties and
``_bilinear``'s backward, each against ``jax.vjp`` of the JAX function;
and the Trainer raising, naming ``cylinder_overflow``, when the cylinder
table is too small.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.mvf_encoder import _bilinear as jax_bilinear
from pillarnext_tpu.ops import scatter as jax_scatter
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.models.layers import ConvBlock, ResidualBlock
from pillarnext_tpu_torch.models.mvf_encoder import _bilinear
from pillarnext_tpu_torch.ops import scatter
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from tests.test_torch_port_mvf import MVF, OVERRIDES
from tests.test_torch_port_voxel_train import (
    ReluTrace,
    VoxelPair,
    check_adamw,
    check_flips,
    check_bn_statistics,
    check_gradients,
    check_loss_and_logs,
    flip_sweep,
    one_step,
    relu_flips,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA_SEED = 3
WEIGHT_SEED = 0


@pytest.fixture(scope="module")
def pair():
    return VoxelPair(MVF, OVERRIDES)


@pytest.fixture(scope="module")
def steps(pair):
    """``one_step``, with every call of a tower block counted."""
    calls: dict = {}

    def count(module, _):
        if isinstance(module, (ConvBlock, ResidualBlock)):
            calls[id(module)] = calls.get(id(module), 0) + 1

    handle = torch.nn.modules.module.register_module_forward_pre_hook(count)
    try:
        out = one_step(pair, DATA_SEED, WEIGHT_SEED)
    finally:
        handle.remove()
    reader = out["model"].reader
    out["tower_calls"] = [calls.get(id(block), 0) for view in (reader.pillar_view, reader.cylinder_view)
                          for stage in view.blocks for block in stage]
    return out


def test_mvf_train_step_loss_and_logs_match_jax(steps):
    check_loss_and_logs(steps, 2)


def test_mvf_train_step_gradients_match_jax(steps):
    checked, nonzero = check_gradients(steps)
    assert checked > 100
    # every reader tensor gets a gradient: both views' PFN layers and
    # towers, both PointNets
    reader = {n for n, _ in steps["model"].named_parameters() if n.startswith("reader.")}
    assert reader <= nonzero, sorted(reader - nonzero)[:5]


def test_mvf_train_step_bn_statistics_match_jax_under_recompute(steps):
    """Each tower block ran twice (the forward and its recompute in the
    backward), and the running statistics moved once, as JAX's."""
    # 4 stages of a strided ConvBlock and 2 ResidualBlocks, in each view
    assert steps["tower_calls"] == [2] * 24, steps["tower_calls"]
    assert check_bn_statistics(steps) > 50


def test_mvf_train_step_adamw_parameters_match_jax(steps):
    check_adamw(steps)


def test_mvf_train_step_telemetry_matches_jax(steps):
    got = {k: int(v) for k, v in steps["scalars"]["telemetry"].items()}
    want = {k: int(v) for k, v in steps["jax"]["telemetry"].items()}
    assert got == want
    assert sorted(got) == sorted(f"{t}_{k}" for t in ("pillar", "cylinder") for k in ("active", "overflow"))
    assert int(steps["scalars"]["overflow"]) == steps["jax"]["overflow"] == 0
    assert got["pillar_active"] > 0 and got["cylinder_active"] > 0


def test_mvf_synthetic_labels_on_the_head_grid(steps):
    """Waymo's two tasks, on the out_size_factor-4 grid of the pillar view."""
    model, batch = steps["model"], steps["batch"]
    grid = model.reader.pillar_grid
    assert model.head.class_names == [["vehicle"], ["pedestrian", "cyclist"]]
    assert [hm.shape[1:] for hm in batch["hm"]] == [(grid.size_y // 4, grid.size_x // 4, n) for n in (1, 2)]


# ------------------------------------------------------------------ ReLU flips


@pytest.fixture(scope="module")
def trace(pair):
    return ReluTrace(pair)


@pytest.mark.parametrize("seed", range(2))
def test_mvf_train_step_gradients_match_jax_near_seed(trace, seed):
    """At data and weight seed ``seed``: the loss within 1e-5 relative, and
    every gradient gap is a ReLU flip (``check_flips``)."""
    r = relu_flips(trace, seed, seed)
    assert r["loss_rel"] <= 1e-5, r["loss_rel"]
    check_flips(r)


@pytest.mark.parametrize("weight_seed", range(3))
@pytest.mark.parametrize("data_seed", range(4))
def test_mvf_relu_flips_explain_every_gradient_gap(trace, data_seed, weight_seed):
    """At each of the 12 data / weight seeds 0-3 x 0-2, every gradient gap
    is a ReLU flip: each flipped input lies within its call's rounding
    noise, and with JAX's masks the port's gradients meet the bar.  Where
    nothing flips, the port's own step meets it."""
    r = relu_flips(trace, data_seed, weight_seed)
    check_flips(r)
    if not r["flips"]:
        assert r["free"] <= 1.0, r


# ------------------------------------------------------------------ the new backwards


@pytest.mark.parametrize("order", ["unsorted", "ascending"])
def test_segment_max_backward_matches_jax(order):
    """The cotangent split evenly among tied maxima, against ``jax.vjp`` of
    JAX's ``segment_max``, over ids in any order and over ascending ids
    (the MVF coarse max's and the PFN table's).  Rows of small integers
    give many ties; one segment is empty and one holds a single row."""
    rng = np.random.default_rng(3)
    n, c, segs = 600, 5, 40
    data = rng.integers(0, 4, (n, c)).astype(np.float32)
    ids = rng.integers(0, segs - 2, n).astype(np.int32)  # segment segs - 2 stays empty
    ids[0] = segs - 1  # a one-row segment
    if order == "ascending":
        ids = np.sort(ids)
    g = rng.standard_normal((segs, c)).astype(np.float32)

    want_out, vjp = jax.vjp(lambda d: jax_scatter.segment_max(d, jnp.asarray(ids), segs), jnp.asarray(data))
    (want,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(data).requires_grad_()
    out = scatter.segment_max(x, torch.from_numpy(ids), segs)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert (np.asarray(want) != 0).sum() > segs * c  # ties split: more maxima than segments


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_backward_matches_jax(dtype):
    """The readback's image gradient against ``jax.vjp`` of JAX's
    ``_bilinear``: points inside, on cell edges and outside the image (edge
    clamps put up to four corners on one pixel).  f32 within 1e-5 relative
    and 1e-6 of the largest magnitude (the sums run in another order); bf16
    (JAX scatter-adds bf16 rows, the port sums them in f32 and rounds
    once) within 1e-2 of the largest magnitude."""
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    n = 400
    u = rng.uniform(-1.5, 8.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 6.5, n).astype(np.float32)
    u[:4] = [0.0, 6.0, 3.0, 7.0]
    batch = rng.integers(0, 2, n).astype(np.int32)
    g = rng.standard_normal((n, 6)).astype(np.float32)

    _, vjp = jax.vjp(lambda im: jax_bilinear(im, jnp.asarray(batch), jnp.asarray(u), jnp.asarray(v)),
                     jnp.asarray(image).astype(dtype))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want.astype(jnp.float32))
    x = torch.from_numpy(image).to(getattr(torch, dtype)).requires_grad_()
    _bilinear(x, torch.from_numpy(batch), torch.from_numpy(u), torch.from_numpy(v)).backward(torch.from_numpy(g))
    assert x.grad.dtype == x.dtype
    got = x.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())
    assert (want != 0).mean() > 0.9


# ------------------------------------------------------------------ Trainer


def test_mvf_undersized_cylinder_capacity_raises_overflow(tmp_path):
    """A cylinder table of 64 rows a sample for ~290 occupied cells: the
    Trainer raises and names the counter."""
    cfg = load_experiment(MVF, [*OVERRIDES, "model.reader.cylinder_capacity=64"])
    batches = synthetic_batches(cfg, 1, 2, 3000, seed=4, n_objects=4, max_points=4000)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    opt, sched = build_optimizer(cfg, len(batches), list(model.parameters()))
    trainer = Trainer(model, batches, opt, sched, max_epochs=1, work_dir=tmp_path, device="cpu")
    with pytest.raises(RuntimeError, match="cylinder_overflow"):
        trainer.fit()


if __name__ == "__main__":  # JAX_PLATFORMS=cpu PYTHONPATH=tests python -m tests.test_torch_port_mvf_train
    flip_sweep(ReluTrace(VoxelPair(MVF, OVERRIDES)))
