"""One train step in each train stage mode of the port's SparseResNet vs
the JAX package (CPU).

tests/test_torch_port_train.py's narrowed flagship (+-8 m, 0.25 m pillars:
a 64 x 64 grid, narrow widths, float32, B = 2) with one block per stage,
at that file's data and weight seeds, through JAX's ``make_train_step``
and the port's ``train_step``, in each mode:

- ``tile_stride1``: the all-sparse backbone with its stride-1 stage over
  the active-tile stack;
- ``tile``: the stride-1 prefix over the tile stack, then the masked-dense
  tail (each dense block recomputed in the backward, ``remat_train``);
- ``leading``: the prefix as SubM convs, then the masked-dense tail;
- ``leading_down``: the prefix and the first strided conv sparse, densified
  at H/2, then the masked-dense tail;
- ``force_dense_train``: masked-dense from stage 0;
- ``dense_image``: strides [2, 2, 2, 1] over the reader's dense image
  (plain batch statistics), held against JAX's step in float64: see below.

Each is held at test_torch_port_train.py's bars: the loss and per-task
logs, every gradient, the BN statistics, the parameters after AdamW, and
the telemetry (equal, overflow 0).

Two f32 implementations can put a ReLU input on opposite sides of 0 (see
test_torch_port_train.py), and every gradient below it then moves by more
than the bar.  All modes run at the same seeds; where the step's gradients
miss the bar, tests/test_torch_port_voxel_train.py's ``ReluTrace`` records
every ReLU input in both packages: each input whose sign differs must lie
within its call's rounding noise (``check_flips``), and the logs,
gradients, BN statistics and AdamW parameters are then held at the same
bars on the port's step rerun with JAX's ReLU masks (the loss and the
telemetry always on the free step).  At these seeds ``leading``,
``leading_down`` and ``force_dense_train`` flip 2-4 ReLU inputs of |x| <=
1.6e-5, each inside its call's noise; the other modes meet the bars on
the free step.

In the dense-image mode JAX's own f32 step lies ~1e-5 (relative) from its
float64 step: the unmasked BatchNorm statistics of a mostly empty image
cancel (E[x^2] - E[x]^2 over many equal cells), and XLA's f32 sums there
are less exact than ATen's.  The port's f32 step lies ~10x nearer that
float64 step than JAX's f32 step does (per-task losses 1e-5 against
1.5e-4 off, the neck's BN variance 3.7e-5 against 1.5e-4), so this mode's
reference is JAX's step run under ``jax.enable_x64`` on the same numbers
cast to float64, at the same bars.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch

import tests.test_torch_port_train as base
from pillarnext_tpu.train import train_state as jax_ts
from tests.test_torch_port_voxel_train import ReluTrace, check_flips, gradient_ratio, relu_flips
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu_torch.utils.config import load_experiment
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES

ONE_BLOCK = ["model.backbone.layer_nums=[1,1,1,1]"]
F64_MODES = ("dense_image",)  # held against JAX's float64 step (module docstring)
MODES = {
    "tile_stride1": ["+model.backbone.tile_stride1=true"],
    "tile": ["+model.backbone.sparse_stages_train=tile"],
    "leading": ["+model.backbone.sparse_stages_train=leading"],
    "leading_down": ["+model.backbone.sparse_stages_train=leading+down"],
    "force_dense_train": ["+model.backbone.force_dense_train=true"],
    "dense_image": ["model.backbone.ds_layer_strides=[2,2,2,1]"],
}
CHECKS = ("loss_and_logs", "gradients", "bn_statistics", "adamw_parameters", "telemetry")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_f64(tree):
    """A numpy tree with its float32 leaves as float64."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


class ModePair(base.Pair):
    """base.Pair over the narrowed flagship in one stage mode; with ``x64``
    JAX runs on the same numbers in float64 (the port in float32)."""

    def __init__(self, overrides: list, x64: bool = False):
        self.cfg = load_experiment(FLAGSHIP, OVERRIDES + ONE_BLOCK + overrides)
        self.jmodel = jax_builders.build_model(self.cfg["model"], train=True)
        self.jax_step = jax_ts.make_train_step(self.jmodel, base.RECORD, None, donate=False)
        self.shapes = None
        self.x64 = x64

    def run_jax(self, variables: dict, batch: dict):
        if not self.x64:
            return super().run_jax(variables, batch)
        with jax.enable_x64(True):
            return super().run_jax(as_f64(variables), as_f64(batch))


class ModeTrace(ReluTrace):
    """ReluTrace whose JAX forward runs as its pair's train step does."""

    def jax_inputs(self, variables: dict, batch: dict) -> list:
        if not self.pair.x64:
            return super().jax_inputs(variables, batch)
        with jax.enable_x64(True):
            return super().jax_inputs(as_f64(variables), as_f64(batch))


def run_steps(pair: ModePair) -> dict:
    """One step in both packages at base's seeds: what base's checks read."""
    batch = pair.batch(base.DATA_SEED)
    variables = pair.variables(batch, base.WEIGHT_SEED)
    params, stats = variables["params"], variables["batch_stats"]
    new_state, scalars, logs = pair.run_jax(variables, batch)
    grads = new_state.opt_state["g"]
    with jax.enable_x64(pair.x64):
        jparams = as_f64(params) if pair.x64 else params
        tx, _ = jax_builders.build_optimizer(pair.cfg, base.STEPS_PER_EPOCH)
        updates, _ = tx.update(grads, tx.init(jparams), jparams)
        after = base._np(optax.apply_updates(jparams, updates))
    jax_out = {
        "loss": float(scalars["loss"]), "logs": base._np(logs), "telemetry": base._np(scalars["telemetry"]),
        "grads": base._np(grads), "params": after,
        "stats": base._np(new_state.batch_stats), "overflow": int(scalars["overflow"]),
    }
    model, opt, pscalars, plogs = pair.run_port(variables, batch)
    return {
        "jax": jax_out, "model": model, "scalars": pscalars, "logs": plogs, "lr0": opt.schedule(0),
        "grads_sd": pair.export(model, jax_out["grads"], stats),
        "after_sd": pair.export(model, jax_out["params"], jax_out["stats"]),
    }


_STEPS: dict = {}


def steps_of(mode: str) -> dict:
    """``run_steps`` of the mode; where its gradients miss the bar, with
    the ReLU trace (``flips``) and the port's step pinned to JAX's ReLU
    masks in place of the free step's model and logs."""
    if mode not in _STEPS:
        pair = ModePair(MODES[mode], x64=mode in F64_MODES)
        steps = run_steps(pair)
        if gradient_ratio(steps["model"], steps["grads_sd"])[0] > 1.0:
            r = relu_flips(ModeTrace(pair), base.DATA_SEED, base.WEIGHT_SEED)
            steps.update(flips=r, model=r["pinned_step"][0], logs=r["pinned_step"][1])
        _STEPS[mode] = steps
    return _STEPS[mode]


def check_telemetry(steps: dict, mode: str) -> None:
    got = {k: int(v) for k, v in steps["scalars"]["telemetry"].items()}
    want = {k: int(np.max(v)) for k, v in steps["jax"]["telemetry"].items()}
    assert got == want
    assert int(steps["scalars"]["overflow"]) == steps["jax"]["overflow"] == 0
    assert got["pillar_active"] > 0
    expected = {"tile_stride1": "stage0_tiles64_active", "tile": "prefix_tiles64_active",
                "leading_down": "stage1_active"}.get(mode)
    if expected:
        assert got[expected] > 0, got


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_in_mode_matches_jax(mode, check):
    steps = steps_of(mode)
    if check == "telemetry":
        check_telemetry(steps, mode)
    else:
        if check == "gradients" and "flips" in steps:
            check_flips(steps["flips"])
        getattr(base, f"test_train_step_{check}_match_jax")(steps)
