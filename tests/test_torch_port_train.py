"""One train step of the narrowed flagship in both packages, on the CPU.

The real flagship experiment YAML, narrowed as tests/test_torch_port_e2e.py
narrows it (+-8 m, 0.25 m pillars, narrow widths, float32), B = 2.  One
batch of seeded synthetic scenes (the port's synth + AssignLabel +
collate), one set of weights drawn with numpy and carried to the port by
its own ``export_pillarnext``.  JAX runs its train step through
``make_train_step`` with an optimizer that only records the gradients;
the optax AdamW of ``build_optimizer`` is then applied to them.  The port
runs ``train_state.train_step``.

Bars:
- the loss: 1e-5 relative.  Each per-task log: 1e-4 relative (plus 1e-5
  of the largest entry, for the per-dimension vector): a task's losses are
  sums over a handful of object centres of head outputs that carry the
  forward's accumulated ~1e-5 relative f32 difference, with little
  averaging to shrink it;
- every gradient tensor: max|d| <= 1e-3 * max|g_jax| + 1e-6, except the
  conv biases that feed a train-mode BatchNorm, whose gradient is zero
  analytically: there both sides must be rounding noise, below 1e-5 of
  the conv weight's gradient;
- BN running statistics after the step: 1e-5;
- parameters after AdamW: 1e-5 absolute, except where a gradient is
  rounding noise (|g| < 1e-4 * max|g| of its tensor, or of opposite sign
  on the two sides): AdamW's first step moves every weight by ~lr * sign(g),
  so there the bar is tests/test_training.py's 2.5 * lr0;
- the overflow telemetry: equal.

Two f32 implementations of a 30-layer ReLU network disagree in the last
bits, so at some seeds a pre-activation within that distance of 0 takes
the ReLU's other side in one of them, and every gradient below it moves by
far more than these bars.  The full comparison above runs at a seed with
no such boundary case.  ``test_train_step_gradients_match_jax_near_seed``
covers other seeds: a flip is a property of the exact weights, so among
weight sets within 1e-6 relative of a seed's draw (which moves the true
gradient by ~1e-6) one must agree at the bar; a fault in the port's
gradient would show at every such draw.  Run this file as a script
(``JAX_PLATFORMS=cpu python -m tests.test_torch_port_train``) for the
sweep of seeds 0-9, 16 draws each: at each seed, how many draws disagree
beyond the bar and by how much.  torch runs with one thread so that its
sums keep one order.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pillarnext_tpu.train import train_state as jax_ts
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.train.train_state import train_step
from pillarnext_tpu_torch.train.trainer import batch_to_device
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.torch_import import export_pillarnext
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES

DATA_SEED = 1
WEIGHT_SEED = 0
STEPS_PER_EPOCH = 10


def random_variables(shapes, seed: int):
    """numpy {params, batch_stats} for a tree of shapes: kernels
    N(0, 1/fan_in) (the ASPP shared kernel N(0, 1), as flax inits it),
    biases N(0, 0.1) (the heatmap's final bias around -2.19), BN scale
    U(0.5, 1.5), statistics mean N(0, 0.1), var U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            shape = v.shape
            if k == "shared_dilated_kernel":
                a = rng.standard_normal(shape)
            elif k == "kernel":
                a = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
            elif k == "scale" or k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif k == "bias":
                a = rng.normal(0.0, 0.1, shape) - (2.19 if "hm" in path and path[-1] == "Conv_1" else 0.0)
            else:  # mean
                a = rng.normal(0.0, 0.1, shape)
            out[k] = a.astype(np.float32)
        return out

    return {kind: walk(shapes[kind], ()) for kind in ("params", "batch_stats")}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# records the gradients in its state and leaves the parameters alone
RECORD = optax.GradientTransformation(
    lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}),
)


class Pair:
    """The narrowed flagship in both packages; JAX's train step is compiled
    once and serves every seed (the shapes do not change)."""

    def __init__(self):
        self.cfg = load_experiment(FLAGSHIP, OVERRIDES)
        self.jmodel = jax_builders.build_model(self.cfg["model"], train=True)
        self.jax_step = jax_ts.make_train_step(self.jmodel, RECORD, None, donate=False)
        self.shapes = None

    def batch(self, seed: int) -> dict:
        return synthetic_batches(self.cfg, 1, 2, 3000, seed=seed, n_objects=4, max_points=4000)[0]

    def variables(self, batch: dict, seed: int, draw: int = 0) -> dict:
        """numpy weights of ``seed``; ``draw`` > 0 scales every parameter by
        1 + 1e-6 N(0, 1) (numpy seed ``draw``)."""
        if self.shapes is None:
            self.shapes = jax.eval_shape(
                self.jmodel.init, jax.random.PRNGKey(0), jnp.asarray(batch["points"][:1]),
                jnp.asarray(batch["points_mask"][:1]),
            )
        v = random_variables(self.shapes, seed)
        if draw:
            rng = np.random.default_rng(draw)
            v["params"] = jax.tree.map(
                lambda a: (a * (1.0 + 1e-6 * rng.standard_normal(a.shape))).astype(np.float32), v["params"]
            )
        return v

    def run_jax(self, variables: dict, batch: dict):
        params, stats = variables["params"], variables["batch_stats"]
        state = jax_ts.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=RECORD.init(params)
        )
        new_state, (scalars, logs) = self.jax_step(state, jax.tree.map(jnp.asarray, batch))
        return new_state, scalars, logs

    def run_port(self, variables: dict, batch: dict):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            model = build_model(self.cfg["model"], device="cpu", train=True)
            load_jax_variables(model, variables)
            opt, _ = build_optimizer(self.cfg, STEPS_PER_EPOCH, list(model.parameters()))
            scalars, logs = train_step(model, opt, batch_to_device(batch, "cpu"))
        finally:
            torch.set_num_threads(threads)
        return model, opt, scalars, logs

    @staticmethod
    def export(model, params, stats) -> dict:
        """A JAX tree as the port's state_dict names."""
        head = model.head
        return export_pillarnext(
            params, stats, num_filters=model.reader.num_filters, layer_nums=model.backbone.layer_nums,
            tasks=head.class_names, common_heads=head.common_heads, num_hm_conv=head.num_hm_conv,
        )


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def steps(pair):
    batch = pair.batch(DATA_SEED)
    variables = pair.variables(batch, WEIGHT_SEED)
    params, stats = variables["params"], variables["batch_stats"]
    new_state, scalars, logs = pair.run_jax(variables, batch)
    grads = new_state.opt_state["g"]
    tx, _ = jax_builders.build_optimizer(pair.cfg, STEPS_PER_EPOCH)
    updates, _ = tx.update(grads, tx.init(params), params)
    jax_out = {
        "loss": float(scalars["loss"]), "logs": _np(logs), "telemetry": _np(scalars["telemetry"]),
        "grads": _np(grads), "params": _np(optax.apply_updates(params, updates)),
        "stats": _np(new_state.batch_stats), "overflow": int(scalars["overflow"]),
    }
    model, opt, pscalars, plogs = pair.run_port(variables, batch)
    return {
        "jax": jax_out, "model": model, "scalars": pscalars, "logs": plogs, "lr0": opt.schedule(0),
        "grads_sd": pair.export(model, jax_out["grads"], stats),
        "after_sd": pair.export(model, jax_out["params"], jax_out["stats"]),
    }


def test_train_step_loss_and_logs_match_jax(steps):
    j, scalars, logs = steps["jax"], steps["scalars"], steps["logs"]
    assert float(scalars["loss"]) == pytest.approx(j["loss"], rel=1e-5)
    assert len(logs) == len(j["logs"]) == 6
    positives = 0
    for got, want in zip(logs, j["logs"]):
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(
                got[key].numpy(), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()), err_msg=key
            )
        positives += int(want["num_positive"])
    assert positives >= 4, "vacuous: too few positive targets"


def _feeds_train_bn(name: str) -> bool:
    """Conv biases directly followed by a train-mode BatchNorm."""
    return name == "head.shared_conv.0.bias" or (
        name.startswith("head.tasks.") and name.endswith(".0.bias")
    )


def test_train_step_gradients_match_jax(steps):
    model, want = steps["model"], steps["grads_sd"]
    checked = 0
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name]
        assert got.shape == ref.shape, name
        if _feeds_train_bn(name):
            w_scale = np.abs(want[name[: -len("bias")] + "weight"]).max()
            assert np.abs(got).max() <= 1e-5 * w_scale, name
            assert np.abs(ref).max() <= 1e-5 * w_scale, name
            continue
        bar = 1e-3 * np.abs(ref).max() + 1e-6
        assert np.abs(got - ref).max() <= bar, (name, float(np.abs(got - ref).max()), bar)
        checked += 1
    assert checked > 100


def test_train_step_bn_statistics_match_jax(steps):
    model, want = steps["model"], steps["after_sd"]
    stats = {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == sum(k.endswith(("running_mean", "running_var")) for k in want) > 100
    for name, buf in stats.items():
        np.testing.assert_allclose(buf.numpy(), want[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_train_step_adamw_parameters_match_jax(steps):
    model, want, grads = steps["model"], steps["after_sd"], steps["grads_sd"]
    lr0 = steps["lr0"]
    n_noise = n_total = 0
    for name, p in model.named_parameters():
        got, ref, g_ref, g_got = p.detach().numpy(), want[name], grads[name], p.grad.numpy()
        noise = (np.abs(g_ref) < 1e-4 * np.abs(g_ref).max()) | (np.sign(g_ref) != np.sign(g_got))
        noise |= _feeds_train_bn(name)
        d = np.abs(got - ref)
        assert np.all(d[~noise] <= 1e-5), (name, float(d[~noise].max()))
        assert np.all(d[noise] <= 2.5 * lr0 + 1e-5), name
        n_noise += int(noise.sum())
        n_total += noise.size
    assert n_noise < 0.05 * n_total, (n_noise, n_total)


def gradient_gap(pair: Pair, seed: int, draw: int) -> tuple[float, float, float]:
    """(largest gradient difference over the bar's scale 1e-3 max|g_jax|
    of its tensor (<= 1 passes), the same as a fraction of max|g_jax|,
    relative loss difference) of one train step at data and weight seed
    ``seed``, weight draw ``draw``."""
    batch = pair.batch(seed)
    variables = pair.variables(batch, seed, draw)
    new_state, scalars, _ = pair.run_jax(variables, batch)
    model, _, pscalars, _ = pair.run_port(variables, batch)
    want = pair.export(model, _np(new_state.opt_state["g"]), variables["batch_stats"])
    ratio = frac = 0.0
    for name, p in model.named_parameters():
        if _feeds_train_bn(name):  # analytically zero: held in the full test
            continue
        ref = want[name]
        d = float(np.abs(p.grad.numpy() - ref).max())
        ratio = max(ratio, d / (1e-3 * np.abs(ref).max() + 1e-6))
        frac = max(frac, d / max(float(np.abs(ref).max()), 1e-30))
    loss = float(scalars["loss"])
    return ratio, frac, abs(float(pscalars["loss"]) - loss) / abs(loss)


NEAR_DRAWS = 16


@pytest.mark.parametrize("seed", range(6))
def test_train_step_gradients_match_jax_near_seed(pair, seed):
    """At data and weight seed ``seed``, the first of the weight draws 0
    (the seed's own), 1, 2, ... within 1e-6 relative whose gradients agree
    at the bar must come within ``NEAR_DRAWS``; the loss agrees at every
    draw tried."""
    tried = []
    for draw in range(NEAR_DRAWS):
        ratio, frac, loss_rel = gradient_gap(pair, seed, draw)
        assert loss_rel <= 1e-5, (draw, loss_rel)
        tried.append(frac)
        if ratio <= 1.0:
            return
    pytest.fail(f"no weight draw near seed {seed} agrees with JAX: {tried}")


def test_train_step_telemetry_matches_jax(steps):
    got = {k: int(v) for k, v in steps["scalars"]["telemetry"].items()}
    want = {k: int(v) for k, v in steps["jax"]["telemetry"].items()}
    assert got == want
    assert int(steps["scalars"]["overflow"]) == steps["jax"]["overflow"] == 0
    assert got["pillar_active"] > 0 and got["stage3_active"] > 0


def sweep(seeds=range(10), draws: int = NEAR_DRAWS) -> None:
    """Print, for each seed, how many of ``draws`` weight draws disagree
    with JAX beyond the gradient bar and the spread of the differences."""
    pair = Pair()
    print("seed  beyond_bar  largest_diff  smallest_diff  largest_loss_rel  (diff: of max|g_jax|)")
    total = 0
    for seed in seeds:
        gaps = [gradient_gap(pair, seed, draw) for draw in range(draws)]
        beyond = sum(r > 1.0 for r, _, _ in gaps)
        total += beyond
        fracs = [f for _, f, _ in gaps]
        print(f"{seed:4d}  {beyond:4d}/{draws}  {max(fracs):12.3e}  {min(fracs):13.3e}  "
              f"{max(l for _, _, l in gaps):16.3e}", flush=True)
    print(f"draws beyond the bar: {total} of {len(seeds) * draws}")


if __name__ == "__main__":
    sweep()
