"""The port's data-parallel training and evaluation on the CPU: 2 ranks
over gloo against JAX's one-device step and against the port alone.

One group of 2 ranks (tests/torch_dist_worker.py, torch on one thread in
each, killed after ``TIMEOUT_S``) is started once for the module and runs
every case, beside one more process of the same module, in no group, for
the port's 1-process references; meanwhile this process runs JAX's
``make_train_step`` and ``val_epoch``.  At the narrowed flagship
of tests/test_torch_port_train.py (f32, B = 2, its flip-free data and
weight seeds):

- (a) the 2-rank step (1 sample a rank) against JAX's 1-device step on the
  same global batch, at that file's data and weight seeds (the seed's own
  weight draw), with that file's bars (loss 1e-5 relative, per-task logs
  1e-4, gradients 1e-3 of each tensor's largest, BN statistics 1e-5,
  AdamW parameters 1e-5 or 2.5 lr0 where a gradient is rounding noise);
  both ranks end with the same parameters.  Each rank records every
  ReLU input (tests/torch_dist_worker.recorded_relus): the two inputs
  that fall on the other side of 0 from JAX's lie within their call's
  rounding noise (the port's 1-process step flips the same two), and
  with JAX's ReLU masks (a second pair of ranks) the gradients, BN
  statistics and AdamW parameters meet JAX's bars.  The per-task logs do
  not meet JAX's bar at this draw, with JAX's masks or without (task 3's
  loc_loss_elem[1] 4.0-4.1e-5 off, against 3.3e-5): the 2-rank reduction
  order (batch-1 convolutions and GEMMs, statistics summed across ranks)
  rounds differently, not a flip.  So the ranks' logs meet that bar
  against the port's 1-process step, which meets it against JAX's, and
  at every depth the ranks' ReLU inputs lie no further from the 1-process
  step's than JAX's do (run as a script, this module prints the log
  gaps: 2 ranks against JAX, against 1 process, 1 process against JAX,
  and JAX on 2 devices against 1);
- (b) ``BatchNorm(sync=True)`` alone, masked (37 and 5 valid rows; 0 and
  23) and unmasked (NCHW): forward, input, weight and bias gradients and
  running statistics equal one BatchNorm over the concatenated rows within
  1e-6;
- (c) the loss normalisers: one rank's sample holds no object; the 2-rank
  loss, logs and gradients equal the port's 1-process step on the batch;
- (d) an undersized ``stage_capacity_frac`` on rank 0 only: both ranks
  raise the overflow, neither hangs, no checkpoint is written;
- (e) ``accum_steps = 2``: the port's 1-process step against JAX's
  accumulated step on the B = 2 batch at the seed's draw: the loss and
  the per-task logs at (a)'s bars, and the one ReLU input on the other
  side of 0 from JAX's lies within its call's rounding noise; with JAX's
  masks the gradients (``check_flips``; the port's own masks miss their
  bar 3.5x), the BN statistics, the AdamW parameters and the logs meet
  (a)'s bars; 2 ranks x accum 2 against the port's 1-process accum-2 step on
  the batch regrouped as train_state.train_step states (micro-batch i =
  chunk i of every rank);
- (f) ``cli.train`` under 2 ranks on ``make_mini_nuscenes(n_samples=5)``
  at B = 2 for one epoch: one step a rank (half the 1-process run's), one
  checkpoint, rank 0 scores all 5 val tokens once, rank 1 returns None;
  at 1 rank the port's val loader keeps all 5 too, where JAX's val_epoch
  on the same tree drops the last sample and its scorer raises (a defect
  of the reference: its val loader drops the last batch);
- each rank's train batches are the samples JAX's process of that rank
  takes;
- a group that cannot form raises: ``WORLD_SIZE > 1`` without one (the
  Trainer), NCCL with one card for two local ranks.
"""

from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pillarnext_tpu.data.loader import DataLoader as JaxDataLoader
from pillarnext_tpu.data.loader import build_dataloader as jax_build_dataloader
from pillarnext_tpu.parallel import mesh as mesh_lib
from pillarnext_tpu.train import train_state as jax_ts
from pillarnext_tpu.train.trainer import Trainer as JaxTrainer
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils.config import load_experiment as jax_load_experiment
from pillarnext_tpu.utils.torch_import import import_pillarnext
from pillarnext_tpu_torch.data.loader import DataLoader
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.train.train_state import split_batch, train_step
from pillarnext_tpu_torch.train.trainer import batch_to_device
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests import torch_dist_worker as worker
from tests.test_cli_e2e import _overrides as cli_overrides
from tests.test_data_pipeline import make_mini_nuscenes
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES
from tests.test_torch_port_train import DATA_SEED, RECORD, STEPS_PER_EPOCH, WEIGHT_SEED, Pair, _feeds_train_bn
from tests.test_torch_port_voxel_train import ReluTrace, as_port, check_flips, relu_flips

TIMEOUT_S = 120
MINI_SAMPLES = 5
BN_CASES = ("masked", "masked_empty_rank", "unmasked")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here, as in the ranks: the suite runs several
    test processes on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def regrouped(batch: dict, world: int, accum: int) -> dict:
    """The global batch in the order of its micro-batches: rank r holds
    samples [r b, (r + 1) b) and micro-batch i is chunk i of every rank."""
    b = int(batch["points"].shape[0]) // world
    chunk = b // accum
    order = [r * b + i * chunk + j for i in range(accum) for r in range(world) for j in range(chunk)]

    def take(v):
        return [t[order] for t in v] if isinstance(v, list) else v[order]

    return {k: take(v) for k, v in batch.items()}


def without_objects(batch: dict, sample: int) -> dict:
    """``batch`` with every target of ``sample`` erased: no object, no
    heatmap peak."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            v = [t.copy() for t in v]
            for t in v:
                t[sample] = 0
        out[k] = v
    return out


def jax_train_state(variables: dict):
    params = variables["params"]
    return jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
                             opt_state=RECORD.init(params))


def adamw_first_step(cfg):
    """build_optimizer's clip + AdamW, first update from zero state, as one
    jitted function (grads, params) -> params: its eager form takes ~11 s
    to dispatch the first time on the CPU."""
    tx, _ = jax_builders.build_optimizer(cfg, STEPS_PER_EPOCH)
    return jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))


def jax_step(variables: dict, batch: dict, step, update) -> dict:
    """JAX's step (recording the gradients), then ``update`` (AdamW)."""
    new_state, (scalars, logs) = step(jax_train_state(variables), jax.tree.map(jnp.asarray, batch))
    grads = jax.tree.map(np.asarray, new_state.opt_state["g"])
    return {"loss": float(scalars["loss"]), "logs": jax.tree.map(np.asarray, logs), "grads": grads,
            "params": jax.tree.map(np.asarray, update(grads, variables["params"])),
            "stats": jax.tree.map(np.asarray, new_state.batch_stats)}


def jax_val_raises(cfg_overrides, root, tmp_path):
    """JAX's Trainer.val_epoch on the mini tree at B = 2 (weights drawn by
    the port and imported, which spares JAX's model.init): the error its
    scorer raises."""
    cfg = jax_load_experiment(FLAGSHIP, cfg_overrides)
    model, head, backbone = cfg["model"], cfg["model"]["head"], cfg["model"]["backbone"]
    drawn = build_model(model, device="cpu", generator=torch.Generator().manual_seed(0))
    params, stats = import_pillarnext(
        {k: v.numpy() for k, v in drawn.state_dict().items()}, num_filters=model["reader"]["num_filters"],
        layer_nums=backbone["layer_nums"], ds_num_filters=backbone["ds_num_filters"],
        num_input_features=backbone["num_input_features"], out_channels=backbone.get("out_channels", 256),
        tasks=head["tasks"], common_heads=head["common_heads"])
    jmodel = jax_builders.build_model(model)
    loader = jax_build_dataloader(jax_builders.build_dataset(cfg["data"]["val_dataset"]), 2,
                                  int(cfg["dataloader"]["max_points"]), shuffle=False)
    tx, _ = jax_ts.make_optimizer(max_lr=1e-3, total_steps=4)
    tr = JaxTrainer(jmodel, val_dataloader=loader, optimizer=tx, work_dir=str(tmp_path),
                    mesh=mesh_lib.make_mesh(jax.devices()[:1]))
    tr.state = jax_ts.TrainState(step=0, params=params, batch_stats=stats, opt_state=None)
    tr._eval_step = jax_ts.make_eval_step(jmodel, tr.mesh)
    with pytest.raises(AssertionError) as err:
        tr.val_epoch()
    return str(err.value)


class AccumPair(Pair):
    """``pair``'s narrowed flagship with ``accum_steps = 2`` in both
    packages; ``jax_step`` is JAX's accumulated step, compiled."""

    def __init__(self, pair: Pair, jax_step):
        self.__dict__.update(pair.__dict__)
        self.jax_step = jax_step

    def run_port(self, variables: dict, batch: dict):
        model = build_model(self.cfg["model"], device="cpu", train=True)
        load_jax_variables(model, variables)
        opt, _ = build_optimizer(self.cfg, STEPS_PER_EPOCH, list(model.parameters()))
        scalars, logs = train_step(model, opt, batch_to_device(batch, "cpu"), accum_steps=2)
        return model, opt, scalars, logs


class AccumTrace(ReluTrace):
    """``ReluTrace`` of the accumulated step: JAX's ReLU inputs are its
    micro-batches' forwards (contiguous halves of the batch, as both
    packages cut them), in order."""

    def jax_inputs(self, variables: dict, batch: dict) -> list:
        return [x for micro in split_batch(batch, 2) for x in ReluTrace.jax_inputs(self, variables, micro)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the 2 ranks and the 1-process reference process on their
    cases, run JAX here meanwhile; then the port's 1-process step and
    JAX's ReLU inputs here, 2 more ranks with JAX's ReLU masks and, here
    meanwhile, the accumulated step's ReLU flips; then collect every
    process's outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    pair = Pair()
    cfg = pair.cfg
    batch = pair.batch(DATA_SEED)
    variables = pair.variables(batch, WEIGHT_SEED)
    empty_rank = without_objects(pair.batch(DATA_SEED + 1), 1)
    batch4 = synthetic_batches(cfg, 1, 4, 3000, seed=DATA_SEED, n_objects=4, max_points=4000)[0]
    bn = worker.bn_inputs()

    overflow_overrides = [o for o in OVERRIDES if o.split("=")[0] not in (
        "model.reader.pc_range", "model.reader.voxel_size", "model.reader.pillar_capacity")]
    overflow_overrides += ["model.reader.pc_range=[-16.0,-16.0,-5.0,16.0,16.0,3.0]",
                           "model.reader.voxel_size=[0.125,0.125,8.0]", "model.reader.pillar_capacity=16384"]
    ample = load_experiment(FLAGSHIP, overflow_overrides)
    undersized = load_experiment(FLAGSHIP, overflow_overrides + ["model.backbone.stage_capacity_frac=[1.0,0.01,0.01,0.01]"])
    overflow_batch = synthetic_batches(ample, 1, 2, 20000, seed=0, n_objects=4, max_points=20000)[0]

    root = tmp / "nusc"
    make_mini_nuscenes(root, n_samples=MINI_SAMPLES, n_points=700)
    overrides = cli_overrides(root)
    common = ["--config", str(FLAGSHIP), "--device", "cpu"]

    step = {"kind": "step", "cfg": cfg, "variables": variables, "steps_per_epoch": STEPS_PER_EPOCH}
    two_ranks = {"device": "cpu", "timeout_s": 60, "cases": {
        **{f"bn_{name}": case for name, case in bn.items()},
        "jax_batch": dict(step, batch=batch, relu=True),
        "empty_rank": dict(step, batch=empty_rank),
        "accum": dict(step, batch=batch4, accum_steps=2),
        "overflow": {"kind": "overflow", "cfgs": [undersized, ample], "batch": overflow_batch},
        "cli": {"kind": "cli", "argv": [*common, "--dist-backend", "gloo", "--work-dir", str(tmp / "work2"),
                                        *overrides]},
    }}
    # the port's 1-process references, in a process of their own
    one_process = {"device": "cpu", "cases": {
        "empty_rank": dict(step, batch=empty_rank),
        "accum_one_process": dict(step, batch=regrouped(batch4, 2, 2), accum_steps=2),
        "cli": {"kind": "cli", "argv": [*common, "--work-dir", str(tmp / "work1"), *overrides]},
    }}
    procs = worker.spawn(two_ranks, tmp / "ranks"), worker.spawn(one_process, tmp / "one", world=1, group=False)
    try:
        # JAX lowers and compiles its two train steps and the AdamW update,
        # and runs its val_epoch, in threads of this process meanwhile
        state0, params = jax_train_state(variables), variables["params"]
        jbatch = jax.tree.map(jnp.asarray, batch)
        accum_step = jax_ts.make_train_step(pair.jmodel, RECORD, None, donate=False, accum_steps=2)
        with ThreadPoolExecutor(4) as pool:
            compiled = [pool.submit(lambda f=f, args=args: f.lower(*args).compile())
                        for f, args in ((pair.jax_step, (state0, jbatch)), (accum_step, (state0, jbatch)),
                                        (adamw_first_step(cfg), (params, params)))]
            jax_val = pool.submit(jax_val_raises, overrides, root, tmp / "jax")
            refs = {f"bn_{name}": worker.bn_reference(case) for name, case in bn.items()}
            plain, accum, update = (c.result() for c in compiled)
            refs["jax"] = jax_step(variables, batch, plain, update)
            refs["accum_jax"] = jax_step(variables, batch, accum, update)
            refs["jax_val_error"] = jax_val.result()
        # ReLU traces once nothing else traces JAX (they replace flax's relu
        # while JAX's forward is traced): the port's 1-process step and
        # JAX's ReLU inputs, then 2 ranks with JAX's masks, and meanwhile
        # the accumulated step's flips
        one_step = worker.step_case(dict(step, batch=batch, relu=True), 0, 1, "cpu")
        refs["jax_relu"] = [as_port(a, b, []) for a, b in
                            zip(ReluTrace(pair).jax_inputs(variables, batch), one_step["relu_inputs"])]
        pinned = [(a > 0, None if v is None else int(v.sum())) for a, v in zip(refs["jax_relu"],
                                                                                  one_step["relu_valid"])]
        procs += (worker.spawn({"device": "cpu", "timeout_s": 60, "cases": {
            "pinned": dict(step, batch=batch, relu=True, pinned=pinned)}}, tmp / "pinned"),)
        refs["accum_flips"] = relu_flips(AccumTrace(AccumPair(pair, accum)), DATA_SEED, WEIGHT_SEED)
    finally:
        ranks = worker.collect(procs[0], tmp / "ranks", TIMEOUT_S)
        one, = worker.collect(procs[1], tmp / "one", TIMEOUT_S)
        pinned_ranks = worker.collect(procs[2], tmp / "pinned", TIMEOUT_S) if len(procs) > 2 else None
    for r, out in enumerate([*ranks, one, *pinned_ranks]):
        for name, res in out.items():
            assert not (isinstance(res, dict) and "error" in res), f"process {r}, case {name}:\n{res['error']}"
    assert [(out["rank"], out["world_size"]) for out in (*ranks, one)] == [(0, 2), (1, 2), (0, 1)]
    model = build_model(cfg["model"], device="cpu", train=True)
    lr0 = build_optimizer(cfg, STEPS_PER_EPOCH, list(model.parameters()))[0].schedule(0)
    return {"pair": pair, "tmp": tmp, "refs": refs, "ranks": ranks, "one": one, "one_step": one_step,
            "pinned": [out["pinned"] for out in pinned_ranks], "variables": variables, "model": model, "lr0": lr0}


def check_logs(logs: list, want_logs: list, accum_steps: int = 1) -> None:
    """tests/test_torch_port_train.py's bar on the per-task logs (the logs
    of an accumulated step are means over its micro-batches)."""
    assert len(logs) == len(want_logs) == 6
    positives = 0
    for log, want in zip(logs, want_logs):
        assert set(log) == set(want)
        for key, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(log[key]), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=key)
        positives += int(want["num_positive"])
    assert positives * accum_steps >= 4, "vacuous: too few positive targets"


def check_state(got: dict, jax_out: dict, pair: Pair, model, stats0: dict, lr0: float) -> None:
    """tests/test_torch_port_train.py's bars on the gradients, the AdamW
    parameters and the BN statistics."""
    grads = pair.export(model, jax_out["grads"], stats0)
    after = pair.export(model, jax_out["params"], jax_out["stats"])
    checked = n_noise = n_total = 0
    for name, g in got["grads"].items():
        g, ref = np.asarray(g), grads[name]
        if _feeds_train_bn(name):
            w_scale = np.abs(grads[name[: -len("bias")] + "weight"]).max()
            assert np.abs(g).max() <= 1e-5 * w_scale and np.abs(ref).max() <= 1e-5 * w_scale, name
        else:
            bar = 1e-3 * np.abs(ref).max() + 1e-6
            assert np.abs(g - ref).max() <= bar, (name, float(np.abs(g - ref).max()), bar)
            checked += 1
        noise = (np.abs(ref) < 1e-4 * np.abs(ref).max()) | (np.sign(ref) != np.sign(g)) | _feeds_train_bn(name)
        d = np.abs(np.asarray(got["state"][name]) - after[name])
        assert np.all(d[~noise] <= 1e-5), (name, float(d[~noise].max()))
        assert np.all(d[noise] <= 2.5 * lr0 + 1e-5), name
        n_noise += int(noise.sum())
        n_total += noise.size
    assert checked > 100
    assert n_noise < 0.05 * n_total, (n_noise, n_total)
    stats = {k: v for k, v in got["state"].items() if k.endswith(("running_mean", "running_var"))}
    assert len(stats) > 100
    for name, buf in stats.items():
        np.testing.assert_allclose(np.asarray(buf), after[name], rtol=1e-5, atol=1e-5, err_msg=name)


def rank_relu_gaps(run, r: int) -> tuple[list, float, float]:
    """Rank ``r``'s ReLU inputs of the 2-rank step against JAX's and the
    port's 1-process step's, each cut to the rank's share
    (``worker.rank_share``), over the rank's valid rows: each call's
    inputs on the other side of 0 from JAX's as (call, count, largest
    |input|, the call's largest |JAX - rank| where the signs agree); and
    the largest |rank - 1-process| and |JAX - 1-process| over all calls,
    each relative to its call's largest |1-process input|."""
    got = run["ranks"][r]["jax_batch"]
    one = run["one_step"]
    flips, rank_gap, jax_gap = [], 0.0, 0.0
    for call, (b, valid) in enumerate(zip(got["relu_inputs"], got["relu_valid"])):
        n_global = None if one["relu_valid"][call] is None else int(one["relu_valid"][call].sum())
        a, p = (worker.rank_share(x[call], n_global, valid, r, 2)
                for x in (run["refs"]["jax_relu"], one["relu_inputs"]))
        rows = np.ones(b.shape[0], bool) if valid is None else valid
        a, b, p = a[rows], b[rows], p[rows]
        flip = (a > 0) != (b > 0)
        if flip.any():
            flips.append((call, int(flip.sum()), float(np.maximum(np.abs(a), np.abs(b))[flip].max()),
                          float(np.abs(a - b)[~flip].max())))
        scale = float(np.abs(p).max())
        rank_gap = max(rank_gap, float(np.abs(b - p).max()) / scale)
        jax_gap = max(jax_gap, float(np.abs(a - p).max()) / scale)
    return flips, rank_gap, jax_gap


def check_equal_steps(got: dict, want: dict, rtol: float = 1e-5) -> None:
    """Two steps of the port on the same global batch: loss, logs,
    gradients (1e-3 of each tensor's largest, as against JAX) and BN
    statistics."""
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=rtol)
    for log, ref in zip(got["logs"], want["logs"]):
        for key, w in ref.items():
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(log[key]), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=key)
    for name, g in got["grads"].items():
        g, ref = np.asarray(g), np.asarray(want["grads"][name])
        if not _feeds_train_bn(name):
            assert np.abs(g - ref).max() <= 1e-3 * np.abs(ref).max() + 1e-6, name
    for name, buf in got["state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(np.asarray(buf), np.asarray(want["state"][name]), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_two_rank_step_matches_jax_one_device(run):
    """(a): 1 sample a rank against JAX's 1-device step on both, at the
    seed's own weight draw: the loss at its bar; every ReLU input on the
    other side of 0 from JAX's within its call's rounding noise; with
    JAX's masks the gradients, AdamW parameters and BN statistics at their
    bars; the logs at their bar against the port's 1-process step, whose
    logs meet it against JAX's; and the ranks' ReLU inputs no further from
    the 1-process step's than JAX's are."""
    jax_out, pair, model, lr0 = run["refs"]["jax"], run["pair"], run["model"], run["lr0"]
    stats0 = run["variables"]["batch_stats"]
    one = run["one_step"]
    check_logs(one["logs"], jax_out["logs"])
    for r, (out, pinned) in enumerate(zip(run["ranks"], run["pinned"])):
        got = out["jax_batch"]
        assert float(got["loss"]) == pytest.approx(jax_out["loss"], rel=1e-5)
        flips, rank_gap, jax_gap = rank_relu_gaps(run, r)
        for call, count, size, noise in flips:
            assert size <= noise, (r, call, count, size, noise)
        assert rank_gap <= jax_gap, (r, rank_gap, jax_gap)
        check_state(pinned, jax_out, pair, model, stats0, lr0)
        check_logs(got["logs"], one["logs"])


def test_ranks_end_the_step_with_the_same_state(run):
    a, b = (out["jax_batch"] for out in run["ranks"])
    assert float(a["loss"]) == float(b["loss"]) and float(a["grad_norm"]) == float(b["grad_norm"])
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


@pytest.mark.parametrize("case", BN_CASES)
def test_synced_batchnorm_matches_one_process(run, case):
    """(b): forward, input / weight / bias gradients (each rank's share
    summed) and running statistics within 1e-6."""
    ref = run["refs"][f"bn_{case}"]
    outs = [out[f"bn_{case}"] for out in run["ranks"]]
    for r, out in enumerate(outs):
        torch.testing.assert_close(out["y"], ref["y"][r], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out["x_grad"], ref["x_grad"][r], rtol=1e-6, atol=1e-6)
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(out[k], ref[k], rtol=1e-6, atol=1e-6)
    for k in ("weight_grad", "bias_grad"):
        torch.testing.assert_close(outs[0][k] + outs[1][k], ref[k], rtol=1e-6, atol=1e-6)


def test_global_normalisers_with_an_empty_rank(run):
    """(c): rank 1's sample holds no object; its loss is its negatives
    over the global count, and the 2-rank step is the 1-process step."""
    want = run["one"]["empty_rank"]
    assert sum(int(log["num_positive"]) for log in want["logs"]) > 0
    for out in run["ranks"]:
        check_equal_steps(out["empty_rank"], want)


def test_overflow_on_one_rank_raises_on_both(run):
    """(d): rank 0's undersized stage tables overflow; rank 1's do not,
    and it raises all the same instead of waiting for rank 0."""
    for out in run["ranks"]:
        res = out["overflow"]
        assert res["raised"] is not None and "stage1_overflow" in res["raised"], res
        assert "the largest over 2 ranks" in res["raised"]
        assert res["checkpoints"] == []


def test_accum_steps_matches_jax(run):
    """(e): accum_steps = 2 at one process against JAX's accumulated step
    on the same B = 2 batch (micro-batches of one sample), at the seed's
    own weight draw: the loss and the per-task logs (means over the
    micro-batches) at their bars; every gradient gap is a ReLU flip within
    its call's rounding noise (``check_flips``); and with JAX's masks the
    gradients, the AdamW parameters and the BN statistics (each
    micro-batch updates them) at their bars, and the logs again."""
    r, jax_out = run["refs"]["accum_flips"], run["refs"]["accum_jax"]
    assert r["loss_rel"] <= 1e-5, r["loss_rel"]
    check_logs(r["logs"], jax_out["logs"], accum_steps=2)
    check_flips(r)
    if not r["flips"]:
        assert r["free"] <= 1.0, r
    model, logs = r["pinned_step"]
    got = {"grads": {n: p.grad for n, p in model.named_parameters()}, "state": model.state_dict()}
    check_state(got, jax_out, run["pair"], run["model"], run["variables"]["batch_stats"], run["lr0"])
    check_logs(logs, jax_out["logs"], accum_steps=2)


def test_two_ranks_with_accum_match_one_process(run):
    """(e): 2 ranks x accum 2 (2 samples a rank) against one process's
    accum-2 step on the batch regrouped by micro-batch."""
    want = run["one"]["accum_one_process"]
    for out in run["ranks"]:
        check_equal_steps(out["accum"], want)


def test_cli_two_ranks_score_every_val_token_once(run):
    """(f): under 2 ranks each takes 1 of the 1-process run's 2 steps;
    rank 0 writes the one checkpoint and scores all 5 val tokens once
    (ranks 0 and 1 hold 3 each, one of them the pad)."""
    one, (r0, r1) = run["one"]["cli"], (out["cli"] for out in run["ranks"])
    tokens = [f"token_{i}" for i in range(MINI_SAMPLES)]
    assert one["step"] == 2 and r0["step"] == r1["step"] == 1 and r0["steps_per_epoch"] == 1
    assert r0["tokens"] == tokens and len(r1["tokens"]) == 3
    assert r0["val_results"][0] is not None and r1["val_results"] == [None]
    work = run["tmp"] / "work2"
    assert sorted(p.name for p in work.rglob("*.pt")) == ["epoch_1.pt"]
    entries = json.loads((work / "results/epoch_1/results_nusc.json").read_text())["results"]
    assert sorted(entries) == tokens


def test_val_keeps_every_sample_where_jax_drops_some(run):
    """The port's val loader keeps the short last batch: 5 samples at B = 2
    score 5 tokens at one rank (and at two, above); JAX's val loader
    drops the fifth sample, so its scorer raises on the same tree."""
    one = run["one"]["cli"]
    assert one["tokens"] == [f"token_{i}" for i in range(MINI_SAMPLES)] and one["val_batches"] == 3
    assert "got 4 detection entries for 5 dataset samples" in run["refs"]["jax_val_error"]


@pytest.mark.parametrize("world", [2, 3])
def test_rank_batches_are_jax_process_batches(world):
    """Rank r of W draws exactly the samples JAX's process r of W draws,
    each epoch; the val loader keeps every sample across the ranks."""
    dataset = list(range(11))
    for epoch in range(2):
        for r in range(world):
            port = DataLoader(dataset, 2, 100, shuffle=True, seed=3, num_shards=world, shard_index=r)
            ref = JaxDataLoader(dataset, 2, 100, shuffle=True, seed=3, num_shards=world, shard_index=r)
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(port._make_batches()) == list(ref._make_batches())
            assert len(port) == len(ref) == math.ceil(11 / world) // 2
    kept = set()
    for r in range(world):
        val = DataLoader(dataset, 2, 100, shuffle=False, num_shards=world, shard_index=r, drop_last=False)
        kept.update(i for b in val._make_batches() for i in b)
        assert len(val) == math.ceil(math.ceil(11 / world) / 2)
    assert kept == set(dataset)


def test_a_group_that_cannot_form_raises(monkeypatch):
    """No rank trains its shard alone: ``WORLD_SIZE > 1`` without a group
    makes the Trainer raise, and NCCL with one explicit card for two local
    ranks raises before any group forms (the card is faked: the check
    needs none)."""
    from pillarnext_tpu_torch import parallel
    from pillarnext_tpu_torch.train.trainer import Trainer
    from pillarnext_tpu_torch.utils import builders

    cfg = load_experiment(FLAGSHIP, OVERRIDES)
    model = build_model(cfg["model"], device="cpu", train=True)
    opt, _ = build_optimizer(cfg, 1, list(model.parameters()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        Trainer(model, [], opt, device="cpu")
    for k, v in dict(RANK="0", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(builders, "resolve_device", torch.device)
    with pytest.raises(RuntimeError, match="NCCL refuses"):
        parallel.init_from_env("nccl", "cuda:0")
    assert not parallel.is_distributed()


def log_bar_ratio(logs: list, want_logs: list) -> float:
    """The largest per-task log gap over ``check_logs``' bar (<= 1 passes)."""
    ratio = 0.0
    for log, want in zip(logs, want_logs):
        for key, w in want.items():
            w = np.asarray(w, np.float64)
            bar = 1e-4 * np.abs(w) + 1e-5 * np.abs(w).max()
            gap = np.abs(np.asarray(log[key], np.float64) - w)
            ratio = max(ratio, float((gap / np.maximum(bar, 1e-30)).max()))
    return ratio


def log_gap_readings() -> None:
    """Print, at (a)'s seed draw, ``log_bar_ratio`` between the 2-rank
    step and JAX's 1-device step, the 2-rank and the port's 1-process
    step, that step and JAX's, and JAX's 2-device step (the batch sharded
    over 2 CPU devices) and its 1-device step."""
    import tempfile
    from pathlib import Path

    torch.set_num_threads(1)
    pair = Pair()
    batch = pair.batch(DATA_SEED)
    variables = pair.variables(batch, WEIGHT_SEED)
    step = dict(kind="step", cfg=pair.cfg, variables=variables, steps_per_epoch=STEPS_PER_EPOCH, batch=batch)
    with tempfile.TemporaryDirectory() as tmp:
        procs = worker.spawn({"device": "cpu", "timeout_s": 60, "cases": {"step": step}}, Path(tmp))
        one = worker.step_case(step, 0, 1, "cpu")
        jax_one = pair.jax_step(jax_train_state(variables), jax.tree.map(jnp.asarray, batch))[1][1]
        mesh = mesh_lib.make_mesh(jax.devices()[:2])
        jax_two = pair.jax_step(jax.device_put(jax_train_state(variables), mesh_lib.replicated(mesh)),
                                mesh_lib.shard_batch(batch, mesh))[1][1]
        ranks = [out["step"]["logs"] for out in worker.collect(procs, Path(tmp), TIMEOUT_S)]
    for name, ratio in (("2 ranks vs JAX", max(log_bar_ratio(r, jax_one) for r in ranks)),
                        ("2 ranks vs 1 process", max(log_bar_ratio(r, one["logs"]) for r in ranks)),
                        ("1 process vs JAX", log_bar_ratio(one["logs"], jax_one)),
                        ("JAX 2 devices vs 1", log_bar_ratio(jax_two, jax_one))):
        print(f"{name:22s} {ratio:.4f} of the log bar")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 python -m tests.test_torch_port_distributed
    log_gap_readings()
