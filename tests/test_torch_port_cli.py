"""The port's ``val_epoch`` and CLIs on the CPU.

- ``Trainer.val_epoch`` against JAX's on the same weights (carried to
  JAX by ``import_pillarnext`` and back by ``load_jax_variables``, which
  runs ``export_pillarnext``) and batch, at tests/test_torch_port_e2e.py's
  narrowed flagship (f32): the detections of each token meet the pillar
  bars (tools/flagship_parity.py:270: 1e-2 box, 1e-3 score);
- the overflow repair: an undersized ``pillar_capacity`` repairs to the
  detections of a model built with an ample one; ``eval_overflow=raise``
  raises;
- a checkpoint in the reference's layout (``state_dict`` key, ``module.``
  prefixes, spconv's (O, kH, kW, I) sparse kernels,
  ``num_batches_tracked``), written from JAX's ``export_pillarnext`` of
  the same weights: JAX's ``load_torch_state_dict`` + ``import_pillarnext``
  give back JAX's trees, the port's ``cli.import_checkpoint`` gives a
  checkpoint whose ``val_epoch`` detections meet the pillar bars against
  JAX's, with the default head and with ``merge_branches`` /
  ``merge_tasks`` (whose trees JAX's importer builds from the same file);
  a missing, stray or misshapen tensor raises;
- ``cli.train.main`` then ``cli.test.main`` in-process (``--device cpu``)
  on the mini nuScenes tree at tests/test_cli_e2e.py's overrides (64 x 64
  grid): the checkpoint and the scorer's files, test's detections equal to
  train's, ``--load-from``, ``--resume-from`` and the automatic resume;
  ``WORLD_SIZE > 1`` without the rest of a rendezvous raises, and so does
  ``--dist-backend nccl`` on the CPU (the distributed runs themselves are
  in tests/test_torch_port_distributed.py).
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from pillarnext_tpu.parallel import mesh as mesh_lib
from pillarnext_tpu.train import train_state as jax_ts
from pillarnext_tpu.train.trainer import Trainer as JaxTrainer
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils import torch_import as jax_import
from pillarnext_tpu.utils.torch_import import import_pillarnext
from pillarnext_tpu.utils.synth import lidar_like_points
from pillarnext_tpu_torch.cli import import_checkpoint as cli_import
from pillarnext_tpu_torch.cli import test as cli_test
from pillarnext_tpu_torch.cli import train as cli_train
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.train import checkpoint as ckpt_lib
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils.builders import build_eval_model_scaled, build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.torch_import import load_torch_state_dict, state_dict_from_reference
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests.test_cli_e2e import _overrides as cli_overrides
from tests.test_data_pipeline import make_mini_nuscenes
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES, PC, randomized_variables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes on
    the machine's cores, and each torch pool of all cores in each of them
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StubLoader:
    """``batches`` times one val batch; its ``dataset.evaluation`` keeps the
    detections."""

    def __init__(self, batch, batches=1):
        self.batch, self.batches = batch, batches
        self.dataset = self
        self.results = None

    def __len__(self):
        return self.batches

    def __iter__(self):
        for _ in range(self.batches):
            yield dict(self.batch)

    def evaluation(self, results, output_dir):
        self.results = results
        return {"tokens": len(results)}


def val_batch():
    pts, mask = lidar_like_points(2, 3000, PC, seed=0)
    return {"token": ["frame_a", "frame_b"], "points": pts, "points_mask": mask}


@pytest.fixture(scope="module")
def jax_val(tmp_path_factory):
    """JAX's val_epoch on the narrowed f32 flagship with random weights and
    BN statistics: (cfg, variables, detections by token).  The weights are
    drawn by the port's initialiser (lecun normal, as JAX's) and carried to
    JAX by its own ``import_pillarnext``, which spares JAX's model.init
    (~18 s on the CPU); the Trainer gets them and its compiled predict as
    its ``init_state`` would give them."""
    cfg = load_experiment(FLAGSHIP, OVERRIDES)
    model, head, backbone = cfg["model"], cfg["model"]["head"], cfg["model"]["backbone"]
    drawn = build_model(model, device="cpu", generator=torch.Generator().manual_seed(0))
    params, stats = import_pillarnext(
        {k: v.numpy() for k, v in drawn.state_dict().items()}, num_filters=model["reader"]["num_filters"],
        layer_nums=backbone["layer_nums"], ds_num_filters=backbone["ds_num_filters"],
        num_input_features=backbone["num_input_features"], out_channels=backbone["out_channels"],
        tasks=head["tasks"], common_heads=head["common_heads"])
    variables = randomized_variables({"params": params, "batch_stats": stats})
    jmodel = jax_builders.build_model(model)
    tx, _ = jax_ts.make_optimizer(max_lr=1e-3, total_steps=4)
    loader = StubLoader(val_batch())
    tr = JaxTrainer(jmodel, val_dataloader=loader, optimizer=tx, work_dir=str(tmp_path_factory.mktemp("jax")),
                    mesh=mesh_lib.make_mesh(jax.devices()[:1]))
    tr.state = jax_ts.TrainState(step=0, params=variables["params"], batch_stats=variables["batch_stats"],
                                 opt_state=None)
    tr._eval_step = jax_ts.make_eval_step(jmodel, tr.mesh)
    tr.val_epoch()
    return cfg, variables, loader.results


def port_trainer(cfg, model, loader, work_dir, **kw):
    opt, sched = build_optimizer(cfg, 1, list(model.parameters()))
    return Trainer(model, optimizer=opt, lr_schedule=sched, device="cpu", val_dataloader=loader,
                   work_dir=work_dir, **kw)


def test_val_epoch_matches_jax(jax_val, tmp_path):
    cfg, variables, ref = jax_val
    model = load_jax_variables(build_model(cfg["model"], device="cpu", train=True), variables)
    loader = StubLoader(val_batch())
    trainer = port_trainer(cfg, model, loader, tmp_path)
    assert trainer.val_epoch() == {"tokens": 2}
    assert model.training  # val_epoch put it back
    got = loader.results
    assert got.keys() == ref.keys() == {"frame_a", "frame_b"}
    assert sum(len(r["scores"]) for r in ref.values()) >= 8, "vacuous parity: too few detections"
    for token in ref:
        o, r = got[token], ref[token]
        assert len(o["scores"]) == len(r["scores"]), token
        o_ord = np.lexsort((-o["scores"], o["label_preds"]))
        r_ord = np.lexsort((-r["scores"], r["label_preds"]))
        np.testing.assert_array_equal(o["label_preds"][o_ord], r["label_preds"][r_ord])
        np.testing.assert_allclose(o["scores"][o_ord], r["scores"][r_ord], atol=1e-3, rtol=0)
        np.testing.assert_allclose(o["box3d_lidar"][o_ord], r["box3d_lidar"][r_ord], atol=1e-2, rtol=0)
    assert trainer.last_detections is got
    assert len(trainer.val_timing["batch_s"]) == 1 and trainer.val_timing["scorer_s"] >= 0


def test_val_epoch_repairs_overflow_exactly_or_raises(jax_val, tmp_path, caplog):
    """A 256-pillar table overflows on these 3000-point frames (~334
    occupied pillars each): the batch is recomputed at 2x (rounded up to
    4096, the whole 64 x 64 grid) and gives the detections of a model
    built with 16x the capacity from the start."""
    cfg, variables, _ = jax_val
    small = dict(cfg["model"], reader=dict(cfg["model"]["reader"], pillar_capacity=256))
    model = load_jax_variables(build_model(small, device="cpu"), variables)
    loader = StubLoader(val_batch())
    trainer = port_trainer(cfg, model, loader, tmp_path / "a", eval_model_cfg=small)
    trainer.val_epoch()
    assert trainer.eval_repairs == 1 and set(trainer._repair_models) == {2.0}

    ample = load_jax_variables(build_eval_model_scaled(small, 16.0, device="cpu"), variables)
    want = StubLoader(val_batch())
    port_trainer(cfg, ample, want, tmp_path / "b").val_epoch()
    for token, dets in want.results.items():
        for k, v in dets.items():
            np.testing.assert_array_equal(loader.results[token][k], v, err_msg=f"{token} {k}")

    with pytest.raises(RuntimeError, match="eval capacity overflow"):
        port_trainer(cfg, model, StubLoader(val_batch()), tmp_path / "c", eval_overflow="raise").val_epoch()
    # without eval_model_cfg there is nothing to repair with: it raises too
    with pytest.raises(RuntimeError, match="eval capacity overflow"):
        port_trainer(cfg, model, StubLoader(val_batch()), tmp_path / "d").val_epoch()
    # warn: the truncated detections are scored, with one warning per val_epoch
    warned = StubLoader(val_batch(), batches=2)
    with caplog.at_level("WARNING", logger="pillarnext_tpu_torch"):
        port_trainer(cfg, model, warned, tmp_path / "e", eval_overflow="warn").val_epoch()
    assert [r.levelname for r in caplog.records].count("WARNING") == 1
    assert warned.results.keys() == want.results.keys()


def test_fit_evaluates_at_eval_epochs_and_profiles(jax_val, tmp_path):
    """eval_every_nepochs=0 with eval_epochs=[1]: one val_epoch after the
    first epoch; profile_dir: a torch.profiler trace of steps 3-5."""
    cfg = jax_val[0]
    batches = synthetic_batches(cfg, 6, 1, 1500, seed=0, n_objects=3, max_points=2000)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    opt, sched = build_optimizer(cfg, len(batches), list(model.parameters()))
    val = StubLoader(val_batch())
    trainer = Trainer(model, batches, opt, sched, max_epochs=1, device="cpu", work_dir=tmp_path,
                      val_dataloader=val, eval_every_nepochs=0, eval_epochs=[1], profile_dir=tmp_path / "trace")
    trainer.fit()
    assert trainer.step == 6 and len(trainer.loader_wait_s) == 6
    assert val.results is not None and (tmp_path / "results" / "epoch_1").is_dir()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("convolution" in e.get("name", "") for e in trace["traceEvents"])


# --------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """cli.train (one epoch: 2 steps, then val_epoch over the 4 samples)
    and cli.test of its checkpoint, on the CPU."""
    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "nusc"
    make_mini_nuscenes(root, n_samples=4, n_points=700)
    overrides = cli_overrides(root)
    work = tmp / "work"
    common = ["--config", str(FLAGSHIP), "--device", "cpu"]
    trained = cli_train.main([*common, "--work-dir", str(work), *overrides])
    tested = cli_test.main([*common, "--checkpoint", str(work / "checkpoints" / "epoch_1.pt"),
                            "--work-dir", str(tmp / "work2"), *overrides])
    return tmp, common, overrides, trained, tested


def test_cli_train_then_test(cli_run):
    tmp, _, _, trained, tested = cli_run
    work = tmp / "work"
    assert trained.epoch == 1 and trained.step == 2 and trained.model.training
    assert all(np.isfinite(float(v)) for v in trained.epoch_losses)
    assert len(trained.loader_wait_s) == 2
    assert (work / "checkpoints" / "epoch_1.pt").exists()
    for d in (work, tmp / "work2"):
        results = d / "results" / "epoch_1"
        sub = json.loads((results / "results_nusc.json").read_text())
        assert len(sub["results"]) == 4
        assert (results / "metrics_summary.json").exists()
    assert (work / "results/epoch_1/results_nusc.json").read_bytes() == \
        (tmp / "work2/results/epoch_1/results_nusc.json").read_bytes()
    assert tested.last_detections.keys() == trained.last_detections.keys() == {f"token_{i}" for i in range(4)}
    for token, dets in trained.last_detections.items():
        for k, v in dets.items():
            np.testing.assert_array_equal(tested.last_detections[token][k], v, err_msg=f"{token} {k}")
    # the eval model took the train model's weights, not its own
    for k, v in trained.model.state_dict().items():
        assert torch.equal(trained.eval_model.state_dict()[k], v), k


def test_cli_load_from_and_resume(cli_run):
    """--load-from takes the weights only; --resume-from and the automatic
    resume take the epoch and the optimizer too (max_epochs=1: nothing
    left to train)."""
    tmp, common, overrides, trained, _ = cli_run
    ckpt = tmp / "work" / "checkpoints" / "epoch_1.pt"
    saved = ckpt_lib.load_checkpoint(ckpt)
    loaded = cli_train.main([*common, "--work-dir", str(tmp / "load"), "--load-from", str(ckpt),
                             *overrides, "trainer.max_epochs=0"])
    assert loaded.epoch == 0 and loaded.step == 0
    for k, v in saved["model"].items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    for argv in (["--work-dir", str(tmp / "work")], ["--work-dir", str(tmp / "other"), "--resume-from", str(ckpt)]):
        resumed = cli_train.main([*common, *argv, *overrides])
        assert resumed.epoch == 1 and resumed.step == 2
        for k, v in saved["model"].items():
            assert torch.equal(resumed.model.state_dict()[k], v), k
        for a, b in zip(resumed.optimizer.mu, trained.optimizer.mu):
            assert torch.equal(a, b)


def test_cli_refuses_more_than_one_process(monkeypatch, tmp_path):
    """Several processes need a group that forms: WORLD_SIZE > 1 without
    RANK and the rendezvous address raises instead of training one shard
    alone; nccl on the CPU raises before any group forms."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = ["--config", str(FLAGSHIP), "--device", "cpu"]
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2 but"):
        cli_train.main(argv)
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2 but"):
        cli_test.main([*argv, "--checkpoint", str(tmp_path / "epoch_1.pt")])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="nccl backend needs a CUDA device"):
        cli_train.main([*argv, "--dist-backend", "nccl"])


def reference_checkpoint(cfg, variables, path):
    """JAX's ``export_pillarnext`` of ``variables`` written as the reference
    writes a checkpoint: under ``state_dict``, every key prefixed
    ``module.``, the sparse backbone's kernels in spconv's (O, kH, kW, I),
    a ``num_batches_tracked`` beside every BatchNorm."""
    head = cfg["model"]["head"]
    sd = jax_import.export_pillarnext(
        variables["params"], variables["batch_stats"], num_filters=cfg["model"]["reader"]["num_filters"],
        layer_nums=cfg["model"]["backbone"]["layer_nums"], tasks=head["tasks"],
        common_heads=head["common_heads"])
    out = {}
    for k, v in sd.items():
        t = torch.from_numpy(np.array(v))
        if k.startswith("backbone.blocks.") and t.dim() == 4:
            t = t.permute(0, 2, 3, 1).contiguous()
        out["module." + k] = t
        if k.endswith(".running_var"):
            out["module." + k.replace(".running_var", ".num_batches_tracked")] = torch.tensor(7)
    torch.save({"state_dict": out, "epoch": 3}, path)
    return path


@pytest.mark.parametrize("head_option", [None, "merge_branches", "merge_tasks"])
def test_reference_checkpoint_imports_as_jax_does(jax_val, tmp_path, head_option):
    cfg, variables, ref = jax_val
    path = reference_checkpoint(cfg, variables, tmp_path / "reference.pth")
    model_cfg, head = cfg["model"], cfg["model"]["head"]
    kw = dict(num_filters=model_cfg["reader"]["num_filters"], layer_nums=model_cfg["backbone"]["layer_nums"],
              ds_num_filters=model_cfg["backbone"]["ds_num_filters"],
              num_input_features=model_cfg["backbone"]["num_input_features"],
              out_channels=model_cfg["backbone"]["out_channels"], tasks=head["tasks"],
              common_heads=head["common_heads"])
    if head_option is None:
        # JAX's import gives back the trees its val_epoch ran
        params, stats = import_pillarnext(jax_import.load_torch_state_dict(path), **kw)
        for got, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
            assert jax.tree.structure(got) == jax.tree.structure(want)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        overrides = []
    else:
        # JAX's importer builds the merged head's trees from the same file
        import_pillarnext(jax_import.load_torch_state_dict(path), **kw, **{head_option: True})
        overrides = [f"+model.head.{head_option}=true"]
    argv = ["--config", str(FLAGSHIP), "--device", "cpu", *OVERRIDES, *overrides]
    ckpt = cli_import.main([*argv[:4], "--torch-checkpoint", str(path), "--out", str(tmp_path / "imported"),
                            *argv[4:]])
    assert ckpt == tmp_path / "imported" / "epoch_0.pt"
    run_cfg = load_experiment(FLAGSHIP, OVERRIDES + overrides)
    loader = StubLoader(val_batch())
    trainer = port_trainer(run_cfg, build_model(run_cfg["model"], device="cpu"), loader, tmp_path / "val")
    trainer.resume(ckpt)  # what cli.test --checkpoint reads
    trainer.val_epoch()
    got = loader.results
    assert got.keys() == ref.keys()
    for token in ref:
        o, r = got[token], ref[token]
        assert len(o["scores"]) == len(r["scores"]), token
        o_ord = np.lexsort((-o["scores"], o["label_preds"]))
        r_ord = np.lexsort((-r["scores"], r["label_preds"]))
        np.testing.assert_array_equal(o["label_preds"][o_ord], r["label_preds"][r_ord])
        np.testing.assert_allclose(o["scores"][o_ord], r["scores"][r_ord], atol=1e-3, rtol=0)
        np.testing.assert_allclose(o["box3d_lidar"][o_ord], r["box3d_lidar"][r_ord], atol=1e-2, rtol=0)
    # what cli.train --load-from reads
    trainer.load_weights(ckpt)


def test_reference_checkpoint_rejects_missing_stray_and_misshapen_tensors(jax_val, tmp_path):
    cfg, variables, _ = jax_val
    sd = load_torch_state_dict(reference_checkpoint(cfg, variables, tmp_path / "reference.pth"))
    assert not any(k.startswith("module.") for k in sd)
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(state_dict_from_reference(sd, model), strict=True)
    missing = dict(sd)
    del missing["neck.conv1x1.weight"]
    with pytest.raises(KeyError, match="neck.conv1x1.weight"):
        state_dict_from_reference(missing, model)
    with pytest.raises(KeyError, match="head.extra.weight"):
        state_dict_from_reference(dict(sd, **{"head.extra.weight": np.zeros(3, np.float32)}), model)
    bad = dict(sd, **{"neck.weight": sd["neck.weight"][:, :-1]})
    with pytest.raises(ValueError, match="neck.weight"):
        state_dict_from_reference(bad, model)
