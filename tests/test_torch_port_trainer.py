"""The port's Trainer on the CPU: steps, checkpoints, the overflow check.

Narrowed flagship (tests/test_torch_port_e2e.py's overrides), seeded
synthetic batches from the port's own synth + AssignLabel + collate.
"""

from __future__ import annotations

import math

import pytest
import torch

from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.train import checkpoint as ckpt_lib
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes on
    the machine's cores, and each torch pool of all cores in each of them
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(cfg, batches, work_dir, seed=0):
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(seed), train=True)
    opt, sched = build_optimizer(cfg, len(batches), list(model.parameters()))
    return Trainer(model, batches, opt, sched, max_epochs=1, log_every_niters=2,
                   work_dir=work_dir, device="cpu")


def test_trainer_three_steps_and_checkpoint_round_trip(tmp_path):
    cfg = load_experiment(FLAGSHIP, OVERRIDES)
    batches = synthetic_batches(cfg, 3, 2, 3000, seed=3, n_objects=4, max_points=4000)
    trainer = _trainer(cfg, batches, tmp_path)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.fit()
    assert trainer.epoch == 1 and trainer.step == 3
    assert math.isfinite(float(trainer.last_scalars["loss"]))
    assert int(trainer.last_scalars["overflow"]) == 0
    after = trainer.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in after)
    path = ckpt_lib.latest_checkpoint(tmp_path / "checkpoints")
    assert path is not None and path.name == "epoch_1.pt"

    other = _trainer(cfg, batches, tmp_path, seed=1)
    assert other.auto_resume()
    assert other.epoch == 1 and other.step == 3
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, after[k]), k
    for a, b in zip(other.optimizer.mu + other.optimizer.nu, trainer.optimizer.mu + trainer.optimizer.nu):
        assert torch.equal(a, b)
    # the resumed run continues: one more epoch, same data
    other.max_epochs = 2
    other.fit()
    assert other.epoch == 2 and other.step == 6


def test_undersized_stage_capacity_raises_overflow(tmp_path):
    # a 256 x 256 grid: stage 1 has 2 x 128 x 128 cells, and a table of
    # 4096 (the floor of stage_capacity_frac's sizing) cannot hold them
    overrides = [o for o in OVERRIDES if o.split("=")[0] not in (
        "model.reader.pc_range", "model.reader.voxel_size", "model.reader.pillar_capacity")]
    overrides += [
        "model.reader.pc_range=[-16.0,-16.0,-5.0,16.0,16.0,3.0]",
        "model.reader.voxel_size=[0.125,0.125,8.0]", "model.reader.pillar_capacity=16384",
        "model.backbone.stage_capacity_frac=[1.0,0.01,0.01,0.01]",
    ]
    cfg = load_experiment(FLAGSHIP, overrides)
    batches = synthetic_batches(cfg, 1, 2, 20000, seed=0, n_objects=4, max_points=20000)
    trainer = _trainer(cfg, batches, tmp_path)
    with pytest.raises(RuntimeError, match="stage1_overflow"):
        trainer.train_epoch()
    assert ckpt_lib.latest_checkpoint(tmp_path / "checkpoints") is None


def test_trainer_rejects_what_is_not_ported(tmp_path):
    """val_epoch is ported: it predicts each val batch and hands the valid
    detections by token to the loader's dataset, leaving the train-mode
    model in train mode.  accum_steps > 1 is ported (held against JAX in
    tests/test_torch_port_distributed.py), and so is every backbone stage
    mode (tests/test_torch_port_backbone_modes*.py), and so are the head's
    merges (tests/test_torch_port_head_options.py).  What still raises at
    build: a stage mode name that is not one of the four (JAX falls
    through to 'leading'), an NMS name that is neither 'iou3d' nor
    'circle' (JAX runs rotated NMS), and the tile stack with a 5 x 5
    stride-1 kernel (its halo is one cell)."""
    cfg = load_experiment(FLAGSHIP, OVERRIDES)
    trainer = _trainer(cfg, [], tmp_path)
    batch = synthetic_batches(cfg, 1, 2, 3000, seed=3, n_objects=4, max_points=4000)[0]

    class Val(list):
        dataset = None

        def evaluation(self, results, output_dir):
            self.results = results
            return {"scored": sorted(results)}

    trainer.val_dataloader = Val([{"token": ["a", "b"], "points": batch["points"],
                                   "points_mask": batch["points_mask"]}])
    trainer.val_dataloader.dataset = trainer.val_dataloader
    assert trainer.val_epoch() == {"scored": ["a", "b"]}
    assert trainer.model.training
    for dets in trainer.val_dataloader.results.values():
        assert dets.keys() == {"box3d_lidar", "scores", "label_preds"}
        assert dets["box3d_lidar"].shape == (len(dets["scores"]), 9) == (len(dets["label_preds"]), 9)
    assert (tmp_path / "results" / "epoch_0").is_dir()
    assert Trainer(trainer.model, [], trainer.optimizer, accum_steps=2, device="cpu").accum_steps == 2
    for variants, error in ((["model.post_processing.nms_type=circle_nms"], ValueError),
                            (["+model.backbone.sparse_stages_eval=leading_down"], ValueError),
                            (["+model.backbone.sparse_stages_eval=tile",
                              "+model.backbone.kernel_size=[5,3,3,3]"], ValueError)):
        with pytest.raises(error):
            build_model(load_experiment(FLAGSHIP, OVERRIDES + variants)["model"], device="cpu")
