"""An undersized tile capacity on the CPU: serving and val repair it, a
training step raises.

The narrowed flagship (tests/test_torch_port_e2e.py's widths) on a 256 x
256 grid (+-16 m, 0.125 m pillars: 32 x 32 tiles of 8 x 8 a sample) with
``tile_capacity=1``, so that every tile map gets the 256-slot floor and
20k-point scenes occupy more tiles than that.  The pattern of JAX's
tests/test_serving.py:110 and tests/test_val_overflow_repair.py:163:

- ``AdaptivePredictor`` in the ``tile`` eval mode: the first frame runs at
  the smaller bucket, whose tile capacity (scaled by the bucket) overflows;
  the frame is recomputed at the largest bucket over the full tile grid,
  bit-equal to a predict at that capacity, and the reader-active count
  that tracks the bucket reads only the pillar table;
- ``Trainer.val_epoch`` with ``eval_model_cfg``: the batch overflows the
  eval model's tiles and is repaired on a model built by
  ``build_eval_model_scaled`` (the full tile grid), bit-equal to it;
- a ``tile_stride1`` train step whose ``stage0_tiles256`` map overflows:
  the Trainer raises and names the counter.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.train import checkpoint as ckpt_lib
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils.builders import build_eval_model_scaled, build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES

PC = [-16.0, -16.0, -5.0, 16.0, 16.0, 3.0]
GRID = [o for o in OVERRIDES if o.split("=")[0] not in (
    "model.reader.pc_range", "model.reader.voxel_size", "model.reader.pillar_capacity")] + [
    f"model.reader.pc_range={PC}", "model.reader.voxel_size=[0.125,0.125,8.0]",
    "model.reader.pillar_capacity=16384", "+model.backbone.tile_capacity=1",
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(seed=0):
    pts, mask = lidar_like_points(1, 20000, PC, seed=seed)
    return torch.from_numpy(pts), torch.from_numpy(mask)


def test_serving_repairs_a_tile_overflow_at_the_largest_bucket():
    cfg = load_experiment(FLAGSHIP, GRID + ["+model.backbone.sparse_stages_eval=tile"])["model"]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    points, mask = _frame()
    engine = AdaptivePredictor(model)
    assert engine.buckets == (12288, 16384)
    tel = {}
    with torch.inference_mode():
        model.predict(points, mask, capacity=12288, telemetry=tel,
                      tile_capacity=model.backbone.tile_capacity_for(12288, 16384))
    assert int(tel["prefix_tiles256_overflow"]) > 0 and int(tel["pillar_overflow"]) == 0
    pending = engine(points, mask)
    assert pending.bucket == 12288 and int(pending.overflow) > 0
    # the reader's count only: the tile map's active count is not a pillar count
    assert int(pending.active) == int(tel["pillar_active"])
    out = engine.resolve([pending])[0]
    assert engine.repaired == 1 and engine.level == 1
    tel = {}
    with torch.inference_mode():
        want = model.predict(points, mask, capacity=16384, telemetry=tel, tile_capacity=0)
    assert int(tel["prefix_tiles256_overflow"]) == 0 and int(tel["prefix_tiles256_active"]) > 256
    for k in want:
        assert torch.equal(out[k], want[k]), k
    assert int(want["valid"].sum()) > 0


def test_val_epoch_repairs_a_tile_overflow(tmp_path):
    cfg = load_experiment(FLAGSHIP, GRID + ["+model.backbone.sparse_stages_eval=tile"])
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    opt, sched = build_optimizer(cfg, 1, list(model.parameters()))
    points, mask = _frame(1)

    class Val(list):
        def evaluation(self, results, output_dir):
            self.results = results
            return {"scored": sorted(results)}

    val = Val([{"token": ["a"], "points": points.numpy(), "points_mask": mask.numpy()}])
    val.dataset = val
    trainer = Trainer(model, [], opt, sched, work_dir=tmp_path, device="cpu", val_dataloader=val,
                      eval_model_cfg=cfg["model"])
    assert trainer.val_epoch() == {"scored": ["a"]}
    assert trainer.eval_repairs == 1
    full = build_eval_model_scaled(cfg["model"], 2.0, device="cpu")
    assert full.backbone.tile_capacity == 0
    full.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = full.eval().predict(points, mask)
    got = val.results["a"]
    valid = want["valid"][0]
    assert int(valid.sum()) > 0
    for k in ("box3d_lidar", "scores", "label_preds"):
        np.testing.assert_array_equal(got[k], want[k][0][valid].numpy(), err_msg=k)


def test_training_tile_overflow_raises(tmp_path):
    cfg = load_experiment(FLAGSHIP, GRID + ["+model.backbone.tile_stride1=true"])
    batches = synthetic_batches(cfg, 1, 2, 20000, seed=0, n_objects=4, max_points=20000)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    opt, sched = build_optimizer(cfg, 1, list(model.parameters()))
    trainer = Trainer(model, batches, opt, sched, max_epochs=1, log_every_niters=2, work_dir=tmp_path,
                      device="cpu")
    with pytest.raises(RuntimeError, match="stage0_tiles256_overflow"):
        trainer.train_epoch()
    assert ckpt_lib.latest_checkpoint(tmp_path / "checkpoints") is None
