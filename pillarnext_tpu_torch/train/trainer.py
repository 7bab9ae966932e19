"""Trainer runtime: epoch loop, overflow check, evaluation, checkpoints.

Counterpart of pillarnext_tpu/train/trainer.py:56-357.  Each iteration is
one ``train_step`` (train_state.py); scalars stay on the card and are read
only at log ticks and at the end of the epoch, where ``_check_overflow``
raises if any capacity counter reported dropped active sites — an
undersized pillar capacity or ``stage_capacity_frac`` fails loudly instead
of silently truncating the scene.  ``val_epoch`` predicts every val batch
with the eval model (the serving capacity, the train model's weights and
BN statistics), repairs a batch whose tables overflowed on a model built
at 2x, 4x or 8x the capacity, brings each batch's detections to the host
in one copy, and hands them to the dataset's scorer.  ``fit`` evaluates
every ``eval_every_nepochs`` epochs and at ``eval_epochs``.

Under a process group (parallel/; one process per card, each with its
shard of the data) the parameters and BN statistics start as rank 0's, a
step sums the gradients across ranks (train_state.py), every rank raises
together on an overflow on any rank, ``val_epoch`` gathers every rank's
detections to rank 0, which alone scores them, and rank 0 alone logs,
traces and writes checkpoints.  Each rank's compact tables hold
``capacity x`` its own batch, where JAX's one global table holds
``capacity x`` the global batch: a rank whose samples are denser than the
average can overflow where JAX would not, and the overflow check raises
then.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

from pillarnext_tpu_torch import parallel
from pillarnext_tpu_torch.train import checkpoint as ckpt_lib
from pillarnext_tpu_torch.train.train_state import train_step
from pillarnext_tpu_torch.utils import builders, profiling, progress
from pillarnext_tpu_torch.utils.builders import resolve_device

logger = logging.getLogger("pillarnext_tpu_torch")

_DET_KEYS = ("box3d_lidar", "scores", "label_preds")


def batch_to_device(batch: dict, device) -> dict:
    """Numpy / tensor batch (data/collate.py layout) -> tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if k == "token":
            out[k] = v
        elif isinstance(v, list):
            out[k] = [torch.as_tensor(t).to(device, non_blocking=True) for t in v]
        else:
            out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


def _timed(iterable, waits: list):
    """Yield from ``iterable``, appending to ``waits`` the seconds each
    item took to arrive (time blocked on the loader), each wait a
    ``train.loader_wait`` span (``val_epoch``'s too)."""
    it = iter(iterable)
    while True:
        t = time.perf_counter()
        try:
            with profiling.annotate("train.loader_wait"):
                item = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t)
        yield item


def detections_to_host(out: dict, telemetry: dict) -> tuple[dict, dict]:
    """A predict's fixed-size detections (numpy, per key) and its positive
    ``*_overflow`` counters, brought to the host in one device-to-host copy:
    every output and counter packed into one float32 buffer (labels and
    counts are integers far below 2^24, so the round trip is exact)."""
    (b, d, c), n = out["box3d_lidar"].shape, out["scores"].numel()
    names = sorted(k for k in telemetry if k.endswith("_overflow"))
    parts = [out["box3d_lidar"].float(), out["scores"].float()[..., None],
             out["label_preds"].float()[..., None], out["valid"].float()[..., None]]
    flat = torch.cat([torch.cat(parts, -1).reshape(-1)]
                     + [telemetry[k].float().reshape(1) for k in names]).cpu().numpy()
    packed = flat[: n * (c + 3)].reshape(b, d, c + 3)
    label_dtype = torch.empty((), dtype=out["label_preds"].dtype).numpy().dtype
    dets = {"box3d_lidar": packed[..., :c], "scores": packed[..., c],
            "label_preds": packed[..., c + 1].astype(label_dtype), "valid": packed[..., c + 2] > 0}
    over = {k: int(v) for k, v in zip(names, flat[n * (c + 3):]) if v > 0}
    return dets, over


class Trainer:
    """Args:
        model: the port's detector on ``device``
            (utils/builders.build_model(train=True)).
        train_dataloader: an iterable of batches with ``len``; ``set_epoch``
            is called when it has one.
        optimizer: ``train_state.AdamW`` over the model's parameters on
            ``device`` (utils/builders.build_optimizer).
        device: ``"cuda:0"`` unless the caller asks for the CPU; without a
            card the default raises.
        val_dataloader: val batches (data/loader.py) whose ``dataset`` has
            ``evaluation(detections, output_dir)``; without one ``fit``
            only trains.
        eval_model: the model ``val_epoch`` predicts with, e.g. one built at
            the serving ``pillar_capacity`` while ``model`` trains at
            ``train_pillar_capacity``; it takes ``model``'s weights and BN
            statistics at the start of each ``val_epoch``.  Default:
            ``model`` itself, put in eval mode and back.
        eval_model_cfg: the resolved ``cfg["model"]``: lets ``val_epoch``
            repair an overflowed batch on a model built at a scaled
            capacity (utils/builders.build_eval_model_scaled).
        eval_overflow: what an overflowed val batch does: ``"repair"``
            (with ``eval_model_cfg``), ``"raise"``, or ``"warn"`` (once).
        profile_dir: write a torch.profiler trace of train steps 3-5 of
            the first epoch there, the port's spans in it
            (utils/profiling.py); rank 0 only.
        accum_steps: micro-batches per step (train_state.train_step); each
            batch's leading dim must divide by it.
    """

    def __init__(self, model, train_dataloader=None, optimizer=None, lr_schedule=None,
                 max_epochs: int = 0, log_every_niters: int = 50, work_dir=".",
                 accum_steps: int = 1, device="cuda:0", logger_=None, val_dataloader=None,
                 eval_every_nepochs: int = 1, eval_epochs=None, profile_dir=None,
                 eval_model=None, eval_model_cfg: dict | None = None, eval_overflow: str = "repair"):
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        parallel.require_group()
        if eval_overflow not in ("repair", "raise", "warn"):
            raise ValueError(f"eval_overflow must be repair, raise or warn, got {eval_overflow!r}")
        self.device = resolve_device(device)
        self.model = model
        params = list(model.parameters())
        if any(p.device != self.device for p in params):
            raise ValueError(f"the model's parameters must be on {self.device} (build_model(device=...))")
        if optimizer is None or len(optimizer.params) != len(params) or any(
            a is not b for a, b in zip(optimizer.params, params)
        ):
            raise ValueError("optimizer must hold the model's parameters (build_optimizer)")
        self.eval_model = eval_model if eval_model is not None else model
        if any(p.device != self.device for p in self.eval_model.parameters()):
            raise ValueError(f"the eval model's parameters must be on {self.device}")
        self.train_dataloader = train_dataloader
        self.val_dataloader = val_dataloader
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.max_epochs = max_epochs
        self.log_every_niters = log_every_niters
        self.eval_every_nepochs = eval_every_nepochs
        self.eval_epochs = eval_epochs
        self.work_dir = Path(work_dir)
        self.profile_dir = profile_dir
        self.eval_model_cfg = eval_model_cfg
        self.eval_overflow = eval_overflow
        self.accum_steps = int(accum_steps)
        self.logger = logger_ or logger
        self.epoch = 0
        self.last_scalars = None
        self.epoch_losses: list[torch.Tensor] = []  # this epoch's step losses, on the card
        self.loader_wait_s: list[float] = []  # this epoch's time blocked on each batch
        self.eval_repairs = 0  # val batches recomputed at a scaled capacity
        self._repair_models: dict[float, torch.nn.Module] = {}
        # the last val_epoch's detections by token, and its host timings
        self.last_detections: dict[str, dict] = {}
        self.val_timing: dict = {}
        # every rank starts from rank 0's weights and BN statistics
        parallel.broadcast_from_rank0_(list(model.state_dict().values()))

    @property
    def step(self) -> int:
        return self.optimizer.count

    @property
    def rank(self) -> int:
        return parallel.rank()

    def train_step(self, batch: dict):
        """One optimizer step on a host or device batch."""
        return train_step(self.model, self.optimizer, batch_to_device(batch, self.device),
                          accum_steps=self.accum_steps)

    def train_epoch(self):
        if hasattr(self.train_dataloader, "set_epoch"):
            self.train_dataloader.set_epoch(self.epoch)
        num_iters = len(self.train_dataloader)
        t_start = time.time()
        scalars = None
        self.epoch_losses, self.loader_wait_s = [], []
        # trace a few steady-state steps of the first epoch
        trace_steps = range(3, 6) if (self.profile_dir and self.epoch == 0 and self.rank == 0) else range(0)
        with contextlib.ExitStack() as tracing:
            for i, batch in enumerate(_timed(self.train_dataloader, self.loader_wait_s)):
                if trace_steps and i == trace_steps[0]:
                    tracing.enter_context(profiling.trace(self.profile_dir))
                scalars, logs = self.train_step(batch)
                self.epoch_losses.append(scalars["loss"])
                if trace_steps and i == trace_steps[-1]:
                    tracing.close()
                    self.logger.info("profiler trace written to %s", self.profile_dir)
                if (i + 1) % self.log_every_niters == 0:
                    if self.rank == 0:
                        self._log_step(i, num_iters, t_start, scalars, logs)
                    self._check_overflow(scalars, f"epoch {self.epoch + 1} iter {i + 1}")
        # the epoch's last step is checked too, before the checkpoint
        self._check_overflow(scalars, f"epoch {self.epoch + 1} end")
        self.last_scalars = scalars
        self.epoch += 1
        ckpt_lib.save_checkpoint(self.work_dir / "checkpoints", self.epoch, self.model, self.optimizer)

    def _log_step(self, i: int, num_iters: int, t_start: float, scalars: dict, logs: list):
        lr = self.lr_schedule(self.step) if self.lr_schedule else float("nan")
        wait = self.loader_wait_s[-self.log_every_niters:]
        self.logger.info(
            "Epoch [%d/%d][%d/%d]\tlr: %.5f, loss: %.4f, %.2f it/s (loader wait %.0f ms/it)",
            self.epoch + 1, self.max_epochs, i + 1, num_iters, lr,
            float(scalars["loss"]), (i + 1) / (time.time() - t_start), sum(wait) / len(wait) * 1e3,
        )
        for log in logs:
            self.logger.info(", ".join(f"{k}: {v.tolist()}" for k, v in log.items()))

    def _check_overflow(self, scalars, where: str):
        """Raise when capacity telemetry reports dropped active sites, on
        any rank: the overflow counters are all-reduced (MAX) first, so
        every rank raises together instead of one raising while the others
        wait in its next collective."""
        if scalars is None:
            return
        tel = scalars["telemetry"]
        names = sorted(k for k in tel if k.endswith("_overflow"))
        counts = torch.stack([scalars["overflow"].to(self.device, torch.int64)]
                             + [tel[k].to(self.device, torch.int64) for k in names])
        parallel.all_reduce_([counts], op=torch.distributed.ReduceOp.MAX)
        counts = counts.tolist()
        if counts[0] == 0:
            return
        detail = {k: v for k, v in zip(names, counts[1:]) if v > 0}
        active = {k: int(v) for k, v in tel.items() if k.endswith("_active")}
        ranks = f" (the largest over {parallel.world_size()} ranks)" if parallel.is_distributed() else ""
        raise RuntimeError(
            f"capacity overflow at {where}: {detail}{ranks} active sites were silently dropped "
            f"(true active counts: {active}). Raise reader pillar capacity or backbone "
            "stage_capacity_frac to cover the data's dilated active sets."
        )

    # ------------------------------------------------------------------ eval

    @staticmethod
    def _predict(model, example: dict) -> tuple[dict, dict]:
        tel: dict = {}
        with torch.inference_mode():
            out = model.predict(example["points"], example["points_mask"], telemetry=tel)
        return detections_to_host(out, tel)

    def _repair_eval_batch(self, example: dict, over: dict) -> dict:
        """Recompute one overflowed val batch on models built at 2x, 4x and
        8x the configured capacities (trainer.py:217-246), the val-side
        analogue of serving.AdaptivePredictor's repair: without overflow a
        larger table gives the detections an ample capacity gives."""
        for scale in (2.0, 4.0, 8.0):
            if scale not in self._repair_models:
                self._repair_models[scale] = builders.build_eval_model_scaled(
                    self.eval_model_cfg, scale, self.device)
            model = self._repair_models[scale]
            model.load_state_dict(self.eval_model.state_dict())
            model.eval()
            dets, over = self._predict(model, example)
            if not over:
                self.eval_repairs += 1
                return dets
        raise RuntimeError(
            f"eval capacity overflow persists at 8x capacity: {over} — the scene's "
            "active set is implausibly dense; check the data or raise reader "
            "pillar/voxel capacity outright"
        )

    def val_epoch(self) -> dict | None:
        """Predict every val batch, score the detections with the dataset's
        ``evaluation`` into ``work_dir/results/epoch_{epoch}``, and return
        the scorer's result.  Leaves ``model`` in the mode it found it in.
        Under a process group each rank predicts its shard and rank 0
        scores the union of every rank's detections by token (the
        sampler's padded duplicates collapse in it); the other ranks return
        None, as JAX's do.  ``val_timing`` and ``eval_repairs`` are this
        rank's."""
        model = self.eval_model
        if model is not self.model:
            model.load_state_dict(self.model.state_dict())
        was_training = model.training
        model.eval()
        results: dict[str, dict] = {}
        waits: list[float] = []
        batch_s: list[float] = []
        warned = False
        bar = progress.ProgressBar(len(self.val_dataloader)) if self.rank == 0 else None
        try:
            for batch in _timed(self.val_dataloader, waits):
                t0 = time.perf_counter()
                example = batch_to_device(batch, self.device)
                dets, over = self._predict(model, example)
                if over and self.eval_overflow == "repair" and self.eval_model_cfg:
                    self.logger.info("eval capacity overflow %s — recomputing the batch at a "
                                     "scaled capacity (exact repair)", over)
                    dets = self._repair_eval_batch(example, over)
                elif over and self.eval_overflow != "warn":
                    raise RuntimeError(
                        f"eval capacity overflow: {over} active sites dropped — metrics would "
                        "be silently degraded. Raise reader pillar/voxel capacity, or pass "
                        "eval_model_cfg for automatic repair (eval_overflow='repair')."
                    )
                elif over and not warned:
                    self.logger.warning("eval capacity overflow (sites dropped, predictions "
                                        "degraded): %s — raise capacities for trustworthy "
                                        "metrics", over)
                    warned = True
                batch_s.append(time.perf_counter() - t0)
                if bar is not None:
                    bar.update()
                for bi, token in enumerate(batch["token"]):
                    valid = dets["valid"][bi]
                    results[token] = {k: dets[k][bi][valid] for k in _DET_KEYS}
        finally:
            model.train(was_training)

        self.val_timing = {"loader_wait_s": waits, "batch_s": batch_s, "scorer_s": None}
        gathered = parallel.gather_to_rank0(results)
        if gathered is None:
            self.last_detections = results
            return None
        for shard in gathered[1:]:
            results.update(shard)
        output_dir = self.work_dir / "results" / f"epoch_{self.epoch}"
        output_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        result = self.val_dataloader.dataset.evaluation(results, output_dir)
        self.val_timing["scorer_s"] = time.perf_counter() - t0
        self.last_detections = results
        if result:
            for k, v in result.items():
                self.logger.info("Evaluation %s: %s", k, v)
        return result

    # ------------------------------------------------------------ fit/resume

    def fit(self):
        """Train to ``max_epochs``, evaluating after every
        ``eval_every_nepochs``-th epoch and after each of ``eval_epochs``
        (when there is a val loader)."""
        self.logger.info("max: %d epochs", self.max_epochs)
        while self.epoch < self.max_epochs:
            self.train_epoch()
            if self.val_dataloader is not None and (
                (self.eval_every_nepochs > 0 and self.epoch % self.eval_every_nepochs == 0)
                or (self.eval_epochs is not None and self.epoch in self.eval_epochs)
            ):
                self.val_epoch()

    def resume(self, path):
        payload = ckpt_lib.load_checkpoint(path)
        ckpt_lib.restore(self.model, self.optimizer, payload)
        self.epoch = int(payload["meta"]["epoch"])
        self.logger.info("resumed epoch %d, step %d", self.epoch, self.step)

    def load_weights(self, path):
        """load_from semantics: the model's weights and BN statistics only
        (no optimizer state, no epoch; tools/train.py:75-77)."""
        self.model.load_state_dict(ckpt_lib.load_checkpoint(path)["model"], strict=True)

    def auto_resume(self) -> bool:
        latest = ckpt_lib.latest_checkpoint(self.work_dir / "checkpoints")
        if latest is None:
            return False
        self.resume(latest)
        return True
