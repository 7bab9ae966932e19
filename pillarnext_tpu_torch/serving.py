"""Optimistic bucketed-capacity inference.

Counterpart of ``AdaptivePredictor`` (pillarnext_tpu/serving.py:62-270).
A bucket is the capacity argument of the reader's compact table, so a
bucket costs nothing to add.  A 2-D backbone that runs over tile stacks
gets the tile capacity of each bucket with it
(``SparseResNet.tile_capacity_for``, JAX serving.py:119-136): its own
scaled by the bucket below the largest bucket, the full tile grid at the
largest, so that a repair there is exact for the tiles too.  Each frame
is dispatched at the operating bucket; its overflow telemetry comes back
with the detections as device scalars, and ``resolve`` reads all of a
batch's counters in one transfer.  A frame's overflow is the sum of every
counter whose name holds ``overflow``: the reader's, and the 3-D
backbone's stage tables, which scale with the bucket, so a small bucket
can overflow a stage while the reader fits.  The MVF reader's cylinder
table counts too, though no bucket scales it (the buckets are pillar
capacities, as in the JAX serving): a frame whose cylinder table
overflows is recomputed at the largest bucket like any other and, since
its cylinder table overflows there as well, raises.  A frame that
overflowed is recomputed at the largest bucket (no site is lost there, or
it raises), and later frames dispatch at the largest bucket.  Without overflow a
smaller table gives the same detections: the active set and every slot's
values are unchanged.  Capacity tracking lowers the operating bucket to
the measured requirement (peak active pillars or voxels x margin,
quantised up), as the JAX step does (serving.py:148-170).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch


def tile_kwargs(model, bucket: int, max_bucket: int) -> dict:
    """``{"tile_capacity": ...}`` for a predict at ``bucket`` when the
    model's backbone runs over tile stacks (``SparseResNet.uses_tiles``),
    else ``{}``."""
    backbone = getattr(model, "backbone", None)
    if getattr(backbone, "uses_tiles", False):
        return {"tile_capacity": backbone.tile_capacity_for(bucket, max_bucket)}
    return {}


def _round_cap(c: int, quantum: int = 4096) -> int:
    return max(quantum, int(round(c / quantum)) * quantum)


@dataclasses.dataclass
class _Pending:
    out: Any                 # detection dict (device tensors)
    overflow: torch.Tensor   # () sites dropped by the reader and the stage tables
    active: torch.Tensor     # () occupied pillars or voxels
    inputs: tuple            # (points, mask), kept for a repair
    bucket: int


@dataclasses.dataclass
class AdaptivePredictor:
    """Args:
        model: the port's detector in eval mode (utils/builders.build_model);
            ``model.reader.capacity`` (the pillar or voxel capacity; MVF's
            pillar capacity) is the largest bucket.
        buckets: ascending per-sample capacities; default (3/4 max, max).
    """

    model: Any
    buckets: Sequence[int] | None = None
    level: int = 0           # current operating bucket index
    repaired: int = 0        # frames recomputed at the max bucket so far
    track_capacity: bool = True
    track_margin: float = 1.06
    track_quantum: int = 4096
    peak_required: int = 0   # largest per-sample active requirement seen
    _learned: int | None = None

    def __post_init__(self):
        if self.buckets is None:
            max_cap = int(self.model.reader.capacity)
            self.buckets = (_round_cap(max_cap * 3 // 4), max_cap)
        self.buckets = tuple(sorted(int(b) for b in self.buckets))

    def _run(self, bucket: int, points, mask):
        tel: dict = {}
        with torch.inference_mode():
            out = self.model.predict(points, mask, capacity=bucket, telemetry=tel,
                                     **tile_kwargs(self.model, bucket, self.buckets[-1]))
        overflow = sum(v for k, v in tel.items() if "overflow" in k)
        # the reader's count only: the bucket sizes the reader's table, not
        # the stage tables or the tile maps
        active = sum(v for k, v in tel.items() if k in ("pillar_active", "voxel_active"))
        return out, overflow, active

    def __call__(self, points, mask) -> _Pending:
        """Dispatch one batch at the operating bucket."""
        bucket = self._operating_bucket()
        out, ov, act = self._run(bucket, points, mask)
        return _Pending(out, ov, act, (points, mask), bucket)

    def _operating_bucket(self) -> int:
        """The ladder's bucket, lowered (never raised) by the learned
        requirement once frames have been observed."""
        b = self.buckets[self.level]
        if self.track_capacity and self._learned is not None:
            b = min(b, self._learned)
        return int(b)

    def _observe(self, required: int):
        if required <= self.peak_required:
            return
        self.peak_required = required
        if not self.track_capacity:
            return
        q = self.track_quantum
        cand = -(-int(required * self.track_margin) // q) * q
        self._learned = int(min(max(cand, q), self.buckets[-1]))

    def resolve(self, pending: Sequence[_Pending]) -> list:
        """Read the counters; repair overflowed frames at the max bucket;
        return the detection dicts in order."""
        if not pending:
            return []
        max_bucket = self.buckets[-1]
        flags = torch.stack(
            [torch.stack([p.overflow, p.active]) for p in pending]
        ).cpu().tolist()
        outs = []
        for p, (overflowed, active) in zip(pending, flags):
            batch = int(p.inputs[0].shape[0])
            if overflowed > 0 and p.bucket < max_bucket:
                out, ov, act = self._run(max_bucket, *p.inputs)
                ov, act = torch.stack([ov, act]).cpu().tolist()
                if ov > 0:
                    raise RuntimeError(
                        "active set overflows even the largest capacity bucket "
                        f"({max_bucket}); raise the reader's capacity or the "
                        "backbone's stage_capacity_frac"
                    )
                outs.append(out)
                self.repaired += 1
                self.level = len(self.buckets) - 1  # stop being optimistic
                self._observe(-(-act // batch))
            elif overflowed > 0:
                raise RuntimeError(
                    "active set overflows the largest capacity bucket "
                    f"({max_bucket}); raise the reader's capacity or the "
                    "backbone's stage_capacity_frac"
                )
            else:
                outs.append(p.out)
                self._observe(-(-active // batch))
        return outs

    def predict(self, points, mask):
        """Dispatch + resolve one batch."""
        return self.resolve([self(points, mask)])[0]

    def warmup(self, points, mask):
        """Run every bucket once, then resolve one frame so the tracker
        learns its requirement."""
        for b in self.buckets:
            self._run(b, points, mask)
        if self.track_capacity:
            self.resolve([self(points, mask)])
