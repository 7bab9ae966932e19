"""Host data loader: sharded, deterministic, multiprocess prefetching.

The port's own copy of pillarnext_tpu/data/loader.py, which replaces the
reference's torch DataLoader + DistributedSampler
(det3d/datasets/loader/build_loader.py:8-27, 16 worker processes per GPU in
configs/dataloader/default.yaml:4): each process iterates its own shard of
a deterministically shuffled epoch permutation (seeded by epoch, like
sampler.set_epoch, trainer.py:131-132); ``num_workers`` forked processes
run the full numpy pipeline (GT-paste, multi-sweep decode, augment,
assign, collate) in parallel and stream collated batches back over pickle
pipes in order, overlapping host preprocessing with device compute.
Batches are dropped-last so every step sees the same static shape.

Determinism: every batch is loaded under random states derived from
(seed, epoch, batch_index): a ``np.random.RandomState`` that the dataset
threads through its sampler and augmentations, seeded as the JAX loader
seeds the global stream, and the collate's ``np.random.Generator``.  The
port's batches equal the JAX package's bit for bit at equal
``num_workers``; streams differ across worker counts, in both packages,
because the GT-paste BatchSampler's cursor state lives per worker.

Workers are forked, possibly after the parent has initialised CUDA: the
pipeline is numpy only and creates no tensor, and each worker limits
torch's intra-op pool to one thread so that 16 workers do not
oversubscribe the host.  The batches reach the card in the parent
(train/trainer.batch_to_device).  Each iteration records where a wait
for a batch goes: ``start_s``, the seconds it took to start the workers,
and ``load_s``, each batch's seconds in its worker (or inline); the rest
of a wait is the queue's transfer and the workers' lag.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Iterator

import numpy as np
import torch

from pillarnext_tpu_torch.data.collate import collate


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        max_points: int,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        num_workers: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_points = max_points
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.epoch = 0
        self.start_s = 0.0  # the last iteration's worker start-up
        self.load_s: list[float] = []  # the last iteration's seconds per batch in its loader

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        # pad so every shard sees the same number of samples (DistributedSampler
        # semantics), then stride-shard across processes
        total = -(-n // self.num_shards) * self.num_shards
        if total > n:
            order = np.concatenate([order, order[: total - n]])
        return order[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        per_shard = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def _make_batches(self) -> Iterator[list[int]]:
        idx = self._epoch_indices()
        end = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)
        for start in range(0, end, self.batch_size):
            yield idx[start : start + self.batch_size].tolist()

    def _load_batch(self, indices: list[int], batch_index: int) -> dict:
        """Load one batch under its (seed, epoch, batch_index) random
        states: the pipeline's RandomState (the JAX loader seeds the global
        stream with the same value) and the collate's Generator."""
        ss = np.random.SeedSequence([self.seed, self.epoch, batch_index])
        pipeline_rng = np.random.RandomState(int(ss.generate_state(1)[0]))
        rng = np.random.default_rng(ss)
        samples = [self.dataset.get(i, pipeline_rng) for i in indices]
        return collate(samples, self.max_points, rng)

    def _timed_load(self, indices: list[int], batch_index: int) -> tuple[dict, float]:
        t0 = time.perf_counter()
        batch = self._load_batch(indices, batch_index)
        return batch, time.perf_counter() - t0

    def _worker_loop(self, batch_list, batch_ids, out_q):
        try:
            torch.set_num_threads(1)
            for bidx, idxs in zip(batch_ids, batch_list):
                out_q.put(("ok", *self._timed_load(idxs, bidx)))
            out_q.put(("done", None, 0.0))
        except Exception:
            out_q.put(("error", traceback.format_exc(), 0.0))

    def __iter__(self) -> Iterator[dict]:
        batches = list(self._make_batches())
        w = self.num_workers
        self.start_s, self.load_s = 0.0, []
        if w <= 0:
            for i, b in enumerate(batches):
                batch, seconds = self._timed_load(b, i)
                self.load_s.append(seconds)
                yield batch
            return

        # fork workers (dataset inherited by fork — nothing pickled on the
        # way in); worker j handles batches j, j+w, ...; the parent drains
        # queue (i mod w) so batches arrive in order while every worker
        # prefetches up to its queue bound ahead
        t0 = time.perf_counter()
        ctx = mp.get_context("fork")
        queues = [ctx.Queue(maxsize=4) for _ in range(w)]
        procs = [
            ctx.Process(
                target=self._worker_loop,
                args=(batches[j::w], list(range(j, len(batches), w)), queues[j]),
                daemon=True,
            )
            for j in range(w)
        ]
        for p in procs:
            p.start()
        self.start_s = time.perf_counter() - t0
        try:
            for i in range(len(batches)):
                tag, payload, seconds = _get(queues[i % w], procs[i % w])
                if tag == "error":
                    raise RuntimeError(f"dataloader worker failed:\n{payload}")
                self.load_s.append(seconds)
                yield payload
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)


def _get(q, proc, poll_s: float = 5.0):
    """The next item of a worker's queue; raise if the worker died without
    sending one (killed, e.g. out of host memory)."""
    while proc.is_alive():
        try:
            return q.get(timeout=poll_s)
        except queue.Empty:
            pass
    try:  # whatever it sent before it exited is in the pipe
        return q.get(timeout=poll_s)
    except queue.Empty:
        raise RuntimeError(f"dataloader worker died (exit code {proc.exitcode})") from None


def build_dataloader(
    dataset, batch_size: int, max_points: int, shuffle: bool, num_workers: int = 0, seed: int = 0
) -> DataLoader:
    """Reference-shaped builder (build_loader.py:8-27); one shard per
    process of an initialised ``torch.distributed`` group, else one."""
    dist = torch.distributed
    distributed = dist.is_available() and dist.is_initialized()
    return DataLoader(
        dataset,
        batch_size=batch_size,
        max_points=max_points,
        shuffle=shuffle,
        seed=seed,
        num_shards=dist.get_world_size() if distributed else 1,
        shard_index=dist.get_rank() if distributed else 0,
        num_workers=num_workers,
    )
