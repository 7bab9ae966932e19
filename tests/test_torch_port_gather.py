"""The port's row gather and densify vs the JAX package, bit-exact (CPU).

CPU tensors take the plain version of kernel 2 (``index_select`` on a
zero-padded table); it must equal JAX ``monotone_row_gather`` in interpret
mode and JAX ``densify`` bit for bit, sentinel indices included.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.ops.densify import densify as jax_densify
from pillarnext_tpu.ops.pallas_gather import monotone_row_gather as jax_gather
from pillarnext_tpu_torch.ops.densify import densify
from pillarnext_tpu_torch.ops.gather import monotone_row_gather
from pillarnext_tpu_torch.ops.scatter import gather_segments
from tests.torch_threads import one_torch_thread  # noqa: F401


def _monotone_stream(rng, m, r, sentinel_frac):
    """Non-decreasing real entries (steps of 0/1) plus sentinels >= r."""
    is_real = rng.random(m) >= sentinel_frac
    reals = np.minimum(np.cumsum(rng.integers(0, 2, int(is_real.sum()))), r - 1)
    idx = np.full(m, r, np.int64)
    idx[is_real] = reals
    idx[~is_real] = r + rng.integers(0, 3, int((~is_real).sum()))  # sentinels >= r
    return idx.astype(np.int32)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,r,c", [(2048, 700, 64), (800, 259, 8), (300, 50, 3)])
def test_row_gather_matches_jax_interpret(dtype, m, r, c):
    rng = np.random.default_rng(m + r + c)
    table = rng.standard_normal((r, c)).astype(np.float32)
    idx = _monotone_stream(rng, m, r, 0.4)
    jt = jnp.asarray(table, getattr(jnp, dtype))
    want = np.asarray(jax_gather(jt, jnp.asarray(idx), interpret=True), np.float32)
    got = monotone_row_gather(
        torch.from_numpy(table).to(getattr(torch, dtype)), torch.from_numpy(idx)
    )
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_as_numpy(got), want)


def test_row_gather_any_order_and_negative_indices():
    """The CUDA kernel assumes no order, so neither does its plain version:
    a shuffled stream equals the row-wise definition, negatives give 0."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((100, 16)).astype(np.float32)
    idx = rng.integers(-5, 110, 500).astype(np.int32)
    got = monotone_row_gather(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    want = np.where(((idx >= 0) & (idx < 100))[:, None], table[np.clip(idx, 0, 99)], 0.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_densify_matches_jax(dtype):
    rng = np.random.default_rng(5)
    rows, cap, c = 8192, 900, 24
    active = np.sort(rng.choice(rows, cap - 100, replace=False))
    slot_of_dense = np.full(rows, cap, np.int32)
    slot_of_dense[active] = np.arange(cap - 100)
    slot_id = np.full(cap, rows, np.int32)
    slot_id[: cap - 100] = active
    table = np.concatenate([rng.standard_normal((cap, c)), np.zeros((1, c))]).astype(np.float32)
    want = np.asarray(
        jax_densify(
            jnp.asarray(table, getattr(jnp, dtype)), jnp.asarray(slot_of_dense), jnp.asarray(slot_id)
        ),
        np.float32,
    )
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    sod, sid = torch.from_numpy(slot_of_dense), torch.from_numpy(slot_id)
    got = densify(tt, sod, sid)
    np.testing.assert_array_equal(_as_numpy(got), want)
    np.testing.assert_array_equal(_as_numpy(densify(tt, sod, sid, plain=True)), want)


def test_gather_segments_zero_dump_row():
    """Every id reads its row of the table, the dump row too, zero or not
    (JAX's ``jnp.take``: an overflowed table's dump row holds the
    overflowed points' value, and they read it back)."""
    rng = np.random.default_rng(9)
    for dump in (np.zeros((1, 3)), rng.standard_normal((1, 3))):
        table = np.concatenate([rng.standard_normal((40, 3)), dump]).astype(np.float32)
        seg = np.sort(rng.integers(0, 41, 300)).astype(np.int32)
        assert (seg == 40).any()
        t, s = torch.from_numpy(table), torch.from_numpy(seg)
        np.testing.assert_array_equal(gather_segments(t, s).numpy(), table[seg])
        np.testing.assert_array_equal(gather_segments(t, s, plain=True).numpy(), table[seg])
