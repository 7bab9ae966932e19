"""``utils.moderate`` on 2 gloo ranks on the CPU: one train step each.

The port's counterpart of tests/test_multidevice_sparse_scale.py: the
384^2 all-sparse detector over ``beam_batch`` (one 20k-point scene a
rank), synced BatchNorm, one step of the data-parallel ``train_step``,
once per backbone variant (the per-site stride-1 stage, and
``tile_stride1``).  Every ``*_overflow`` counter is 0 on both ranks, the
stage-0 table holds thousands of active sites (more than 2,000, as JAX's
test requires), the loss is finite, and both ranks hold the same
parameters and statistics after the step.  ``beam_batch`` equals JAX's bit
for bit.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tests import torch_dist_worker as dist_worker
from tests.torch_threads import one_torch_thread  # noqa: F401

VARIANTS = {"per_site": {}, "tile_stride1": {"tile_stride1": True}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {name: {"kind": "moderate", "backbone": backbone, "batch": 2, "n_points": 20_000}
             for name, backbone in VARIANTS.items()}
    out = tmp_path_factory.mktemp("moderate")
    return dist_worker.collect(dist_worker.spawn({"cases": cases}, out), out, timeout_s=240)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moderate_two_rank_step(ranks, variant):
    results = [r[variant] for r in ranks]
    for r in results:
        assert "error" not in r, r.get("error")
        tel = r["telemetry"]
        overflow = {k: v for k, v in tel.items() if k.endswith("_overflow")}
        assert overflow and all(v == 0 for v in overflow.values()), tel
        assert r["overflow"] == 0
        assert tel["pillar_active"] > 2000, tel
        assert math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
        if variant == "tile_stride1":
            assert tel["stage0_tiles384_active"] > 0, tel
    a, b = (r["state"] for r in results)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_beam_batch_matches_jax():
    from pillarnext_tpu.utils.moderate import beam_batch as jax_beam_batch
    from pillarnext_tpu_torch.utils.moderate import beam_batch

    got, want = beam_batch(batch=2, n_points=3000, seed=1), jax_beam_batch(batch=2, n_points=3000, seed=1)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], (list, tuple)):
            assert len(got[k]) == len(want[k])
            for x, y in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
