"""``tools/train_breakdown.py``'s truncated models against JAX's (CPU).

Each row of ``train_breakdown.ROWS`` builds the narrowed flagship (+-8 m,
0.25 m pillars, narrow widths, one block a stage, f32) cut by
``truncated_config``, in train mode, in both packages with one draw of
variables (``load_jax_variables``), on one batch of 2 ``lidar_like_points``
scenes: the loss ``sum(out ** 2)`` of the reader's table or of
``extract_feat`` (the all-sparse train path) and the sum of |gradients|
over every parameter lie within 1e-4 (relative, f32) of JAX's, whose
gradient is ``jax.value_and_grad`` of the same loss.  The
``remat_save_conv_out=false`` row (only the replay's policy differs) gives
the ``+neck`` row's bits in the port.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu_torch.tools import train_breakdown
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES, PC
from tests.test_torch_port_train import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

NARROW = [*OVERRIDES, "model.backbone.layer_nums=[1,1,1,1]"]
NO_SAVE = "+neck, remat_save_conv_out=false"


def _jax_row(cfg, reader_only, pts, mask):
    """(variables, the lowered ``jax.value_and_grad`` of JAX's truncated
    model's loss, its arguments)."""
    jmodel = jax_builders.build_model(cfg, train=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
    variables = random_variables(shapes, 0)

    def method(mdl, p, m, train):
        return mdl.reader(p, m, train).table if reader_only else mdl.extract_feat(p, m, train)

    def loss_fn(params, v, p, m):
        out, _ = jmodel.apply({**v, "params": params}, p, m, True, method=method,
                              mutable=["batch_stats", "telemetry"])
        return jnp.sum(out.astype(jnp.float32) ** 2)

    args = (variables["params"], variables, jnp.asarray(pts), jnp.asarray(mask))
    return variables, jax.jit(jax.value_and_grad(loss_fn)).lower(*args), args


def _jax_figures(lowered, args):
    """(loss, sum of |grad|) of a lowered row, compiled and run."""
    loss, grads = lowered.compile()(*args)
    return float(loss), float(sum(np.abs(np.asarray(g, np.float64)).sum() for g in jax.tree.leaves(grads)))


@pytest.fixture(scope="module")
def rows():
    """Each row: (port loss, port sum of |grad|, JAX loss, JAX sum of
    |grad|); JAX's figures of the no-save row are the ``+neck`` row's.
    JAX's rows are traced one after another and compiled together on a
    thread each (XLA's compiler leaves the interpreter free): most of the
    file's time is JAX tracing and compiling the six truncated models."""
    pts, mask = lidar_like_points(2, 3000, PC, seed=0)
    cfgs, jax_rows = {}, {}
    for name, stages, with_neck, reader_only, row_overrides in train_breakdown.ROWS:
        cfgs[name] = train_breakdown.truncated_config(
            load_experiment(FLAGSHIP, [*NARROW, *row_overrides])["model"], stages, with_neck)
        if name != NO_SAVE:
            jax_rows[name] = _jax_row(cfgs[name], reader_only, pts, mask)
    with ThreadPoolExecutor(len(jax_rows)) as pool:
        figures = dict(zip(jax_rows, pool.map(lambda row: _jax_figures(*row[1:]), jax_rows.values())))
    figures[NO_SAVE] = figures["+neck"]
    out = {}
    for name, _, _, reader_only, _ in train_breakdown.ROWS:
        variables = jax_rows[name if name != NO_SAVE else "+neck"][0]
        model = load_jax_variables(build_model(cfgs[name], device="cpu", train=True), variables)
        loss = train_breakdown.forward_loss(model, torch.from_numpy(pts), torch.from_numpy(mask), reader_only)
        loss.backward()
        out[name] = (float(loss.detach()), train_breakdown.grad_abs_sum(model), *figures[name])
    return out


@pytest.mark.parametrize("row", [r[0] for r in train_breakdown.ROWS])
def test_train_breakdown_rows_match_jax(row, rows):
    loss, gsum, jloss, jsum = rows[row]
    assert jloss > 0 and jsum > 0
    assert abs(loss - jloss) <= 1e-4 * jloss, (loss, jloss)
    assert abs(gsum - jsum) <= 1e-4 * jsum, (gsum, jsum)


def test_train_breakdown_no_save_conv_out_row_is_the_default_row(rows):
    assert rows[NO_SAVE][:2] == rows["+neck"][:2]
