"""The port's per-block recompute in training against the same block
called bare, on the CPU.

JAX remats every sparse block in training under a policy that saves each
sparse conv's output (``remat_save_conv_out``, the default;
pillarnext_tpu/models/resnet.py:183-192), every tile block with no policy
(:384-385) and the whole ASPP neck (aspp.py:59-62).  For each block kind
(2-D SubM conv and residual blocks, the strided block, the tile blocks,
the 3-D SubM and strided blocks, the neck), with the policy on and off:

- the output, the input's gradient and every parameter's gradient are
  bitwise equal to the bare block's;
- the BatchNorm running statistics are updated once (they equal the bare
  block's after one step);
- the block keeps fewer bytes for its backward: what ``saved_tensors_hooks``
  packs plus the sparse convs' outputs it holds
  (``layers.ConvOutputs``) comes to its tensor inputs without the policy
  and to those plus one (rows, Cout) output per sparse conv with it, where
  the bare block packs every activation.

And a training forward of each backbone recomputes every block JAX remats,
with JAX's policy, and no other.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from pillarnext_tpu_torch.models import aspp as aspp_mod
from pillarnext_tpu_torch.models import layers
from pillarnext_tpu_torch.models import resnet
from pillarnext_tpu_torch.models.aspp import ASPPNeck
from pillarnext_tpu_torch.models.layers import (
    BatchNorm,
    ConvBlock,
    ResidualBlock,
    SparseConvBlock3d,
    SparseResidualBlock3d,
)
from pillarnext_tpu_torch.ops.sparse_down import build_down_neighbor_tables, downsample_active_set
from pillarnext_tpu_torch.ops.subm_conv import build_neighbor_table, subm_offsets_2d, subm_offsets_3d
from pillarnext_tpu_torch.ops.tile_subm import build_tile_map, pack_stack
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES
from tests.test_torch_port_voxel_e2e import OVERRIDES as VOXEL_OVERRIDES
from tests.test_torch_port_voxel_e2e import VOXEL18
from tests.torch_threads import one_torch_thread  # noqa: F401

C = 8


def active_set(batch, spatial, density, seed):
    """(slot_of_dense, slot_id, valid, cap) of a random active set with
    five unused slots."""
    g = torch.Generator().manual_seed(seed)
    cells = batch * int(np.prod(spatial))
    occ = torch.rand(cells, generator=g) < density
    n = int(occ.sum())
    cap = n + 5
    slot_id = torch.full((cap,), cells, dtype=torch.int32)
    slot_id[:n] = torch.nonzero(occ)[:, 0].int()
    sod = torch.full((cells,), cap, dtype=torch.int32)
    sod[slot_id[:n].long()] = torch.arange(n, dtype=torch.int32)
    return sod, slot_id, torch.arange(cap) < n, cap


def table(valid, channels, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.where(valid[:, None], torch.randn(valid.shape[0], channels, generator=g), 0.0)


def randomised(module, seed):
    """``module`` with every parameter and BN statistic drawn from a seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return module.train()


def block_2d(seed=0):
    batch, spatial = 2, (16, 16)
    sod, slot_id, valid, cap = active_set(batch, spatial, 0.3, seed)
    nbr = build_neighbor_table(sod, slot_id, spatial, subm_offsets_2d(3), cap)
    return batch, spatial, sod, slot_id, valid, cap, nbr


def case(kind):
    """(forward, block, differentiable input, other args, each sparse
    conv's output elements: rows x Cout)."""
    if kind in ("subm2d_conv", "subm2d_residual"):
        _, _, _, _, valid, cap, nbr = block_2d()
        x = table(valid, C, 1)
        if kind == "subm2d_conv":
            return resnet.sparse_conv_block, ConvBlock(C, C, 3), x, (valid, nbr), [cap * C]
        return resnet.sparse_residual_block, ResidualBlock(C, 3), x, (valid, nbr), [cap * C] * 2
    if kind == "strided2d":
        batch, spatial, sod, slot_id, valid, cap, _ = block_2d()
        out_slot_id, _, out_valid, _, _ = downsample_active_set(sod, cap, batch, spatial, (3, 3), (2, 2), 200)
        fwd, rev = build_down_neighbor_tables(sod, out_slot_id, slot_id, batch, spatial, (3, 3), (2, 2))
        return (resnet.sparse_strided_block, ConvBlock(C, 2 * C, 3, stride=2), table(valid, C, 1),
                (out_valid, fwd, rev), [200 * 2 * C])
    if kind in ("tile_conv", "tile_residual"):
        batch, spatial, sod, slot_id, valid, cap, _ = block_2d()
        tm = build_tile_map(sod, slot_id, batch, spatial, cap, 8, 0)
        stack = pack_stack(torch.cat([table(valid, C, 1), torch.zeros(1, C)]), tm, plain=True)
        if kind == "tile_conv":
            return resnet.tile_conv_block, ConvBlock(C, C, 3), stack, (tm, True), []
        return resnet.tile_residual_block, ResidualBlock(C, 3), stack, (tm, True), []
    if kind in ("subm3d_conv", "subm3d_residual", "strided3d"):
        batch, spatial = 2, (6, 10, 10)
        sod, slot_id, valid, cap = active_set(batch, spatial, 0.2, 2)
        x = table(valid, C, 3)
        if kind == "strided3d":
            k3, s3 = (3, 3, 3), (2, 2, 2)
            out_slot_id, _, out_valid, _, _ = downsample_active_set(sod, cap, batch, spatial, k3, s3, 150)
            fwd, rev = build_down_neighbor_tables(sod, out_slot_id, slot_id, batch, spatial, k3, s3)
            return (resnet.sparse_strided_block, SparseConvBlock3d(C, 2 * C, 3, stride=2), x,
                    (out_valid, fwd, rev), [150 * 2 * C])
        nbr = build_neighbor_table(sod, slot_id, spatial, subm_offsets_3d(3), cap)
        if kind == "subm3d_conv":
            return resnet.sparse_conv_block, SparseConvBlock3d(C, C, 3), x, (valid, nbr), [cap * C]
        return resnet.sparse_residual_block, SparseResidualBlock3d(C, 3), x, (valid, nbr), [cap * C] * 2
    assert kind == "aspp"
    g = torch.Generator().manual_seed(4)
    return ASPPNeck._forward, ASPPNeck(C), torch.randn(2, 12, 12, C, generator=g), (), []


def storage_bytes(tensors) -> int:
    unique = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return sum(unique.values())


def run(forward, block, x0, args, remat, monkeypatch):
    """Forward, backward of a fixed cotangent; returns the output, the
    gradients, the state after the step and the bytes kept for the
    backward."""
    block = copy.deepcopy(block)
    stores = []

    class Counted(layers.ConvOutputs):
        def __init__(self):
            super().__init__()
            stores.append(self)

    monkeypatch.setattr(layers, "ConvOutputs", Counted)
    x = x0.clone().requires_grad_()
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t):
        y = resnet.run_block(forward, block, x, *args, remat=remat)
    kept = storage_bytes([t for t in packed if t.numel()]) + sum(s.nbytes for s in stores)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
    (y * g).sum().backward()
    grads = {k: p.grad for k, p in block.named_parameters()}
    return y.detach(), x.grad, grads, {k: v.clone() for k, v in block.state_dict().items()}, kept


KINDS = ["subm2d_conv", "subm2d_residual", "strided2d", "tile_conv", "tile_residual",
         "subm3d_conv", "subm3d_residual", "strided3d", "aspp"]


@pytest.mark.parametrize("save_conv_out", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_recomputed_block_matches_bare(kind, save_conv_out, monkeypatch):
    forward, block, x0, args, conv_outs = case(kind)
    block = randomised(block, 5)
    before = {k: v.clone() for k, v in block.state_dict().items()}
    y, dx, grads, state, kept_bare = run(forward, block, x0, args, None, monkeypatch)
    ry, rdx, rgrads, rstate, kept = run(forward, block, x0, args, save_conv_out, monkeypatch)
    assert torch.equal(ry, y)
    assert torch.equal(rdx, dx)
    assert grads.keys() == rgrads.keys() and len(grads) > 0
    for k in grads:
        assert torch.equal(rgrads[k], grads[k]), k
    for k in state:
        assert torch.equal(rstate[k], state[k]), k
    changed = [k for k in state if "running" in k and not torch.equal(state[k], before[k])]
    assert changed, "the step updated no BN statistic"
    inputs = storage_bytes([x0] + [a for a in args if isinstance(a, torch.Tensor)])
    conv_bytes = sum(conv_outs) * x0.element_size() if save_conv_out else 0
    assert kept == inputs + conv_bytes
    assert kept < kept_bare


def test_train_forward_of_aspp_is_recomputed(monkeypatch):
    calls = []
    real = aspp_mod.recomputed
    monkeypatch.setattr(aspp_mod, "recomputed", lambda *a, **k: calls.append(k) or real(*a, **k))
    neck = randomised(ASPPNeck(C), 5)
    x = torch.randn(2, 12, 12, C, generator=torch.Generator().manual_seed(4))
    bare = copy.deepcopy(neck)._forward(x)
    assert torch.equal(neck(x), bare)
    assert calls == [{"forward": ASPPNeck._forward}]
    neck.eval()
    neck(x)
    assert len(calls) == 1


# (overrides, the (block forward, policy) each recomputed call runs); the
# narrowed flagship's backbone is layer_nums [2, 2, 2, 2], strides
# [1, 2, 2, 2]; voxel18's [1, 1, 1, 1] (its stage 0 a SubM conv block)
SUBM, RES, DOWN = resnet.sparse_conv_block, resnet.sparse_residual_block, resnet.sparse_strided_block
TILE, TILE_RES = resnet.tile_conv_block, resnet.tile_residual_block
BACKBONES = {
    "all": ([], [(SUBM, True)] + [(RES, True)] * 2 + ([(DOWN, True)] + [(RES, True)] * 2) * 3),
    "all_no_save_conv_out": (["+model.backbone.remat_save_conv_out=false"],
                             [(SUBM, False)] + [(RES, False)] * 2 + ([(DOWN, False)] + [(RES, False)] * 2) * 3),
    "leading": (["+model.backbone.sparse_stages_train=leading"], [(SUBM, True)] + [(RES, True)] * 2),
    "leading+down": (["+model.backbone.sparse_stages_train=leading+down"], [(SUBM, True)] + [(RES, True)] * 2),
    "tile": (["+model.backbone.sparse_stages_train=tile"], [(TILE, False)] + [(TILE_RES, False)] * 2),
    "tile_stride1": (["+model.backbone.tile_stride1=true"],
                     [(TILE, False)] + [(TILE_RES, False)] * 2 + ([(DOWN, True)] + [(RES, True)] * 2) * 3),
}


def recorded_train_forward(monkeypatch, path, overrides):
    """The (forward, policy) of each ``recomputed`` call of a training
    forward through the reader and backbone, and the backbone."""
    calls = []
    real = resnet.recomputed
    monkeypatch.setattr(resnet, "recomputed",
                        lambda *a, **k: calls.append((k.get("forward"), k.get("save_conv_out")))
                        or real(*a, **k))
    cfg = load_experiment(path, overrides)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    pc = cfg["model"]["reader"]["pc_range"]
    pts, mask = lidar_like_points(1, 1500, pc, seed=0)
    model.backbone(model.reader(torch.from_numpy(pts), torch.from_numpy(mask)))
    return calls, model.backbone


@pytest.mark.parametrize("mode", list(BACKBONES))
def test_train_forward_recomputes_the_blocks_jax_remats(mode, monkeypatch):
    overrides, want = BACKBONES[mode]
    calls, _ = recorded_train_forward(monkeypatch, FLAGSHIP, OVERRIDES + overrides)
    # the masked-dense tail's blocks (remat_train) recompute with no forward given
    assert [c for c in calls if c[0] is not None] == want


@pytest.mark.parametrize("save_conv_out", [True, False])
def test_voxel_train_forward_recomputes_its_subm_blocks(save_conv_out, monkeypatch):
    calls, backbone = recorded_train_forward(
        monkeypatch, VOXEL18, VOXEL_OVERRIDES + [f"+model.backbone.remat_save_conv_out={str(save_conv_out).lower()}"])
    assert backbone.strides[0] == 1 and all(s > 1 for s in backbone.strides[1:])
    assert calls == [(SUBM, save_conv_out)] + [(RES, save_conv_out)] * sum(backbone.layer_nums)
