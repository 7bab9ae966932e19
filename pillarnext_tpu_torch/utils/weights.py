"""Weights for the port: seeded random initialisation and the JAX bridge.

The bridge carries the JAX package's ``{params, batch_stats}`` (numpy
arrays) into the port's ``state_dict`` through the port's numpy-only
``utils/torch_import`` exporters (``export_pillarnext`` for the pillar
reader, ``export_voxelnext`` for the voxel reader, ``export_mvfnext`` for
the MVF reader), which write the reference checkpoint schema the port's
modules use.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from pillarnext_tpu_torch.models.layers import BatchNorm
from pillarnext_tpu_torch.models.mvf_encoder import MVFFeatureNet
from pillarnext_tpu_torch.models.voxel_encoder import VoxelFeatureNet
from pillarnext_tpu_torch.utils.torch_import import export_mvfnext, export_pillarnext, export_voxelnext


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight from ``generator``: conv (2-D and 3-D) and linear
    kernels N(0, 1/fan_in) (lecun normal, as the JAX package initialises), the ASPP
    shared kernel N(0, 1) (the reference uses randn), biases 0 except the
    branches' final bias (the heatmap's init bias), BN at identity."""
    from pillarnext_tpu_torch.models.aspp import ASPPNeck
    from pillarnext_tpu_torch.models.centerhead import MLPHead

    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            cpu = torch.zeros(p.shape, dtype=torch.float32)
            if isinstance(module, ASPPNeck):
                cpu.normal_(0.0, 1.0, generator=generator)
            elif p.dim() >= 2:
                # ConvTranspose2d stores (I, O, kh, kw), the others (O, I, ...)
                fan_in = p.shape[0 if isinstance(module, nn.ConvTranspose2d) else 1]
                fan_in *= math.prod(p.shape[2:])
                cpu.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            p.copy_(cpu)
        if isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    for module in model.modules():  # after the children's biases were zeroed
        if isinstance(module, MLPHead):
            module[-1].bias.fill_(module.final_bias)


def state_dict_from_jax(model: nn.Module, params, batch_stats) -> dict[str, torch.Tensor]:
    """The port's state_dict for a pillar (flagship-structured), voxel
    (voxel18-structured) or MVF (mvf18-structured) detector from JAX
    ``params`` / ``batch_stats`` trees of numpy-convertible arrays; the
    reader's type picks the exporter."""
    head = model.head
    neck_head = dict(tasks=head.class_names, common_heads=head.common_heads,
                     num_hm_conv=head.num_hm_conv)
    if isinstance(model.reader, MVFFeatureNet):
        sd = export_mvfnext(
            params, batch_stats, num_filters=model.reader.num_filters,
            layer_nums=model.reader.layer_nums, **neck_head,
        )
    elif isinstance(model.reader, VoxelFeatureNet):
        sd = export_voxelnext(
            params, batch_stats, layer_nums=model.backbone.layer_nums,
            ds_layer_strides=model.backbone.strides, **neck_head,
        )
    else:
        sd = export_pillarnext(
            params, batch_stats, num_filters=model.reader.num_filters,
            layer_nums=model.backbone.layer_nums, **neck_head,
        )
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Load ``{"params": ..., "batch_stats": ...}`` into ``model`` with
    ``strict=True`` (every key present, none left over)."""
    sd = state_dict_from_jax(model, variables["params"], variables["batch_stats"])
    model.load_state_dict(sd, strict=True)
    return model
