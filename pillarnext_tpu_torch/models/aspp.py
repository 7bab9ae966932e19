"""ASPP neck with one shared dilated 3x3 kernel.

Counterpart of ``ASPPNeck`` (pillarnext_tpu/models/aspp.py:23-62), eval:
BasicBlock; branches [input, 1x1 conv, the shared 3x3 kernel
``neck.weight`` at dilations 1/6/12/18]; concat (6C) -> 1x1 ConvBlock.
NHWC in and out.  In training the whole neck is recomputed in the
backward, as JAX remats it (aspp.py:59-62): it keeps only its input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pillarnext_tpu_torch.models.layers import BasicBlock, ConvBlock, conv2d, recomputed

DILATIONS = (1, 6, 12, 18)


def dilated_conv3x3(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """3x3 conv with dilation ``d`` and zero padding ``d`` (NCHW), evaluated
    as an undilated 3x3 conv over the d x d phase sub-grids of the input
    padded to a multiple of ``d``: output row d*q + r reads input rows
    d*(q + a - 1) + r, i.e. row q + a - 1 of sub-grid r.  Same taps and
    sums; cuDNN runs large dilations as a slow direct kernel."""
    if d == 1:
        return F.conv2d(x, w, padding=1)
    b, c, h, wd = x.shape
    hq, wq = -(-h // d), -(-wd // d)
    x = F.pad(x, (0, wq * d - wd, 0, hq * d - h))
    x = x.reshape(b, c, hq, d, wq, d).permute(0, 3, 5, 1, 2, 4).reshape(b * d * d, c, hq, wq)
    y = F.conv2d(x.contiguous(memory_format=torch.channels_last), w, padding=1)
    co = y.shape[1]
    y = y.reshape(b, d, d, co, hq, wq).permute(0, 3, 4, 1, 5, 2).reshape(b, co, hq * d, wq * d)
    return y[:, :, :h, :wd]


class ASPPNeck(nn.Module):
    def __init__(self, in_channels: int, dtype: torch.dtype | None = None):
        super().__init__()
        c = in_channels
        self.pre_conv = BasicBlock(c)
        self.conv1x1 = nn.Conv2d(c, c, 1, bias=False)
        self.weight = nn.Parameter(torch.randn(c, c, 3, 3))
        self.post_conv = ConvBlock(c * 6, c, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return recomputed(self, x, forward=ASPPNeck._forward)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_conv(x.permute(0, 3, 1, 2))
        w = self.weight.to(x.dtype)
        branches = [x, conv2d(x, self.conv1x1)]
        branches += [dilated_conv3x3(x, w, d) for d in DILATIONS]
        return self.post_conv(torch.cat(branches, dim=1)).permute(0, 2, 3, 1)
