"""Shared eval-mode building blocks.

Counterpart of pillarnext_tpu/models/layers.py.  Modules run NCHW inside
(an NHWC tensor permuted to NCHW is already ``channels_last`` in memory,
which cuDNN prefers); parameters stay float32 and are cast to the
activation dtype at use, as flax does.  The reader casts its features to
``model.dtype``; every later module computes in the dtype of its input, so
their ``dtype`` arguments only keep one config valid for both packages.
Submodule names follow the
reference checkpoint schema (``conv``/``norm``, ``block1``/``conv2``/
``norm2``), the layout ``export_pillarnext`` writes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS_SPARSE = 1e-3  # PFN + backbone blocks
BN_EPS_DENSE = 1e-5   # neck / head blocks


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm, folded to ``x * inv + shift`` in ``x.dtype``
    (layers.py:276-282): ``inv = rsqrt(var + eps) * scale`` and
    ``shift = bias - mean * inv`` in float32, rounded once to x's dtype.
    State: weight, bias, running_mean, running_var (no batch counter)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        inv, shift = self.folded()
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied with its weight (and bias) cast to x's dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(
        x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding, conv.dilation
    )


class ConvBlock(nn.Module):
    """Conv (no bias) + BN + ReLU with symmetric padding ``k // 2 *
    dilation`` (layers.py:68-125); with ``mask`` (B, 1, H, W) the output is
    re-zeroed outside the active set."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, dilation=1, eps=BN_EPS_DENSE):
        super().__init__()
        self.conv = nn.Conv2d(
            in_ch, out_ch, kernel_size, stride,
            padding=(kernel_size // 2) * dilation, dilation=dilation, bias=False,
        )
        self.norm = BatchNorm(out_ch, eps)

    def forward(self, x, mask=None):
        x = torch.relu(self.norm(conv2d(x, self.conv)))
        return x if mask is None else x * mask


class ResidualBlock(nn.Module):
    """conv+BN+ReLU -> conv+BN -> +identity -> ReLU (layers.py:128-174)."""

    def __init__(self, ch, kernel_size=3, eps=BN_EPS_SPARSE):
        super().__init__()
        self.block1 = ConvBlock(ch, ch, kernel_size, eps=eps)
        self.conv2 = nn.Conv2d(ch, ch, kernel_size, padding=kernel_size // 2, bias=False)
        self.norm2 = BatchNorm(ch, eps)

    def forward(self, x, mask=None):
        y = self.norm2(conv2d(self.block1(x, mask), self.conv2))
        y = torch.relu(y + x)
        return y if mask is None else y * mask


class BasicBlock(nn.Module):
    """Two ConvBlocks with a residual skip (layers.py:177-200)."""

    def __init__(self, ch, kernel_size=3, eps=BN_EPS_DENSE):
        super().__init__()
        self.block1 = ConvBlock(ch, ch, kernel_size, eps=eps)
        self.block2 = ConvBlock(ch, ch, kernel_size, eps=eps)

    def forward(self, x):
        return torch.relu(self.block2(self.block1(x)) + x)


class ConvTransposeBlock(nn.Module):
    """ConvTranspose (stride = kernel, no bias) + BN + ReLU
    (layers.py:203-231)."""

    def __init__(self, in_ch, out_ch, stride, eps=BN_EPS_DENSE):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, stride, stride=stride, bias=False)
        self.norm = BatchNorm(out_ch, eps)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.conv.weight.to(x.dtype), stride=self.conv.stride)
        return torch.relu(self.norm(y))
