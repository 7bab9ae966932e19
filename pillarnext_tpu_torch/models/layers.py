"""Shared building blocks, eval and train.

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

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pillarnext_tpu_torch import parallel
from pillarnext_tpu_torch.ops.subm_conv import ConvOutputs, keeping, replaying

BN_EPS_SPARSE = 1e-3  # PFN + backbone blocks
BN_EPS_DENSE = 1e-5   # neck / head blocks
# flax momenta: the running statistics decay by ``momentum`` per step
BN_MOMENTUM_SPARSE = 0.99
BN_MOMENTUM_DENSE = 0.9


class BatchNorm(nn.Module):
    """BatchNorm with the JAX package's semantics.

    Eval: folded to ``x * inv + shift`` in ``x.dtype`` (layers.py:276-282):
    ``inv = rsqrt(var + eps) * scale`` and ``shift = bias - mean * inv`` in
    float32, rounded once to x's dtype.

    Train (``self.training``): statistics of the batch in float32, biased
    variance ``E[x^2] - mean^2`` clamped at 0.  With ``valid`` (a bool mask
    over the rows) only valid rows count and the output is folded as in
    eval — ``MaskedBatchNorm`` (layers.py:234-282); without it every row
    counts and the output is ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, computed in float32 and rounded to x's dtype — flax
    ``nn.BatchNorm``.  The running statistics update as
    ``m * running + (1 - m) * batch`` with the biased variance (not torch's
    unbiased one), unless ``update_statistics`` is off (a recomputed
    forward, ``statistics_frozen``).  State: weight, bias, running_mean,
    running_var (no batch counter).

    ``sync`` (the config's ``sync_batchnorm``, set on a train model by
    utils/builders.build_model): in training, with a process group, the
    statistics are those of every rank's rows, JAX's global-batch
    statistics — one differentiable all-reduce of the stacked
    ``(Σx·m, Σx²·m, Σm)`` (``m = 1`` without ``valid``), issued at world
    size 1 too.  A recomputed forward all-reduces again, in the same order
    on every rank."""

    def __init__(self, channels: int, eps: float, momentum: float):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_statistics = True
        self.sync = False
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if not self.update_statistics:
            return
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor, channel_dim: int = 1, valid=None) -> torch.Tensor:
        return BatchNorm._normalise([self], x, channel_dim, valid)

    @staticmethod
    def concatenated(norms: list, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        """One BatchNorm over ``x`` whose channels are those of ``norms``
        in order (a merged head's concatenated branches or tasks), every
        row counting: flax ``nn.BatchNorm`` over the concatenation.  The
        statistics are per channel, so each norm's share equals its own
        forward's; in training each norm's share of the batch statistics
        updates its own running buffers, and under ``sync`` one all-reduce
        covers every channel.  Eval folds as ``forward`` does."""
        if len(norms) == 1:
            return norms[0](x, channel_dim)
        return BatchNorm._normalise(norms, x, channel_dim, None)

    @staticmethod
    def _normalise(norms: list, x: torch.Tensor, channel_dim: int, valid) -> torch.Tensor:
        """``forward`` over the channels of ``norms`` in order (one norm:
        its own tensors, nothing concatenated); the first norm's ``eps``,
        ``training`` and ``sync`` hold for all."""
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        cat = (lambda ts: ts[0]) if len(norms) == 1 else torch.cat
        weight = cat([n.weight for n in norms])
        bias = cat([n.bias for n in norms])
        first = norms[0]
        if not first.training:
            inv = torch.rsqrt(cat([n.running_var for n in norms]) + first.eps) * weight
            shift = bias - cat([n.running_mean for n in norms]) * inv
            return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)
        xf = x.float().movedim(channel_dim, -1).reshape(-1, x.shape[channel_dim])
        mean, var = first._statistics(xf, valid)
        start = 0
        for n in norms:
            stop = start + n.weight.shape[0]
            n._update(mean[start:stop], var[start:stop])
            start = stop
        if valid is None:
            mul = torch.rsqrt(var + first.eps) * weight
            y = (x.float() - mean.view(shape)) * mul.view(shape) + bias.view(shape)
            return y.to(x.dtype)
        inv = torch.rsqrt(var + first.eps) * weight
        shift = bias - mean * inv
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)

    def _statistics(self, xf: torch.Tensor, valid) -> tuple[torch.Tensor, torch.Tensor]:
        """Mean and biased variance of the rows of ``xf`` (the valid ones
        with ``valid``), over every rank's rows under ``sync``."""
        if self.sync and parallel.is_distributed():
            c = xf.shape[1]
            if valid is None:
                sums = [xf.sum(0), (xf * xf).sum(0), xf.new_full((1,), xf.shape[0])]
            else:
                m = valid.reshape(-1, 1).float()
                sums = [(xf * m).sum(0), (xf * xf * m).sum(0), m.sum().reshape(1)]
            total = parallel.all_reduce_sum(torch.cat(sums))
            cnt = torch.clamp(total[2 * c], min=1.0)
            mean = total[:c] / cnt
            return mean, torch.clamp(total[c:2 * c] / cnt - mean * mean, min=0.0)
        if valid is None:
            mean = xf.mean(0)
            return mean, torch.clamp((xf * xf).mean(0) - mean * mean, min=0.0)
        m = valid.reshape(-1, 1).float()
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(0) / cnt
        return mean, torch.clamp((xf * xf * m).sum(0) / cnt - mean * mean, min=0.0)


@contextlib.contextmanager
def statistics_frozen(module: nn.Module):
    """Inside the block, every BatchNorm of ``module`` leaves its running
    statistics alone; in train mode it still normalises by the batch's.
    A block recomputed in the backward (``torch.utils.checkpoint``) runs
    its forward twice, and only the first pass may update the statistics,
    as JAX's ``nn.remat`` keeps only the first pass's ``batch_stats``."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_statistics = False
    try:
        yield
    finally:
        for m in norms:
            m.update_statistics = True


def recomputed(block: nn.Module, *args, forward=None, save_conv_out: bool = False) -> torch.Tensor:
    """``forward(block, *args)`` (``block(*args)`` without ``forward``)
    that keeps only its inputs for the backward and runs the block again
    there (``torch.utils.checkpoint``, non-reentrant, as JAX's
    ``nn.remat``), with its BatchNorm statistics updated once, by the
    first pass.  ``save_conv_out`` (JAX's ``save_only_these_names(
    "sparse_conv_out")`` policy): the block also keeps each sparse conv's
    output, and the replay takes it back instead of gathering again
    (ops/subm_conv.py ``ConvOutputs``); the tap tables and masks are
    inputs, built once outside the block."""
    fn = block if forward is None else functools.partial(forward, block)

    def contexts():
        if not save_conv_out:
            return contextlib.nullcontext(), statistics_frozen(block)
        store = ConvOutputs()
        return keeping(store), _replay(block, store)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


@contextlib.contextmanager
def _replay(block: nn.Module, store: ConvOutputs):
    with statistics_frozen(block), replaying(store):
        yield


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied with its weight (and bias) cast to x's dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(
        x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding, conv.dilation
    )


def packed_down_weight(weight: torch.Tensor) -> torch.Tensor:
    """A stride-2 3x3 conv's weight (O, I, 3, 3) as the 2x2 conv over a
    2x2-packed input (O, 4I, 2, 2), packed channel ``(dy * 2 + dx) * I +
    c`` (layers.py:29-65): tap (a, b) reads input row 2y + a - 1, which
    lies in packed row y - 1 at dy = 1 for a = 0 and in packed row y at
    dy = a - 1 otherwise (columns alike)."""
    o, i = weight.shape[:2]
    k2 = weight.new_zeros((o, 2, 2, 4, i))  # (O, ka, kb, dy * 2 + dx, I)
    for a in range(3):
        ka, dy = (0, 1) if a == 0 else (1, a - 1)
        for b in range(3):
            kb, dx = (0, 1) if b == 0 else (1, b - 1)
            k2[:, ka, kb, dy * 2 + dx] = weight[:, :, a, b]
    return k2.reshape(o, 2, 2, 4 * i).permute(0, 3, 1, 2)


def packed_down_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (3x3, stride 2, padding 1) of an image given 2x2-packed,
    (B, 4C, H/2, W/2): the 2x2 conv of ``packed_down_weight`` with padding
    1 before and 0 after each axis, the same sums as the strided conv."""
    w = packed_down_weight(conv.weight).to(x.dtype)
    return F.conv2d(F.pad(x, (1, 0, 1, 0)), w)


class ConvBlock(nn.Module):
    """Conv (no bias) + BN + ReLU with symmetric padding ``k // 2 *
    dilation`` (layers.py:68-125); with ``mask`` (B, 1, H, W) the training
    statistics are those of the active cells (``MaskedBatchNorm``) and the
    output is re-zeroed outside the active set.  ``forward(...,
    packed=True)`` takes the input 2x2-packed and runs a stride-2 3x3 conv
    as ``packed_down_conv`` (the same ``conv.weight``)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, dilation=1, eps=BN_EPS_DENSE,
                 momentum=BN_MOMENTUM_DENSE):
        super().__init__()
        self.conv = nn.Conv2d(
            in_ch, out_ch, kernel_size, stride,
            padding=(kernel_size // 2) * dilation, dilation=dilation, bias=False,
        )
        self.norm = BatchNorm(out_ch, eps, momentum)

    def forward(self, x, mask=None, packed: bool = False):
        if packed:
            if self.conv.kernel_size != (3, 3) or self.conv.stride != (2, 2) or self.conv.dilation != (1, 1):
                raise ValueError("a packed input takes a 3x3 stride-2 conv")
            y = packed_down_conv(x, self.conv)
        else:
            y = conv2d(x, self.conv)
        x = torch.relu(self.norm(y, valid=mask))
        return x if mask is None else x * mask


class ResidualBlock(nn.Module):
    """conv+BN+ReLU -> conv+BN -> +identity -> ReLU (layers.py:128-174);
    ``mask`` as in ConvBlock."""

    def __init__(self, ch, kernel_size=3, eps=BN_EPS_SPARSE, momentum=BN_MOMENTUM_SPARSE):
        super().__init__()
        self.block1 = ConvBlock(ch, ch, kernel_size, eps=eps, momentum=momentum)
        self.conv2 = nn.Conv2d(ch, ch, kernel_size, padding=kernel_size // 2, bias=False)
        self.norm2 = BatchNorm(ch, eps, momentum)

    def forward(self, x, mask=None):
        y = self.norm2(conv2d(self.block1(x, mask), self.conv2), valid=mask)
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
        self.norm = BatchNorm(out_ch, eps, BN_MOMENTUM_DENSE)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.conv.weight.to(x.dtype), stride=self.conv.stride)
        return torch.relu(self.norm(y))


class SparseConvBlock3d(nn.Module):
    """Parameters of a 3-D sparse conv + BN (+ ReLU) block: a SubM conv at
    stride 1, a strided SparseConv3d otherwise, or the SubM 1x1x1 mapping.
    The weight keeps torch's Conv3d layout (O, I, kz, ky, kx); the sparse
    forward reads it as (K, I, O) taps, z-major (models/resnet.py)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel_size, stride, bias=False)
        self.norm = BatchNorm(out_ch, BN_EPS_SPARSE, BN_MOMENTUM_SPARSE)


class SparseResidualBlock3d(nn.Module):
    """Parameters of a 3-D SubM residual block (conv + BN + ReLU -> conv +
    BN -> + identity -> ReLU), named like ``ResidualBlock``."""

    def __init__(self, ch, kernel_size=3):
        super().__init__()
        self.block1 = SparseConvBlock3d(ch, ch, kernel_size)
        self.conv2 = nn.Conv3d(ch, ch, kernel_size, bias=False)
        self.norm2 = BatchNorm(ch, BN_EPS_SPARSE, BN_MOMENTUM_SPARSE)
