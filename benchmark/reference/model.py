"""The plain reference of the benchmark's two detectors, in float32 PyTorch.

PillarNeXt-B (pillar reader, 2-D sparse ResNet18) and voxel18 (mean voxel
reader, 3-D sparse ResNet18), each with the ASPP neck and the CenterHead,
as the reference det3d code computes them (qcraftai/pillarnext
``det3d/models``).  Frozen from the arithmetic of the repository's
reference mirrors, with one sparse-convolution path for both families:

- a sparse tensor is its sorted active coordinates (b, z, y, x) and one
  feature row each; a 2-D pillar grid is a grid of depth 1;
- a SubM conv computes at the active set only and reads only active
  inputs; a strided SparseConv's output set is every site reached by an
  active input (spconv's semantics); both gather each output's taps and
  multiply by the kernel as one matrix;
- BatchNorm in a sparse stage runs over the active rows, in the dense
  neck and head over every cell; in training with the batch's biased
  variance, in eval with the running statistics.

``Precision`` puts every stored tensor (each conv and linear input,
weight and output, each BatchNorm and block output), and the gradients
back through them, through a rounding: none for the reference, bfloat16
or per-tensor-scaled float8 for the controls of the correctness check,
as a program whose activations are held in that format would compute.

Imports nothing of the JAX package nor of the program under test.
Parameters and buffers carry the reference checkpoint's names, which the
program's modules use too, so one state dict loads into both.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS_SPARSE = 1e-3  # PFN and backbone (BatchNorm1d(eps=1e-3) in det3d)
BN_EPS_DENSE = 1e-5   # neck and head (torch's default)


@contextlib.contextmanager
def f32():
    """float32 matmuls and convolutions on the card: TF32 off inside."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = was


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    """``x`` rounded to bfloat16, or to a float8 format with one scale a
    tensor (its largest magnitude at the format's largest value)."""
    if fmt is torch.bfloat16:
        return x.to(torch.bfloat16).to(x.dtype)
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (x / scale).to(fmt).to(x.dtype) * scale


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.bwd), None, None


class Precision:
    """The rounding of conv and linear operands, and of the gradients that
    flow back through them: ``float32`` (none), ``bfloat16``, or
    ``float8`` (e4m3 forward, e5m2 backward, one scale a tensor: the
    usual float8 training recipe)."""

    FORMATS = {"bfloat16": (torch.bfloat16, torch.bfloat16),
               "float8": (torch.float8_e4m3fn, torch.float8_e5m2)}

    def __init__(self, name: str = "float32"):
        if name not in ("float32", *self.FORMATS):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        return _Rounded.apply(x, *self.FORMATS[self.name])


# ------------------------------------------------------------ sparse tensor
class Sparse:
    """Active sites of a (B, D, H, W) grid: ``coords`` (N, 4) int64 [b, z,
    y, x] in ascending key order, ``feats`` (N, C)."""

    def __init__(self, coords: torch.Tensor, feats: torch.Tensor, shape):
        self.coords = coords
        self.feats = feats
        self.shape = tuple(int(s) for s in shape)

    def keys(self) -> torch.Tensor:
        return grid_keys(self.coords, self.shape)

    def with_feats(self, feats: torch.Tensor) -> "Sparse":
        return Sparse(self.coords, feats, self.shape)


def grid_keys(coords: torch.Tensor, shape) -> torch.Tensor:
    _, d, h, w = shape
    return ((coords[:, 0] * d + coords[:, 1]) * h + coords[:, 2]) * w + coords[:, 3]


def lookup(keys: torch.Tensor, shape, query: torch.Tensor) -> torch.Tensor:
    """Row of each (M, 4) query coordinate in the sorted ``keys``; ``len(keys)``
    (the zero row) where the site is outside the grid or inactive."""
    _, d, h, w = shape
    ok = ((query[:, 1] >= 0) & (query[:, 1] < d) & (query[:, 2] >= 0) & (query[:, 2] < h)
          & (query[:, 3] >= 0) & (query[:, 3] < w))
    qk = grid_keys(torch.where(ok[:, None], query, torch.zeros_like(query)), shape)
    pos = torch.searchsorted(keys, qk).clamp(max=max(len(keys) - 1, 0))
    found = ok & (keys[pos] == qk) if len(keys) else ok & False
    return torch.where(found, pos, len(keys))


def taps(kernel) -> torch.Tensor:
    """(K, 3) tap offsets (dz, dy, dx), z-major, as a Conv3d weight's
    (kz, ky, kx) axes flatten."""
    kz, ky, kx = kernel
    g = torch.stack(torch.meshgrid(torch.arange(kz), torch.arange(ky), torch.arange(kx), indexing="ij"), -1)
    return g.reshape(-1, 3)


def pairs(rows: torch.Tensor, n_in: int) -> list:
    """Per tap, the (output row, input row) pairs whose input is active."""
    out = []
    for k in range(rows.shape[1]):
        o = torch.nonzero(rows[:, k] < n_in)[:, 0]
        out.append((o, rows[o, k]))
    return out


def subm_rulebook(st: Sparse, kernel) -> list:
    """Per tap (padding k // 2), the active sites' (output, input) row pairs."""
    off = taps(kernel).to(st.coords.device) - torch.tensor([k // 2 for k in kernel], device=st.coords.device)
    q = st.coords[:, None, :].expand(-1, len(off), -1).clone()
    q[..., 1:] += off
    rows = lookup(st.keys(), st.shape, q.reshape(-1, 4)).reshape(len(st.coords), len(off))
    return pairs(rows, len(st.coords))


def strided_rulebook(st: Sparse, kernel, stride, padding):
    """spconv SparseConv: (output coords (M, 4), output shape, per tap the
    (output, input) row pairs), the output set being every site an active
    input reaches."""
    b, d, h, w = st.shape
    dev = st.coords.device
    s, p = (torch.tensor(v, device=dev) for v in (stride, padding))
    out_shape = (b, *[(n + 2 * pp - kk) // ss + 1 for n, kk, ss, pp in zip((d, h, w), kernel, stride, padding)])
    off = taps(kernel).to(dev)
    num = st.coords[:, None, 1:] + p - off[None]                   # (N, K, 3): o * s
    q = torch.div(num, s, rounding_mode="floor")
    ok = (num % s == 0).all(-1) & (q >= 0).all(-1) & (q < torch.tensor(out_shape[1:], device=dev)).all(-1)
    cand = torch.cat([st.coords[:, None, :1].expand(-1, len(off), -1), q], -1)[ok]
    keys = torch.unique(grid_keys(cand, out_shape))
    _, od, oh, ow = out_shape
    out_coords = torch.stack([keys // (od * oh * ow), keys // (oh * ow) % od, keys // ow % oh, keys % ow], -1)
    src = out_coords[:, None, 1:] * s - p + off[None]
    q = torch.cat([out_coords[:, None, :1].expand(-1, len(off), -1), src], -1)
    rows = lookup(st.keys(), st.shape, q.reshape(-1, 4)).reshape(len(out_coords), len(off))
    return out_coords, out_shape, pairs(rows, len(st.coords))


def gather_conv(feats: torch.Tensor, book: list, n_out: int, weight: torch.Tensor, prec: Precision):
    """out[o] = sum over taps k and pairs (o, i) of feats[i] @ W_k: each
    tap's active inputs gathered, multiplied, and added at their outputs.
    ``weight`` is a Conv3d / Conv2d weight (O, I, *k), taps flattened in
    the rulebook's order."""
    o = weight.shape[0]
    wk = prec(weight).permute(*range(2, weight.dim()), 1, 0).reshape(len(book), -1, o)

    def run(x, w):
        out = x.new_zeros((n_out, o))
        for k, (oi, ii) in enumerate(book):
            if len(oi):
                out = out.index_add(0, oi, x.index_select(0, ii) @ w[k])
        return out

    x = prec(feats)
    if torch.is_grad_enabled() and (x.requires_grad or wk.requires_grad):
        return prec(checkpoint(run, x, wk, use_reentrant=False))  # the gathered rows are not kept
    return prec(run(x, wk))


def to_dense(st: Sparse) -> torch.Tensor:
    """(B, D, H, W, C) with zeros outside the active set."""
    b, d, h, w = st.shape
    out = st.feats.new_zeros((b * d * h * w, st.feats.shape[1]))
    out = out.index_copy(0, st.keys(), st.feats)
    return out.reshape(b, d, h, w, -1)


# ---------------------------------------------------------------- modules
class Norm(nn.Module):
    """BatchNorm over rows (``channel_dim=-1``) or NCHW channels; the
    program's state (weight, bias, running_mean, running_var)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        if self.training:
            dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
            mean = x.mean(dims)
            var = ((x - mean.reshape(shape)) ** 2).mean(dims)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * inv.reshape(shape) + self.bias.reshape(shape)


class Conv(nn.Module):
    """A weight (and bias) in Conv2d / Conv3d / Linear layout."""

    def __init__(self, shape, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))
        if bias:
            self.bias = nn.Parameter(torch.zeros(shape[0]))


class PFNLayer(nn.Module):
    def __init__(self, cin, cout, last):
        super().__init__()
        units = cout if last else cout // 2
        self.linear = Conv((units, cin))
        self.norm = Norm(units, BN_EPS_SPARSE)
        self.last = last


class PillarReader(nn.Module):
    """det3d PillarFeatureNet: points decorated with their offset from the
    pillar's mean and centre, the PFN stack (Linear, BN over the points,
    ReLU, the pillar max concatenated back), the pillar max of the last
    layer."""

    def __init__(self, num_input_features, num_filters, voxel_size, pc_range):
        super().__init__()
        widths = [num_input_features + 5, *num_filters]
        self.pfn_layers = nn.ModuleList(
            PFNLayer(widths[i], widths[i + 1], i == len(widths) - 2) for i in range(len(widths) - 1))
        self.voxel_size = [float(v) for v in voxel_size]
        self.pc_range = [float(v) for v in pc_range]
        g = np.round((np.asarray(pc_range[3:], np.float64) - pc_range[:3]) / np.asarray(voxel_size, np.float64))
        self.grid = (1, int(g[1]), int(g[0]))  # (D, H, W)

    def forward(self, points: torch.Tensor, mask: torch.Tensor, prec: Precision) -> Sparse:
        b, n, _ = points.shape
        _, h, w = self.grid
        dev = points.device
        vs = [torch.tensor(v, device=dev) for v in self.voxel_size]
        px = torch.floor((points[..., 0] - self.pc_range[0]) / vs[0]).long()
        py = torch.floor((points[..., 1] - self.pc_range[1]) / vs[1]).long()
        ok = mask.bool() & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        bi = torch.arange(b, device=dev)[:, None].expand(b, n)
        pts, px, py, bi = points[ok], px[ok], py[ok], bi[ok]
        keys, inv = torch.unique((bi * h + py) * w + px, return_inverse=True)
        m = len(keys)
        cnt = torch.zeros(m, device=dev).index_add_(0, inv, torch.ones(len(inv), device=dev))
        mean = torch.zeros((m, 3), device=dev).index_add_(0, inv, pts[:, :3]) / cnt[:, None]
        f_cluster = pts[:, :3] - mean[inv]
        f_center = torch.stack([pts[:, 0] - (px.float() * vs[0] + vs[0] / 2 + self.pc_range[0]),
                                pts[:, 1] - (py.float() * vs[1] + vs[1] / 2 + self.pc_range[1])], -1)
        x = torch.cat([pts, f_cluster, f_center], -1)
        for layer in self.pfn_layers:
            x = torch.relu(prec(layer.norm(prec(prec(x) @ prec(layer.linear.weight).t()), -1)))
            xmax = x.new_zeros((m, x.shape[1])).scatter_reduce(
                0, inv[:, None].expand_as(x), x, reduce="amax", include_self=False)
            x = xmax if layer.last else torch.cat([x, xmax[inv]], -1)
        coords = torch.stack([keys // (h * w), torch.zeros_like(keys), keys // w % h, keys % w], -1)
        return Sparse(coords, x, (b, *self.grid))


class VoxelReader(nn.Module):
    """det3d VoxelFeatureExtractor (mean VFE): the mean of each occupied
    voxel's raw point features."""

    def __init__(self, voxel_size, pc_range):
        super().__init__()
        self.voxel_size = [float(v) for v in voxel_size]
        self.pc_range = [float(v) for v in pc_range]
        g = np.round((np.asarray(pc_range[3:], np.float64) - pc_range[:3]) / np.asarray(voxel_size, np.float64))
        self.grid = (int(g[2]), int(g[1]), int(g[0]))

    def forward(self, points, mask, prec: Precision) -> Sparse:
        b, n, c = points.shape
        d, h, w = self.grid
        dev = points.device
        cell = [torch.floor((points[..., a] - self.pc_range[a]) / torch.tensor(self.voxel_size[a], device=dev)).long()
                for a in range(3)]
        ok = mask.bool()
        for v, size in zip(cell, (w, h, d)):
            ok = ok & (v >= 0) & (v < size)
        bi = torch.arange(b, device=dev)[:, None].expand(b, n)
        key = ((bi[ok] * d + cell[2][ok]) * h + cell[1][ok]) * w + cell[0][ok]
        keys, inv = torch.unique(key, return_inverse=True)
        cnt = torch.zeros(len(keys), device=dev).index_add_(0, inv, torch.ones(len(inv), device=dev))
        feats = torch.zeros((len(keys), c), device=dev).index_add_(0, inv, points[ok]) / cnt[:, None]
        coords = torch.stack([keys // (d * h * w), keys // (h * w) % d, keys // w % h, keys % w], -1)
        return Sparse(coords, feats, (b, d, h, w))


class SparseBlock(nn.Module):
    """conv + BN + ReLU; the conv a SubM at stride 1, a SparseConv
    otherwise.  ``kernel`` is the weight's own (2-D or 3-D); the geometry
    is held in 3-D (a 2-D kernel is one tap deep)."""

    def __init__(self, cin, cout, kernel, stride=1):
        super().__init__()
        self.conv = Conv((cout, cin, *kernel))
        self.norm = Norm(cout, BN_EPS_SPARSE)
        lift = (1,) * (3 - len(kernel))
        self.kernel = lift + tuple(kernel)
        self.stride = None if stride == 1 else lift + (stride,) * len(kernel)
        self.padding = (0,) * len(lift) + tuple(k // 2 for k in kernel)

    def forward(self, st: Sparse, prec, rows=None):
        if self.stride is None:
            y = gather_conv(st.feats, rows, len(st.coords), self.conv.weight, prec)
            return st.with_feats(torch.relu(prec(self.norm(y, -1))))
        coords, shape, rows = strided_rulebook(st, self.kernel, self.stride, self.padding)
        y = gather_conv(st.feats, rows, len(coords), self.conv.weight, prec)
        return Sparse(coords, torch.relu(prec(self.norm(y, -1))), shape)


class SparseResidual(nn.Module):
    def __init__(self, ch, kernel):
        super().__init__()
        self.block1 = SparseBlock(ch, ch, kernel)
        self.conv2 = Conv((ch, ch, *kernel))
        self.norm2 = Norm(ch, BN_EPS_SPARSE)

    def forward(self, st: Sparse, prec, rows):
        y = self.block1(st, prec, rows).feats
        y = prec(self.norm2(gather_conv(y, rows, len(st.coords), self.conv2.weight, prec), -1))
        return st.with_feats(prec(torch.relu(y + st.feats)))


class SparseBackbone(nn.Module):
    """det3d SparseResNet (2-D, ``dims=2``) and SparseResNet3D (``dims=3``):
    per stage a SubM or strided conv block and residual blocks; the 3-D one
    adds the extra (3, 1, 1) / (2, 1, 1) z-conv with padding 0.  A 1x1
    mapping, the dense grid, depth folded into channels depth-major (the
    program's and the JAX package's order)."""

    def __init__(self, dims, c_in, filters, strides, layer_nums, out_ch):
        super().__init__()
        self.dims = dims
        k = (3,) * dims
        blocks, ci = [], c_in
        for f, s, n in zip(filters, strides, layer_nums):
            blocks.append(nn.ModuleList([SparseBlock(ci, f, k, s)] + [SparseResidual(f, k) for _ in range(n)]))
            ci = f
        self.blocks = nn.ModuleList(blocks)
        if dims == 3:
            self.extra_conv = nn.ModuleList([Conv((ci, ci, 3, 1, 1)), Norm(ci, BN_EPS_SPARSE)])
            self.mapping = SparseBlock(ci, out_ch, (1, 1, 1))
        else:
            self.mapping = nn.ModuleList([Conv((out_ch, ci, 1, 1)), Norm(out_ch, BN_EPS_SPARSE)])

    def forward(self, st: Sparse, prec: Precision) -> torch.Tensor:
        for stage in self.blocks:
            first = stage[0]
            if first.stride is not None:
                st = first(st, prec)
            rows = subm_rulebook(st, first.kernel)
            for blk in (stage if first.stride is None else stage[1:]):
                st = blk(st, prec, rows)
        if self.dims == 3:
            coords, shape, rows = strided_rulebook(st, (3, 1, 1), (2, 1, 1), (0, 0, 0))
            y = gather_conv(st.feats, rows, len(coords), self.extra_conv[0].weight, prec)
            st = Sparse(coords, torch.relu(prec(self.extra_conv[1](y, -1))), shape)
            w, norm = self.mapping.conv.weight, self.mapping.norm
        else:
            w, norm = self.mapping[0].weight, self.mapping[1]
        y = prec(prec(st.feats) @ prec(w).reshape(w.shape[0], -1).t())
        st = st.with_feats(torch.relu(prec(norm(y, -1))))
        dense = to_dense(st)  # (B, D, H, W, C)
        b, d, h, w_, c = dense.shape
        return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w_, d * c).permute(0, 3, 1, 2)


def conv2d(x, conv: Conv, prec: Precision, **kw):
    return prec(F.conv2d(prec(x), prec(conv.weight), getattr(conv, "bias", None), **kw))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, k=3, eps=BN_EPS_DENSE):
        super().__init__()
        self.conv = Conv((cout, cin, k, k))
        self.norm = Norm(cout, eps)

    def forward(self, x, prec):
        return torch.relu(prec(self.norm(conv2d(x, self.conv, prec, padding=self.conv.weight.shape[-1] // 2))))


class PreConv(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.block1 = ConvBlock(ch, ch)
        self.block2 = ConvBlock(ch, ch)


class ASPP(nn.Module):
    """det3d ASPPNeck: a residual block, then [x, 1x1, one shared 3x3
    kernel at dilations 1, 6, 12, 18] concatenated, a 1x1 ConvBlock."""

    def __init__(self, ch):
        super().__init__()
        self.pre_conv = PreConv(ch)
        self.conv1x1 = Conv((ch, ch, 1, 1))
        self.weight = nn.Parameter(torch.zeros(ch, ch, 3, 3))
        self.post_conv = ConvBlock(ch * 6, ch, k=1)

    def forward(self, x, prec):
        def run(x, *params):
            x = prec(torch.relu(self.pre_conv.block2(self.pre_conv.block1(x, prec), prec) + x))
            w = prec(self.weight)
            xs = prec(x)
            branches = [x, prec(F.conv2d(xs, prec(self.conv1x1.weight)))]
            branches += [prec(dilated3x3(xs, w, d)) for d in (1, 6, 12, 18)]
            return self.post_conv(torch.cat(branches, 1), prec)
        return _maybe_checkpoint(run, x, self)


def dilated3x3(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """``conv2d(x, w, padding=d, dilation=d)`` as an undilated conv over the
    d x d phase sub-grids of x (the same taps and sums): cuDNN runs a
    large dilation in float32 as a slow direct kernel."""
    if d == 1:
        return F.conv2d(x, w, padding=1)
    b, c, h, wd = x.shape
    hq, wq = -(-h // d), -(-wd // d)
    x = F.pad(x, (0, wq * d - wd, 0, hq * d - h))
    x = x.reshape(b, c, hq, d, wq, d).permute(0, 3, 5, 1, 2, 4).reshape(b * d * d, c, hq, wq)
    y = F.conv2d(x, w, padding=1)
    y = y.reshape(b, d, d, -1, hq, wq).permute(0, 3, 4, 1, 5, 2).reshape(b, -1, hq * d, wq * d)
    return y[:, :, :h, :wd]


class Branch(nn.Module):
    """[conv3x3 + BN + ReLU] * (n - 1), then conv3x3 with bias; indices as
    the reference's Sequential (0 conv, 1 BN, 2 ReLU, ..., final)."""

    def __init__(self, ch, n_out, n_conv, head_conv=64):
        super().__init__()
        for i in range(n_conv - 1):
            self.add_module(str(3 * i), Conv((head_conv, ch if i == 0 else head_conv, 3, 3), bias=True))
            self.add_module(str(3 * i + 1), Norm(head_conv, BN_EPS_DENSE))
        self.add_module(str(3 * (n_conv - 1)), Conv((n_out, head_conv if n_conv > 1 else ch, 3, 3), bias=True))
        self.n_conv = n_conv

    def forward(self, x, prec):
        for i in range(self.n_conv - 1):
            x = torch.relu(prec(getattr(self, str(3 * i + 1))(conv2d(x, getattr(self, str(3 * i)), prec, padding=1))))
        return conv2d(x, getattr(self, str(3 * (self.n_conv - 1))), prec, padding=1)


class Deblock(nn.Module):
    def __init__(self, ch, stride):
        super().__init__()
        self.conv = Conv((ch, ch, stride, stride))  # ConvTranspose2d layout (I, O, k, k)
        self.norm = Norm(ch, BN_EPS_DENSE)
        self.stride = stride


class Task(nn.Module):
    def __init__(self, ch, heads: dict, stride):
        super().__init__()
        self.deblock = Deblock(ch, stride)
        self.names = list(heads)
        for name, (n_out, n_conv) in heads.items():
            self.add_module(name, Branch(ch, n_out, n_conv, ch))

    def forward(self, x, prec):
        def run(x, *params):
            y = F.conv_transpose2d(prec(x), prec(self.deblock.conv.weight), stride=self.deblock.stride)
            y = torch.relu(prec(self.deblock.norm(prec(y))))
            return tuple(getattr(self, n)(y, prec) for n in self.names)
        return dict(zip(self.names, _maybe_checkpoint(run, x, self)))


class Head(nn.Module):
    """det3d CenterHead: a shared 3x3 conv (with bias) + BN + ReLU, then per
    task group a ConvTranspose deblock + BN + ReLU and the branches; the
    heatmap's final bias starts at -2.19."""

    def __init__(self, ch, tasks, common_heads, stride, head_conv=64):
        super().__init__()
        self.shared_conv = nn.ModuleDict({"0": Conv((head_conv, ch, 3, 3), bias=True), "1": Norm(head_conv, BN_EPS_DENSE)})
        heads = [dict(common_heads, hm=(len(t), 2)) for t in tasks]
        self.tasks = nn.ModuleList(Task(head_conv, {k: tuple(v) for k, v in h.items()}, stride) for h in heads)

    def forward(self, x, prec):
        x = torch.relu(prec(self.shared_conv["1"](conv2d(x, self.shared_conv["0"], prec, padding=1))))
        return [t(x, prec) for t in self.tasks]


def _maybe_checkpoint(fn, x, module):
    """``fn(x)``; in a training forward recomputed in the backward, so that
    the reference's activations fit beside nothing else on one card."""
    if torch.is_grad_enabled() and module.training:
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


class Detector(nn.Module):
    """reader -> sparse backbone -> ASPP neck -> CenterHead, from the
    experiment's ``model`` section."""

    def __init__(self, model_cfg: dict):
        super().__init__()
        rd, bb, hd = model_cfg["reader"], model_cfg["backbone"], model_cfg["head"]
        voxel = "Voxel" in rd["_target_"]
        if voxel:
            self.reader = VoxelReader(rd["voxel_size"], rd["pc_range"])
            depth = self.reader.grid[0]
            for s in bb["ds_layer_strides"]:
                depth = (depth + 2 - 3) // s + 1
            depth = (depth - 3) // 2 + 1
            out_ch = int(bb.get("out_channels", 128))
            bev = depth * out_ch
        else:
            self.reader = PillarReader(rd["num_input_features"], rd["num_filters"], rd["voxel_size"], rd["pc_range"])
            out_ch = bev = int(bb.get("out_channels", 256))
        self.backbone = SparseBackbone(3 if voxel else 2, int(bb["num_input_features"]), bb["ds_num_filters"],
                                       bb["ds_layer_strides"], bb["layer_nums"], out_ch)
        self.neck = ASPP(bev)
        self.head = Head(bev, hd["tasks"], hd["common_heads"], int(hd["strides"][0]),
                         int(hd.get("share_conv_channel", 64)))
        self.head_cfg = hd
        self.post_processing = model_cfg["post_processing"]

    def forward(self, points, mask, prec: Precision | None = None):
        """Per-task dicts of NCHW maps."""
        prec = prec or Precision()
        x = self.backbone(self.reader(points, mask, prec), prec)
        return self.head(self.neck(x, prec), prec)


def fan_in(name: str, shape) -> int:
    """A kernel's fan-in: ConvTranspose2d weights (the heads' deblocks)
    are stored (I, O, k, k)."""
    f = shape[0] if ".deblock.conv." in name else shape[1]
    return int(f * math.prod(shape[2:]))
