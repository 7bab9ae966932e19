"""Weights in and out of the port's state_dict.

In: a checkpoint written by the reference (qcraftai/pillarnext, such as
the released PillarNeXt-B weights) through ``load_torch_state_dict`` and
``state_dict_from_reference``, the port's counterparts of the JAX
importer's ``load_torch_state_dict`` and ``import_pillarnext``
(pillarnext_tpu/utils/torch_import.py:30-47, :199-376) for the pillar
family, the only one JAX imports.  The port's modules use the reference
schema, so a reference tensor lands under its own name; only spconv's
(O, kH, kW, I) sparse kernels change layout.

Out: JAX ``{params, batch_stats}`` trees -> the port's state_dict (numpy).
The port's own copy of ``export_pillarnext``, ``export_voxelnext`` and
``export_mvfnext`` and their helpers
(pillarnext_tpu/utils/torch_import.py:378-649), for the pillarnet18_aspp,
voxel18_aspp and mvf18_aspp layouts: PFN stacks of any depth, the voxel
backbone's sparse or dense tree, and every head tree (per-branch, a
SepHead's ``merge_branches`` tree, ``MergedSepHeads``' ``merged`` tree,
split back into the per-task, per-branch schema).  They write the
reference checkpoint schema the port's modules use, whichever head option
the model runs.  Layout conversions:

  Dense kernel (in, out)               -> Linear (out, in)
  Conv kernel (kh, kw, in, out)        -> Conv2d (out, in, kh, kw)
  Conv kernel (kz, ky, kx, in, out)    -> Conv3d (out, in, kz, ky, kx)
  ConvTranspose kernel (kh, kw, in, out), spatially flipped
                                       -> ConvTranspose2d (in, out, kh, kw)
  scale/bias + mean/var                -> BatchNorm weight/bias/running_*

Every map is linear in the tensor, so the same function carries gradients
(pass the gradient tree as ``params`` and any tree of the statistics'
shapes as ``batch_stats``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_torch_state_dict(path) -> dict[str, np.ndarray]:
    """A reference checkpoint (.pth: a bare state_dict, or one under
    ``state_dict`` or ``model``, keys possibly prefixed ``module.`` by
    DataParallel) as numpy arrays by name (the reference's
    checkpoint.py:28-43)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and "model" in ckpt:
        sd = ckpt["model"]
    else:
        sd = ckpt
    return {k.removeprefix("module."): v.detach().cpu().numpy() for k, v in sd.items()}


def conv_kernel(w: np.ndarray, in_channels: int) -> np.ndarray:
    """A conv weight as torch (O, I, *k) or spconv (O, *k, I) -> (O, I, *k),
    by the JAX importer's rule (torch_import.py:57-66): torch's layout when
    axis 1 holds ``in_channels`` and the last axis does not, spconv's when
    the last axis does, torch's when neither does."""
    if w.shape[1] == in_channels and w.shape[-1] != in_channels:
        return w
    if w.shape[-1] == in_channels:
        return np.ascontiguousarray(np.moveaxis(w, -1, 1))
    return w


def state_dict_from_reference(sd: dict, model: nn.Module) -> dict[str, torch.Tensor]:
    """The port's state_dict for a pillar-family ``model`` from a reference
    state_dict ``sd`` (``load_torch_state_dict``): ``num_batches_tracked``
    dropped, each conv weight in torch's layout (``conv_kernel``), every
    tensor float32.  The port keeps the per-task, per-branch schema under
    every head option (``merge_branches`` and ``merge_tasks`` concatenate
    at apply time), so the merged heads read these tensors as they are.
    Raises on a missing key, a key left over, or a shape the model does
    not take, as ``validate_against_flax`` fails on the JAX side."""
    from pillarnext_tpu_torch.models.pillar_encoder import PillarFeatureNet

    if not isinstance(model.reader, PillarFeatureNet):
        raise ValueError(f"reference checkpoints import into the pillar family, not a {type(model.reader).__name__}")
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    expected = model.state_dict()
    missing = sorted(set(expected) - set(sd))
    stray = sorted(set(sd) - set(expected))
    if missing or stray:
        raise KeyError(f"reference checkpoint: missing keys {missing[:10]} ({len(missing)}), "
                       f"keys left over {stray[:10]} ({len(stray)})")
    convs = {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, (nn.Conv2d, nn.Conv3d))}
    out = {}
    for k, ref in expected.items():
        w = np.asarray(sd[k])
        if k in convs and w.ndim == ref.dim():
            w = conv_kernel(w, ref.shape[1])
        if tuple(w.shape) != tuple(ref.shape):
            raise ValueError(f"reference checkpoint: {k} has shape {tuple(w.shape)}, the model takes {tuple(ref.shape)}")
        out[k] = torch.from_numpy(np.array(w, dtype=np.float32)).to(ref.dtype)
    return out


def _inv_conv_kernel(k) -> np.ndarray:
    """flax Conv (H,W,I,O) -> torch Conv2d (O,I,H,W)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _inv_conv_transpose_kernel(k) -> np.ndarray:
    """flax ConvTranspose (H,W,I,O, spatially flipped) -> torch (I,O,H,W)."""
    k = np.asarray(k)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))


def _inv_bn(sd, torch_prefix, p, s):
    sd[f"{torch_prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{torch_prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{torch_prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{torch_prefix}.running_var"] = np.asarray(s["var"])


def _inv_conv_block(sd, prefix, p, s):
    sd[f"{prefix}.conv.weight"] = _inv_conv_kernel(p["Conv_0"]["kernel"])
    _inv_bn(sd, f"{prefix}.norm", p["BatchNorm_0"], s["BatchNorm_0"])


def _inv_point_layer(sd, prefix, p, s):
    """Dense_0 + MaskedBatchNorm_0 (a PFN layer or a PointNet)."""
    sd[f"{prefix}.linear.weight"] = np.ascontiguousarray(np.asarray(p["Dense_0"]["kernel"]).T)
    _inv_bn(sd, f"{prefix}.norm", p["MaskedBatchNorm_0"], s["MaskedBatchNorm_0"])


def _inv_residual_block(sd, prefix, p, s):
    _inv_conv_block(sd, f"{prefix}.block1", p["ConvBlock_0"], s["ConvBlock_0"])
    sd[f"{prefix}.conv2.weight"] = _inv_conv_kernel(p["Conv_0"]["kernel"])
    _inv_bn(sd, f"{prefix}.norm2", p["BatchNorm_0"], s["BatchNorm_0"])


def export_pillarnext(
    params,
    batch_stats,
    *,
    num_filters=(64, 64),
    layer_nums=(2, 2, 2, 2),
    tasks=(),
    common_heads=None,
    num_hm_conv=2,
) -> dict[str, np.ndarray]:
    """{params, batch_stats} -> a reference-named state_dict for the
    pillarnet18_aspp detector."""
    p, s = params, batch_stats
    sd: dict[str, np.ndarray] = {}

    for i in range(len(num_filters)):
        _inv_point_layer(sd, f"reader.pfn_layers.{i}", p["reader"][f"pfn_layers_{i}"],
                         s["reader"][f"pfn_layers_{i}"])

    for si, n_blocks in enumerate(layer_nums):
        bp, bs = p["backbone"][f"stage_{si}"], s["backbone"][f"stage_{si}"]
        _inv_conv_block(sd, f"backbone.blocks.{si}.0", bp["down"], bs["down"])
        for bi in range(n_blocks):
            _inv_residual_block(
                sd, f"backbone.blocks.{si}.{bi + 1}", bp[f"block_{bi}"], bs[f"block_{bi}"]
            )
    sd["backbone.mapping.0.weight"] = _inv_conv_kernel(
        p["backbone"]["ConvBlock_0"]["Conv_0"]["kernel"]
    )
    _inv_bn(
        sd, "backbone.mapping.1",
        p["backbone"]["ConvBlock_0"]["BatchNorm_0"],
        s["backbone"]["ConvBlock_0"]["BatchNorm_0"],
    )

    _export_neck_head(sd, p, s, tasks, common_heads, num_hm_conv)
    return sd


def _export_neck_head(sd, p, s, tasks, common_heads, num_hm_conv=2):
    """ASPP neck (where the tree has one) + CenterHead export."""
    if "neck" in p:
        np_, ns = p["neck"], s["neck"]
        for j in range(2):
            _inv_conv_block(
                sd, f"neck.pre_conv.block{j + 1}",
                np_["BasicBlock_0"][f"ConvBlock_{j}"], ns["BasicBlock_0"][f"ConvBlock_{j}"],
            )
        sd["neck.conv1x1.weight"] = _inv_conv_kernel(np_["Conv_0"]["kernel"])
        sd["neck.weight"] = _inv_conv_kernel(np_["shared_dilated_kernel"])
        _inv_conv_block(sd, "neck.post_conv", np_["ConvBlock_0"], ns["ConvBlock_0"])

    hp, hs = p["head"], s["head"]
    sd["head.shared_conv.0.weight"] = _inv_conv_kernel(hp["shared_conv"]["kernel"])
    sd["head.shared_conv.0.bias"] = np.asarray(hp["shared_conv"]["bias"])
    _inv_bn(sd, "head.shared_conv.1", hp["shared_bn"], hs["shared_bn"])
    if "merged" in hp:
        hp, hs = _split_merged_tasks(hp["merged"], hs["merged"], tasks, common_heads)

    for ti, task in enumerate(tasks):
        tp, tsd = hp[f"task_{ti}"], hs[f"task_{ti}"]
        if "ConvTransposeBlock_0" in tp:  # stride > 1
            sd[f"head.tasks.{ti}.deblock.conv.weight"] = _inv_conv_transpose_kernel(
                tp["ConvTransposeBlock_0"]["ConvTranspose_0"]["kernel"]
            )
            _inv_bn(
                sd, f"head.tasks.{ti}.deblock.norm",
                tp["ConvTransposeBlock_0"]["BatchNorm_0"], tsd["ConvTransposeBlock_0"]["BatchNorm_0"],
            )
        branches = dict(common_heads)
        branches["hm"] = (len(task), num_hm_conv)
        if "branch1" in tp:
            tp, tsd = _split_merged_branches(tp, tsd, branches)
        for bname, (_n_out, n_conv) in branches.items():
            bp, bs = tp[bname], tsd[bname]
            ci = 0
            for li in range(n_conv - 1):
                t_conv = 3 * li
                sd[f"head.tasks.{ti}.{bname}.{t_conv}.weight"] = _inv_conv_kernel(
                    bp[f"Conv_{ci}"]["kernel"]
                )
                sd[f"head.tasks.{ti}.{bname}.{t_conv}.bias"] = np.asarray(bp[f"Conv_{ci}"]["bias"])
                _inv_bn(
                    sd, f"head.tasks.{ti}.{bname}.{t_conv + 1}",
                    bp[f"BatchNorm_{li}"], bs[f"BatchNorm_{li}"],
                )
                ci += 1
            t_final = 3 * (n_conv - 1)
            sd[f"head.tasks.{ti}.{bname}.{t_final}.weight"] = _inv_conv_kernel(
                bp[f"Conv_{ci}"]["kernel"]
            )
            sd[f"head.tasks.{ti}.{bname}.{t_final}.bias"] = np.asarray(bp[f"Conv_{ci}"]["bias"])
    return sd


def _split(x, sizes) -> list:
    """``x`` cut along its last axis into consecutive pieces of ``sizes``."""
    return np.split(np.asarray(x), np.cumsum(sizes)[:-1], axis=-1)


def _split_bn(p, s, sizes) -> tuple[list, list]:
    """A BatchNorm over concatenated channels -> per-piece (params, stats)."""
    ps = zip(*(_split(p[k], sizes) for k in ("scale", "bias")))
    ss = zip(*(_split(s[k], sizes) for k in ("mean", "var")))
    return ([{"scale": a, "bias": b} for a, b in ps], [{"mean": m, "var": v} for m, v in ss])


def _branch_tree(k1, b1, bn_p, bn_s, k2, b2) -> tuple[dict, dict]:
    """One two-conv branch as MLPHead's tree (Conv_0, BatchNorm_0, Conv_1)."""
    return ({"Conv_0": {"kernel": k1, "bias": b1}, "BatchNorm_0": bn_p, "Conv_1": {"kernel": k2, "bias": b2}},
            {"BatchNorm_0": bn_s})


def _split_merged_branches(tp, tsd, branches) -> tuple[dict, dict]:
    """SepHead(merge_branches)'s ``branch1`` / ``bn1`` / ``out_<name>``
    (centerhead.py:96-131) -> per-branch MLPHead trees: the inverse of the
    JAX importer's concatenation (utils/torch_import.py:307-330)."""
    names = list(branches)
    hc = np.shape(tp["branch1"]["kernel"])[-1] // len(names)
    sizes = [hc] * len(names)
    k1, b1 = _split(tp["branch1"]["kernel"], sizes), _split(tp["branch1"]["bias"], sizes)
    bn_p, bn_s = _split_bn(tp["bn1"], tsd["bn1"], sizes)
    p, s = {}, {}
    for i, name in enumerate(names):
        out = tp[f"out_{name}"]
        p[name], s[name] = _branch_tree(k1[i], b1[i], bn_p[i], bn_s[i], out["kernel"], out["bias"])
    return p, s


def _split_merged_tasks(mp, ms, tasks, common_heads) -> tuple[dict, dict]:
    """MergedSepHeads' tree (centerhead.py:217-300: ``deblock`` over T * 64
    channels, ``branch1`` / ``bn1`` task-major over T * R * 64, per branch a
    grouped ``out_<name>`` with hm padded to the largest class count) ->
    per-task SepHead trees: the inverse of the JAX importer's
    ``_import_merged_head`` (utils/torch_import.py:110-196)."""
    t = len(tasks)
    branches = {k: int(v[0]) for k, v in common_heads.items()}
    branches["hm"] = max(len(task) for task in tasks)
    names = list(branches)
    hc = np.shape(mp["branch1"]["kernel"])[-1] // (t * len(names))
    p = {f"task_{ti}": {} for ti in range(t)}
    s = {f"task_{ti}": {} for ti in range(t)}
    if "deblock" in mp:
        kernels = _split(mp["deblock"]["ConvTranspose_0"]["kernel"], [hc] * t)
        bn_p, bn_s = _split_bn(mp["deblock"]["BatchNorm_0"], ms["deblock"]["BatchNorm_0"], [hc] * t)
        for ti in range(t):
            p[f"task_{ti}"]["ConvTransposeBlock_0"] = {"ConvTranspose_0": {"kernel": kernels[ti]},
                                                      "BatchNorm_0": bn_p[ti]}
            s[f"task_{ti}"]["ConvTransposeBlock_0"] = {"BatchNorm_0": bn_s[ti]}
    sizes = [hc] * (t * len(names))
    k1, b1 = _split(mp["branch1"]["kernel"], sizes), _split(mp["branch1"]["bias"], sizes)
    bn_p, bn_s = _split_bn(mp["bn1"], ms["bn1"], sizes)
    for bi, name in enumerate(names):
        c_out = branches[name]
        k2, b2 = _split(mp[f"out_{name}"]["kernel"], [c_out] * t), _split(mp[f"out_{name}"]["bias"], [c_out] * t)
        for ti, task in enumerate(tasks):
            width = len(task) if name == "hm" else c_out
            j = ti * len(names) + bi
            p[f"task_{ti}"][name], s[f"task_{ti}"][name] = _branch_tree(
                k1[j], b1[j], bn_p[j], bn_s[j], k2[ti][..., :width], b2[ti][:width])
    return p, s


def _inv_conv3d_kernel(k) -> np.ndarray:
    """flax Conv3d (kz,ky,kx,I,O) -> torch Conv3d (O,I,kz,ky,kx)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def export_voxelnext(
    params,
    batch_stats,
    *,
    layer_nums=(2, 2, 2, 2),
    ds_layer_strides=(1, 2, 2, 2),
    tasks=(),
    common_heads=None,
    num_hm_conv=2,
) -> dict[str, np.ndarray]:
    """{params, batch_stats} of the voxel18_aspp detector (the sparse-path
    tree of JAX ``SparseResNet3D``) -> a reference-named state_dict:
    ``backbone.blocks.{i}.{j}...``, ``backbone.extra_conv.{0,1}``,
    ``backbone.mapping.{conv,norm}``, then the neck and head.  The reader
    has no parameters; a tree without ``head`` exports the backbone only.
    The BEV folds depth-major (the JAX package's order), so a checkpoint
    trained by the reference would also need its neck input permuted."""
    p, s = params, batch_stats
    sd: dict[str, np.ndarray] = {}
    bp, bs = p["backbone"], s["backbone"]
    if "Conv_0" in bp:
        _export_dense_3d(sd, bp, bs, layer_nums)
        if "head" in p:
            _export_neck_head(sd, p, s, tasks, common_heads, num_hm_conv)
        return sd

    for si, (n_blocks, stride) in enumerate(zip(layer_nums, ds_layer_strides)):
        if stride == 1:
            # SparseConvBlock: Conv_0 + BatchNorm_0
            sd[f"backbone.blocks.{si}.0.conv.weight"] = _inv_conv3d_kernel(
                bp[f"stage_{si}_down"]["Conv_0"]["kernel"]
            )
            _inv_bn(
                sd, f"backbone.blocks.{si}.0.norm",
                bp[f"stage_{si}_down"]["BatchNorm_0"], bs[f"stage_{si}_down"]["BatchNorm_0"],
            )
        else:
            # _SparseDownConv + a separate MaskedBatchNorm
            sd[f"backbone.blocks.{si}.0.conv.weight"] = _inv_conv3d_kernel(
                bp[f"stage_{si}_down"]["kernel"]
            )
            _inv_bn(sd, f"backbone.blocks.{si}.0.norm", bp[f"stage_{si}_down_bn"], bs[f"stage_{si}_down_bn"])
        for bi in range(n_blocks):
            rp, rs = bp[f"stage_{si}_block_{bi}"], bs[f"stage_{si}_block_{bi}"]
            prefix = f"backbone.blocks.{si}.{bi + 1}"
            sd[f"{prefix}.block1.conv.weight"] = _inv_conv3d_kernel(rp["ConvBlock_0"]["Conv_0"]["kernel"])
            _inv_bn(sd, f"{prefix}.block1.norm", rp["ConvBlock_0"]["BatchNorm_0"], rs["ConvBlock_0"]["BatchNorm_0"])
            sd[f"{prefix}.conv2.weight"] = _inv_conv3d_kernel(rp["Conv_0"]["kernel"])
            _inv_bn(sd, f"{prefix}.norm2", rp["BatchNorm_0"], rs["BatchNorm_0"])

    sd["backbone.extra_conv.0.weight"] = _inv_conv3d_kernel(bp["extra_conv"]["kernel"])
    _inv_bn(sd, "backbone.extra_conv.1", bp["extra_conv_bn"], bs["extra_conv_bn"])
    # SubM 1x1x1 mapping: flax Dense (I, O) -> torch Conv3d (O, I, 1, 1, 1)
    sd["backbone.mapping.conv.weight"] = np.ascontiguousarray(
        np.asarray(bp["mapping"]["kernel"]).T
    )[:, :, None, None, None]
    _inv_bn(sd, "backbone.mapping.norm", bp["mapping_bn"], bs["mapping_bn"])

    if "head" in p:
        _export_neck_head(sd, p, s, tasks, common_heads, num_hm_conv)
    return sd


def _export_dense_3d(sd, bp, bs, layer_nums) -> None:
    """JAX's dense ``SparseResNet3D`` tree (resnet.py:960-1013, auto-named
    ``Conv_i`` / ``BatchNorm_i`` in call order: each stage's strided conv,
    then each residual block's two convs, the extra z-conv, the mapping)
    onto the modules of the sparse path, which the dense forward reads."""
    blocks = []  # (conv weight key, BN prefix) in JAX's call order
    for si, n_blocks in enumerate(layer_nums):
        blocks.append((f"backbone.blocks.{si}.0.conv.weight", f"backbone.blocks.{si}.0.norm"))
        for bi in range(n_blocks):
            prefix = f"backbone.blocks.{si}.{bi + 1}"
            blocks += [(f"{prefix}.block1.conv.weight", f"{prefix}.block1.norm"),
                       (f"{prefix}.conv2.weight", f"{prefix}.norm2")]
    blocks += [("backbone.extra_conv.0.weight", "backbone.extra_conv.1"),
               ("backbone.mapping.conv.weight", "backbone.mapping.norm")]
    for i, (weight, norm) in enumerate(blocks):
        sd[weight] = _inv_conv3d_kernel(bp[f"Conv_{i}"]["kernel"])
        _inv_bn(sd, norm, bp[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"])


def export_mvfnext(
    params,
    batch_stats,
    *,
    num_filters=(48, 48),
    layer_nums=(2, 2, 2, 2),
    tasks=(),
    common_heads=None,
    num_hm_conv=2,
) -> dict[str, np.ndarray]:
    """mvf18_aspp {params, batch_stats} -> the state_dict of the port's
    MVF detector (models/mvf_encoder.py): ``reader.{pillar,cylinder}_view``
    with ``pfn.{i}`` and ``blocks.{i}.{j}`` (block 0 of a stage its
    ConvBlock, block j + 1 its j-th ResidualBlock), then
    ``reader.pointnet{1,2}``, the neck and the head."""
    p, s = params, batch_stats
    sd: dict[str, np.ndarray] = {}
    rp, rs = p["reader"], s["reader"]
    for view in ("pillar_view", "cylinder_view"):
        export_mvf_view(sd, f"reader.{view}", rp[view], rs[view], num_filters, layer_nums)
    _inv_point_layer(sd, "reader.pointnet1", rp["pointnet1"], rs["pointnet1"])
    _inv_point_layer(sd, "reader.pointnet2", rp["pointnet2"], rs["pointnet2"])

    if "head" in p:  # reader-only trees allowed (tests)
        _export_neck_head(sd, p, s, tasks, common_heads, num_hm_conv)
    return sd


def export_mvf_view(sd, prefix, p, s, num_filters, layer_nums) -> None:
    """One MVF ``SingleView`` tree into ``sd`` under ``prefix``: ``pfn.{i}``,
    then ``blocks.{i}.0`` (the stage's ConvBlock) and ``blocks.{i}.{j + 1}``
    (its ResidualBlocks, numbered across stages in JAX)."""
    for i in range(len(num_filters)):
        _inv_point_layer(sd, f"{prefix}.pfn.{i}", p[f"PFNLayer_{i}"], s[f"PFNLayer_{i}"])
    blk = 0
    for i, n_blocks in enumerate(layer_nums):
        _inv_conv_block(sd, f"{prefix}.blocks.{i}.0", p[f"ConvBlock_{i}"], s[f"ConvBlock_{i}"])
        for j in range(n_blocks):
            _inv_residual_block(sd, f"{prefix}.blocks.{i}.{j + 1}",
                                p[f"ResidualBlock_{blk}"], s[f"ResidualBlock_{blk}"])
            blk += 1
