"""Config -> the port's model, datasets and optimizer.

Counterpart of ``build_model`` / ``build_eval_model_scaled`` /
``build_dataset`` / ``build_optimizer`` (pillarnext_tpu/utils/builders.py:38-141).  The card comes first:
both build on ``cuda:0`` unless the caller passes ``device="cpu"``, and
without a card that default raises instead of falling back to the CPU.
"""

from __future__ import annotations

import copy

import torch

from pillarnext_tpu_torch.models.layers import BatchNorm
from pillarnext_tpu_torch.utils.config import instantiate
from pillarnext_tpu_torch.utils.registry import PORT_REGISTRY, check_targets
from pillarnext_tpu_torch.utils.weights import init_random

DTYPES = {"bfloat16": torch.bfloat16, "float32": None, None: None}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() is false; "
                "pass device='cpu' to run on the CPU"
            )
        device = torch.device("cuda", device.index if device.index is not None else 0)
    return device


def build_model(model_cfg: dict, device="cuda:0", generator: torch.Generator | None = None,
                train: bool = False):
    """Instantiate the detector from the resolved ``cfg["model"]`` dict.

    ``model.dtype`` ('bfloat16' default, or 'float32') is the activation
    dtype of every submodule; parameters, BN statistics and decode/NMS stay
    float32.  A float32 model computes in full f32 on the card: its
    ``forward``, ``loss`` and ``predict``, and ``train_step``'s backward,
    run under ``model.precision()`` (models/detector.py), which turns TF32
    off for cuDNN and CUDA matmuls inside those calls and restores the
    flags after; building a model changes no process-wide flag.
    ``sync_batchnorm`` sets ``sync`` on every BatchNorm of a train model:
    under a process group (parallel/) their statistics are those of the
    global batch, as under JAX's global-view ``jit``; without a group it
    changes nothing.  A pillar reader feeding a SparseResNet that opens with stride 1
    emits its compact table and the backbone runs sparse (the reference's
    sparse path); a voxel reader always emits its compact table for
    SparseResNet3D, in eval and in training.  ``train=True`` gives a pillar
    reader the config's ``train_pillar_capacity`` for its training forward
    (serving keeps ``pillar_capacity``; the voxel reader keeps
    ``voxel_capacity`` in both, as JAX does) and returns the model in train
    mode; otherwise in eval mode.  An MVF reader (``MVFFeatureNet``) feeds
    the neck directly (its detector has no backbone) and keeps
    ``pillar_capacity`` and ``cylinder_capacity`` in both modes (its config
    has no train capacity); in training it recomputes each tower block in
    the backward.  With ``generator`` the parameters are
    drawn from it (utils/weights.py: init_random); otherwise load weights
    afterwards.
    """
    device = resolve_device(device)
    cfg = copy.deepcopy(model_cfg)
    sync_bn = bool(cfg.pop("sync_batchnorm", False))
    train_cap = None
    if isinstance(cfg.get("reader"), dict):
        train_cap = cfg["reader"].pop("train_pillar_capacity", None)
    dtype_name = cfg.pop("dtype", "bfloat16")
    if dtype_name not in DTYPES:
        raise ValueError(f"model.dtype must be bfloat16 or float32, got {dtype_name!r}")
    dtype = DTYPES[dtype_name]
    if dtype is not None:
        for key in ("reader", "backbone", "neck", "head"):
            if isinstance(cfg.get(key), dict) and "_target_" in cfg[key]:
                cfg[key].setdefault("dtype", dtype)

    rd, bb = cfg.get("reader"), cfg.get("backbone")
    reader_name = str(rd.get("_target_", "")).split(".")[-1] if isinstance(rd, dict) else None
    backbone_name = str(bb.get("_target_", "")).split(".")[-1] if isinstance(bb, dict) else None
    if (
        reader_name == "PillarFeatureNet"
        and backbone_name == "SparseResNet"
        and list(bb.get("ds_layer_strides", [0]))[0] == 1
    ):
        rd.setdefault("output", "sparse")
        bb.setdefault("sparse_eval", True)
    if reader_name == "VoxelFeatureNet" and backbone_name == "SparseResNet3D":
        # the dense (B, 40, 1344, 1344, C) volume would not fit the card; in
        # training too (JAX utils/builders.py:85-93)
        rd.setdefault("output", "sparse")
    check_targets(cfg)
    model = instantiate(cfg, registry=PORT_REGISTRY)
    if train and train_cap:
        model.reader.train_pillar_capacity = int(train_cap)
    if train and sync_bn:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.sync = True
    if generator is not None:
        init_random(model, generator)
    return model.to(device).train(train)


def build_eval_model_scaled(model_cfg: dict, scale: float, device="cuda:0"):
    """The eval model with every reader table capacity (pillar, voxel,
    cylinder) multiplied by ``scale`` and rounded up to a 4096 quantum
    (builders.py:97-118).  Parameter shapes do not depend on capacity, so
    it takes the same weights: ``Trainer.val_epoch`` recomputes a batch
    whose active set overflowed the configured capacity on it, which gives
    the detections a model built with that capacity from the start would
    give.  A backbone that runs over tile stacks gets the full tile grid
    (``tile_capacity = 0``), which cannot overflow.  No parameters are
    drawn: load the weights afterwards."""
    cfg = copy.deepcopy(model_cfg)
    rd = cfg.get("reader")
    if isinstance(rd, dict):
        for key in ("pillar_capacity", "voxel_capacity", "cylinder_capacity"):
            if key in rd:
                rd[key] = int(-(-int(rd[key]) * scale // 4096)) * 4096
    bb = cfg.get("backbone")
    if isinstance(bb, dict) and (bb.get("sparse_stages_eval") == "tile" or bb.get("tile_stride1")):
        bb["tile_capacity"] = 0
    return build_model(cfg, device=device)


def build_dataset(ds_cfg: dict):
    """A dataset from ``cfg["data"]["train_dataset"]`` or ``["val_dataset"]``;
    the GT-paste sampler arrives as the factory its ``_partial_: True``
    asks for, which the dataset calls."""
    check_targets(ds_cfg)
    return instantiate(ds_cfg, registry=PORT_REGISTRY)


def build_optimizer(cfg: dict, steps_per_epoch: int, params):
    """(AdamW, schedule) over ``params`` from the optimizer / scheduler /
    trainer config groups."""
    from pillarnext_tpu_torch.train.train_state import make_optimizer

    sched, opt = cfg["scheduler"], cfg["optimizer"]
    total_steps = int(sched["epochs"]) * int(steps_per_epoch)
    return make_optimizer(
        params,
        max_lr=float(sched["max_lr"]),
        total_steps=max(total_steps, 1),
        betas=tuple(opt.get("betas", (0.9, 0.99))),
        weight_decay=float(opt.get("weight_decay", 0.01)),
        div_factor=float(sched.get("div_factor", 10.0)),
        pct_start=float(sched.get("pct_start", 0.4)),
        clip_grad_val=float(cfg["trainer"].get("clip_grad_val", 0.0)),
    )
