"""Config -> the port's eval model.

Counterpart of ``build_model`` (pillarnext_tpu/utils/builders.py:38-94).
"""

from __future__ import annotations

import copy

import torch

from pillarnext_tpu.utils.config import instantiate
from pillarnext_tpu_torch.utils.registry import PORT_REGISTRY, check_targets
from pillarnext_tpu_torch.utils.weights import init_random

DTYPES = {"bfloat16": torch.bfloat16, "float32": None, None: None}


def build_model(model_cfg: dict, device=None, generator: torch.Generator | None = None):
    """Instantiate the detector from the resolved ``cfg["model"]`` dict.

    ``model.dtype`` ('bfloat16' default, or 'float32') is the activation
    dtype of every submodule; parameters, BN statistics and decode/NMS stay
    float32.  ``sync_batchnorm`` is dropped (training is not ported).  A
    pillar reader feeding a SparseResNet that opens with stride 1 emits its
    compact table and the backbone runs that stage sparse (the reference's
    sparse path).  With ``generator`` the parameters are drawn from it
    (utils/weights.py: init_random); otherwise load weights afterwards.
    Returns the model in eval mode on ``device``.
    """
    cfg = copy.deepcopy(model_cfg)
    cfg.pop("sync_batchnorm", None)
    if isinstance(cfg.get("reader"), dict):
        cfg["reader"].pop("train_pillar_capacity", None)
    dtype_name = cfg.pop("dtype", "bfloat16")
    if dtype_name not in DTYPES:
        raise ValueError(f"model.dtype must be bfloat16 or float32, got {dtype_name!r}")
    dtype = DTYPES[dtype_name]
    if dtype is not None:
        for key in ("reader", "backbone", "neck", "head"):
            if isinstance(cfg.get(key), dict) and "_target_" in cfg[key]:
                cfg[key].setdefault("dtype", dtype)

    rd, bb = cfg.get("reader"), cfg.get("backbone")
    if (
        isinstance(rd, dict)
        and str(rd.get("_target_", "")).split(".")[-1] == "PillarFeatureNet"
        and isinstance(bb, dict)
        and str(bb.get("_target_", "")).split(".")[-1] == "SparseResNet"
        and list(bb.get("ds_layer_strides", [0]))[0] == 1
    ):
        rd.setdefault("output", "sparse")
        bb.setdefault("sparse_eval", True)
    check_targets(cfg)
    model = instantiate(cfg, registry=PORT_REGISTRY)
    if generator is not None:
        init_random(model, generator)
    return model.to(device).eval()
