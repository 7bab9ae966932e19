"""Config targets -> the port's torch classes.

Counterpart of pillarnext_tpu/utils/registry.py:27-74.  ``PORT_REGISTRY``
maps the target names of the YAML tree (``pillarnext_tpu.*``, and the
reference's ``det3d.*`` aliases) to the port's classes, and every target
not ported yet to a builder that raises ``NotImplementedError``.  The
port's ``utils/config.instantiate`` resolves targets only here.
"""

from __future__ import annotations

from typing import Callable

from pillarnext_tpu_torch import models
from pillarnext_tpu_torch.data.assign import AssignLabel

_PORTED = {
    "pillarnext_tpu.models.SingleStageDetector": models.SingleStageDetector,
    "pillarnext_tpu.models.PillarFeatureNet": models.PillarFeatureNet,
    "pillarnext_tpu.models.SparseResNet": models.SparseResNet,
    "pillarnext_tpu.models.VoxelFeatureNet": models.VoxelFeatureNet,
    "pillarnext_tpu.models.MVFFeatureNet": models.MVFFeatureNet,
    "pillarnext_tpu.models.SparseResNet3D": models.SparseResNet3D,
    "pillarnext_tpu.models.ASPPNeck": models.ASPPNeck,
    "pillarnext_tpu.models.CenterHead": models.CenterHead,
    "pillarnext_tpu.data.AssignLabel": AssignLabel,
}
_NOT_PORTED = (
    "pillarnext_tpu.data.NuScenesDataset",
    "pillarnext_tpu.data.WaymoDataset",
    "pillarnext_tpu.data.DataBaseSampler",
    "pillarnext_tpu.data.DBFilterByMinNumPoint",
    "pillarnext_tpu.data.Flip",
    "pillarnext_tpu.data.Scaling",
    "pillarnext_tpu.data.Rotation",
    "pillarnext_tpu.data.Translation",
)
_ALIASES = {
    "det3d.models.detectors.single_stage.SingleStageDetector": "pillarnext_tpu.models.SingleStageDetector",
    "det3d.models.readers.pillar_encoder.PillarFeatureNet": "pillarnext_tpu.models.PillarFeatureNet",
    "det3d.models.readers.voxel_encoder.VoxelFeatureNet": "pillarnext_tpu.models.VoxelFeatureNet",
    "det3d.models.readers.mvf_encoder.MVFFeatureNet": "pillarnext_tpu.models.MVFFeatureNet",
    "det3d.models.backbones.sparse_resnet.SparseResNet": "pillarnext_tpu.models.SparseResNet",
    "det3d.models.backbones.sparse_resnet3d.SparseResNet3D": "pillarnext_tpu.models.SparseResNet3D",
    "det3d.models.necks.aspp.ASPPNeck": "pillarnext_tpu.models.ASPPNeck",
    "det3d.models.heads.centerhead.CenterHead": "pillarnext_tpu.models.CenterHead",
    "det3d.datasets.pipelines.assign.AssignLabel": "pillarnext_tpu.data.AssignLabel",
    "det3d.datasets.nuscenes.NuScenesDataset": "pillarnext_tpu.data.NuScenesDataset",
    "det3d.datasets.waymo.waymo.WaymoDataset": "pillarnext_tpu.data.WaymoDataset",
    "det3d.datasets.pipelines.sample_ops.DataBaseSamplerV2": "pillarnext_tpu.data.DataBaseSampler",
    "det3d.datasets.pipelines.sample_ops.DBFilterByMinNumPoint": "pillarnext_tpu.data.DBFilterByMinNumPoint",
    "det3d.datasets.pipelines.augmentation.Flip": "pillarnext_tpu.data.Flip",
    "det3d.datasets.pipelines.augmentation.Scaling": "pillarnext_tpu.data.Scaling",
    "det3d.datasets.pipelines.augmentation.Rotation": "pillarnext_tpu.data.Rotation",
    "det3d.datasets.pipelines.augmentation.Translation": "pillarnext_tpu.data.Translation",
}


def _not_ported(name: str) -> Callable:
    def build(**_kwargs):
        raise NotImplementedError(f"{name} is not ported yet, see ROADMAP")

    return build


def _registry() -> dict[str, Callable]:
    reg: dict[str, Callable] = dict(_PORTED)
    reg.update({name: _not_ported(name) for name in _NOT_PORTED})
    reg.update({alias: reg[canonical] for alias, canonical in _ALIASES.items()})
    return reg


PORT_REGISTRY = _registry()


def check_targets(node) -> None:
    """Raise for any ``_target_`` in a config tree that the port does not
    know (so no lookup ever falls through to the JAX registry)."""
    if isinstance(node, dict):
        target = node.get("_target_")
        if target is not None and target not in PORT_REGISTRY:
            raise NotImplementedError(f"unknown or unported _target_ {target!r}, see ROADMAP")
        for v in node.values():
            check_targets(v)
    elif isinstance(node, list):
        for v in node:
            check_targets(v)
