"""Detector modules (counterparts of pillarnext_tpu/models)."""

from pillarnext_tpu_torch.models.aspp import ASPPNeck
from pillarnext_tpu_torch.models.centerhead import CenterHead
from pillarnext_tpu_torch.models.detector import SingleStageDetector
from pillarnext_tpu_torch.models.mvf_encoder import MVFFeatureNet
from pillarnext_tpu_torch.models.pillar_encoder import PillarFeatureNet
from pillarnext_tpu_torch.models.resnet import SparseResNet, SparseResNet3D
from pillarnext_tpu_torch.models.voxel_encoder import VoxelFeatureNet

__all__ = [
    "ASPPNeck", "CenterHead", "MVFFeatureNet", "PillarFeatureNet", "SingleStageDetector",
    "SparseResNet", "SparseResNet3D", "VoxelFeatureNet",
]
