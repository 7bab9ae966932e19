"""Detector modules (counterparts of pillarnext_tpu/models)."""

from pillarnext_tpu_torch.models.aspp import ASPPNeck
from pillarnext_tpu_torch.models.centerhead import CenterHead
from pillarnext_tpu_torch.models.detector import SingleStageDetector
from pillarnext_tpu_torch.models.pillar_encoder import PillarFeatureNet
from pillarnext_tpu_torch.models.resnet import SparseResNet

__all__ = ["ASPPNeck", "CenterHead", "PillarFeatureNet", "SingleStageDetector", "SparseResNet"]
