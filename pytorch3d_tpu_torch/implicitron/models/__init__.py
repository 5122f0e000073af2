"""Implicitron models (port of pytorch3d_tpu/implicitron/models):
GenericModel on its NeRF path, OverfitModel, ModelDBIR and the metrics."""
from .generic_model import GenericModel
from .metrics import RegularizationMetrics, ViewMetrics
from .overfit_model import ModelDBIR, OverfitModel

__all__ = [k for k in dir() if not k.startswith("_")]
