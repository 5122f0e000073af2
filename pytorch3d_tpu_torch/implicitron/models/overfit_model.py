"""OverfitModel: the single-scene specialisation of GenericModel (port of
pytorch3d_tpu/implicitron/models/overfit_model.py).  `ModelDBIR` stands in
`model_dbir.py`, as in the reference's layout."""

from __future__ import annotations

from ..tools.config import expand_args_fields, registry
from .generic_model import GenericModel
from .model_dbir import ModelDBIR  # noqa: F401 (the JAX module defines it here)


@registry.register
class OverfitModel(GenericModel):
    """GenericModel for overfitting one scene: no view pooling or global
    code, a coarse and a fine pass; only the defaults differ."""

    num_passes: int = 2
    chunk_size_grid: int = 4096


expand_args_fields(OverfitModel)
