"""Implicit function plugin base (port of
pytorch3d_tpu/implicitron/models/implicit_function/base.py)."""

from __future__ import annotations

from ...tools.config import ReplaceableBase


class ImplicitFunctionBase(ReplaceableBase):
    """Callable (ray_bundle) -> (densities (..., S, 1), features (..., S, C)).

    Implementations holding parameters are `torch.nn.Module`s; the registry
    builds them from `implicit_function_class_type` and its arguments.
    """
