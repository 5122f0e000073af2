"""Numerical workarounds: symmetric eigendecomposition and a 3x3
determinant (port of pytorch3d_tpu/common/workaround)."""
from ..symeig3x3 import symeig3x3  # noqa: F401
from .utils import _safe_det_3x3  # noqa: F401
