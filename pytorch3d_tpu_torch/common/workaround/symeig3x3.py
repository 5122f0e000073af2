"""symeig3x3 module (port of pytorch3d_tpu/common/workaround/symeig3x3.py).

The implementation lives in common/symeig3x3.py; this module mirrors the
JAX package's file layout.
"""

from ..symeig3x3 import symeig3x3  # noqa: F401
