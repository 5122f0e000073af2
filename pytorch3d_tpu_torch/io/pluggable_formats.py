"""Pluggable-format interfaces (port of pytorch3d_tpu/io/pluggable_formats.py):
the classes live in `pluggable.py`; this module mirrors the file layout."""

from .pluggable import (  # noqa: F401
    MeshFormatInterpreter,
    PointcloudFormatInterpreter,
    endswith,
)
