"""OpenCV camera conversions module (port of
pytorch3d_tpu/utils/camera_conversions.py).

The functions live in renderer/camera_conversions.py; this module mirrors
the JAX package's file layout.
"""

from ..renderer.camera_conversions import (  # noqa: F401
    cameras_from_opencv_projection,
    opencv_from_cameras_projection,
    pulsar_from_cameras_projection,
    pulsar_from_opencv_projection,
)
