"""Renderer utilities (port of pytorch3d_tpu/renderer/utils.py, as far as
the mesh rendering path needs them)."""

from __future__ import annotations

from typing import Tuple


def parse_image_size(image_size) -> Tuple[int, int]:
    """Normalize an image-size argument to (H, W) of positive ints."""
    if not isinstance(image_size, (tuple, list)):
        image_size = (image_size, image_size)
    if len(image_size) != 2:
        raise ValueError("Image size can only be a tuple/list of (H, W)")
    H, W = image_size
    if not (isinstance(H, int) and isinstance(W, int) and H > 0 and W > 0):
        raise ValueError(f"image_size must be positive ints, got {image_size!r}")
    return H, W
