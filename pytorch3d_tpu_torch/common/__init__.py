"""Shared helpers of the port (port of pytorch3d_tpu/common)."""

import torch

# Every constructor and entry point of the port runs on the card unless the
# caller passes another device.
DEFAULT_DEVICE = torch.device("cuda")

from .datatypes import Device, get_device, make_device  # noqa: E402
from .linear_with_repeat import LinearWithRepeat  # noqa: E402
from .math_utils import safe_norm, safe_normalize  # noqa: E402
from .symeig3x3 import symeig3x3  # noqa: E402
