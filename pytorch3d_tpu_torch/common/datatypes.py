"""Device normalization (port of pytorch3d_tpu/common/datatypes.py)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import DEFAULT_DEVICE

Device = Union[str, torch.device]


def make_device(device: Device = DEFAULT_DEVICE) -> torch.device:
    """'cpu' | 'cuda' | 'cuda:N' | torch.device -> torch.device; a CUDA
    device without an index takes the current one when CUDA is available."""
    device = torch.device(device) if isinstance(device, str) else device
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device(f"cuda:{torch.cuda.current_device()}")
    return device


def get_device(x, device: Optional[Device] = None) -> torch.device:
    """`device` if given, else the device of the tensor x, else the
    package's default device."""
    if device is not None:
        return make_device(device)
    if torch.is_tensor(x):
        return x.device
    return make_device(DEFAULT_DEVICE)
