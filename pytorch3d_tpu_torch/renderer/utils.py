"""Renderer utilities (port of pytorch3d_tpu/renderer/utils.py):
`TensorProperties` with `TensorAccessor`, tensor formatting and
broadcasting, image-size parsing and grid sampling at NDC locations.

The port's cameras, lights and materials are dataclasses of their own;
`TensorProperties` is the broadcasting base for user code that subclasses
it directly.
"""

from __future__ import annotations

import copy
from typing import Tuple, Union

import numpy as np
import torch

from ..common import DEFAULT_DEVICE
from ..ops.grid_sample import grid_sample

Device = Union[str, torch.device]


class TensorProperties:
    """Batched attributes: keyword tensors (or numbers, lists, arrays) are
    broadcast along dim 0 to a common batch size N; other keywords are
    stored as they are."""

    def __init__(self, dtype: torch.dtype = torch.float32, device: Device = DEFAULT_DEVICE, **kwargs) -> None:
        self.device = torch.device(device)
        batched = {
            k: v if torch.is_tensor(v) else torch.atleast_1d(torch.as_tensor(v, dtype=dtype, device=self.device))
            for k, v in kwargs.items()
            if v is not None and isinstance(v, (float, int, list, tuple, np.ndarray, torch.Tensor))
        }
        N = max((v.shape[0] if v.ndim > 0 else 1 for v in batched.values()), default=0)
        self._N = N
        for k, v in batched.items():
            if v.ndim == 0:
                v = v[None]
            if v.shape[0] == 1 and N > 1:
                v = v.expand((N,) + tuple(v.shape[1:]))
            elif v.shape[0] not in (N, 1):
                raise ValueError(f"Tensor {k} has incompatible batch dim")
            setattr(self, k, v)
        for k, v in kwargs.items():
            if k not in batched:
                setattr(self, k, v)

    def __len__(self) -> int:
        return self._N

    def _batched_items(self):
        return [(k, v) for k, v in vars(self).items() if torch.is_tensor(v) and v.ndim > 0 and v.shape[0] == self._N]

    def __getitem__(self, index):
        """A shallow copy holding the batch entries at `index` (an int keeps
        the batch dimension and is checked against the batch size)."""
        if isinstance(index, int):
            if not -self._N <= index < self._N:
                raise IndexError(f"index {index} out of range for batch size {self._N}")
            index = slice(index % self._N, index % self._N + 1)
        out = copy.copy(self)
        for k, v in self._batched_items():
            setattr(out, k, v[index])
            out._N = getattr(out, k).shape[0]
        return out

    def isempty(self) -> bool:
        return self._N == 0

    def to(self, device: Device = DEFAULT_DEVICE):
        """Every tensor attribute moved to `device` (in place; returns self)."""
        self.device = torch.device(device)
        for k, v in list(vars(self).items()):
            if torch.is_tensor(v):
                setattr(self, k, v.to(self.device))
        return self

    def clone(self, other=None):
        """A copy with every tensor attribute cloned."""
        out = copy.copy(self)
        for k, v in vars(self).items():
            setattr(out, k, v.clone() if torch.is_tensor(v) else copy.deepcopy(v))
        return out

    def gather_props(self, batch_idx):
        """Every batched attribute indexed by `batch_idx` (in place)."""
        n = self._N
        for k, v in self._batched_items():
            setattr(self, k, v[batch_idx])
            n = getattr(self, k).shape[0]
        self._N = n
        return self


class TensorAccessor:
    """One batch entry of a TensorProperties object: reads index the
    owner's batched attributes; writes replace them with a copy holding the
    new entry (a broadcast attribute is a view that cannot be written in
    place)."""

    def __init__(self, class_object, index) -> None:
        self.__dict__["class_object"] = class_object
        self.__dict__["index"] = index

    def __getattr__(self, name: str):
        full = getattr(self.__dict__["class_object"], name)
        if torch.is_tensor(full) and full.ndim > 0:
            return full[self.__dict__["index"]]
        return full

    def __setattr__(self, name: str, value) -> None:
        obj = self.__dict__["class_object"]
        full = getattr(obj, name, None)
        if torch.is_tensor(full) and full.ndim > 0:
            new = full.clone()
            new[self.__dict__["index"]] = torch.as_tensor(value, dtype=full.dtype, device=full.device)
            value = new
        setattr(obj, name, value)


def format_tensor(input, dtype: torch.dtype = torch.float32, device: Device = DEFAULT_DEVICE) -> torch.Tensor:
    """A number, sequence or tensor as a tensor with at least one
    dimension; a tensor keeps its device."""
    if torch.is_tensor(input):
        x = input.to(dtype=dtype)
    else:
        x = torch.as_tensor(input, dtype=dtype, device=device)
    return x.reshape(1) if x.ndim == 0 else x


def convert_to_tensors_and_broadcast(*args, dtype: torch.dtype = torch.float32, device: Device = DEFAULT_DEVICE):
    """The inputs as tensors with their leading (batch) dims broadcast to
    the largest."""
    tensors = [format_tensor(a, dtype=dtype, device=device) for a in args]
    sizes = [t.shape[0] for t in tensors]
    N = max(sizes)
    if not all(s in (1, N) for s in sizes):
        raise ValueError(f"Got non-broadcastable sizes {sizes}")
    return [t.expand((N,) + tuple(t.shape[1:])) if t.shape[0] == 1 else t for t in tensors]


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


def ndc_to_grid_sample_coords(xy_ndc: torch.Tensor, image_size_hw: Tuple[int, int]) -> torch.Tensor:
    """+X-left/+Y-up NDC coordinates to grid_sample's +x-right/+y-down
    [-1, 1] coordinates, for a possibly non-square image."""
    H, W = image_size_hw
    aspect = min(H, W)
    return -xy_ndc * xy_ndc.new_tensor([aspect / W, aspect / H])


def ndc_grid_sample(
    input: torch.Tensor,  # (N, C, H, W)
    grid_ndc: torch.Tensor,  # (N, ..., 2) NDC coordinates
    mode: str = "bilinear",
    align_corners: bool = False,
    **kwargs,
) -> torch.Tensor:
    """grid_sample at NDC locations, through the port's `ops/grid_sample.py`
    (the JAX package's arithmetic): (N, C, ...)."""
    N, C, H, W = input.shape
    spatial = tuple(grid_ndc.shape[1:-1])
    grid = ndc_to_grid_sample_coords(grid_ndc.reshape(N, -1, 2), (H, W))[:, None]  # (N, 1, P, 2)
    out = grid_sample(input, grid, mode=mode, align_corners=align_corners,
                      padding_mode=kwargs.get("padding_mode", "zeros"))  # (N, C, 1, P)
    return out[:, :, 0].reshape((N, C) + spatial)


def ndc_grid_sample_packed(
    input: torch.Tensor,  # (N, C, H, W)
    xys_ndc: torch.Tensor,  # (R, 2) NDC coordinates, one per packed ray
    camera_ids: torch.Tensor,  # (R,) image index per ray
    mode: str = "bilinear",
) -> torch.Tensor:
    """`ndc_grid_sample` for a packed ray bundle: each ray gathers its
    (bilinear: four) neighbour pixels from its own image, as
    `ndc_grid_sample(..., align_corners=False, padding_mode="zeros")`.
    Returns (R, C)."""
    N, C, H, W = input.shape
    grid = ndc_to_grid_sample_coords(xys_ndc, (H, W))
    # align_corners=False pixel-centre mapping
    px = ((grid[:, 0] + 1.0) * W - 1.0) * 0.5
    py = ((grid[:, 1] + 1.0) * H - 1.0) * 0.5
    cam = camera_ids.long()

    def fetch(ix, iy):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        v = input[cam, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]  # (R, C)
        return torch.where(valid[:, None], v, 0.0)

    if mode == "nearest":
        return fetch(torch.round(px).long(), torch.round(py).long())
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = (px - x0)[:, None], (py - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    return (
        fetch(x0, y0) * (1 - wx) * (1 - wy)
        + fetch(x0 + 1, y0) * wx * (1 - wy)
        + fetch(x0, y0 + 1) * (1 - wx) * wy
        + fetch(x0 + 1, y0 + 1) * wx * wy
    )
