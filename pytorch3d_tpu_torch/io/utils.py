"""IO helpers (port of pytorch3d_tpu/io/utils.py): `PathOrStr`,
`_open_file`, `_check_faces_indices` and `_make_tensor`, on torch."""

from __future__ import annotations

import contextlib
import pathlib
import warnings
from typing import IO, ContextManager, Union

import numpy as np
import torch

from ..common import DEFAULT_DEVICE

PathOrStr = Union[pathlib.Path, str]


def _open_file(f, path_manager=None, mode: str = "r") -> ContextManager[IO]:
    """Open a path, or pass through an already-open stream."""
    if isinstance(f, (str, pathlib.Path)):
        return open(str(f), mode)
    return contextlib.nullcontext(f)


def _check_faces_indices(faces_indices: torch.Tensor, max_index: int, pad_value=None) -> torch.Tensor:
    """Warn about out-of-bounds face indices; rows all equal to `pad_value`
    are padding and not checked."""
    if pad_value is None:
        mask = torch.ones(faces_indices.shape[:-1], dtype=torch.bool, device=faces_indices.device)
    else:
        mask = ~(faces_indices == pad_value).all(dim=-1)
    if bool(((faces_indices[mask] >= max_index) | (faces_indices[mask] < 0)).any()):
        warnings.warn("Faces have invalid indices")
    return faces_indices


def _make_tensor(data, cols: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """List of rows to a (len, cols) tensor, empty-safe."""
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    if not len(data):
        return torch.zeros((0, cols), dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(data), dtype=dtype, device=device)


def _to_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device(device) -> torch.device:
    """`device`, or the card where it is None."""
    return DEFAULT_DEVICE if device is None else torch.device(device)
