"""Compat helpers (port of pytorch3d_tpu/common/compat.py)."""

from __future__ import annotations

import math
from typing import Iterable

import torch


def meshgrid_ij(*A):
    """torch.meshgrid with matrix indexing."""
    return torch.meshgrid(*A, indexing="ij")


def prod(iterable: Iterable, *, start=1):
    """math.prod."""
    return math.prod(iterable, start=start)
