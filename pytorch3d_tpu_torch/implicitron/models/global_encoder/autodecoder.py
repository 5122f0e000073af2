"""Autodecoder: a learned code per sequence (port of
pytorch3d_tpu/implicitron/models/global_encoder/autodecoder.py)."""

from __future__ import annotations

import zlib
from typing import List, Optional, Union

import torch
from torch import nn

from ....common import DEFAULT_DEVICE

Device = Union[str, torch.device]


class Autodecoder(nn.Module):
    """An (n_instances, encoding_dim) table, normal with deviation
    init_scale / sqrt(encoding_dim) as flax's `nn.Embed` is initialised
    here.  A sequence name maps to row crc32(name) % n_instances, an
    integer code x to row x % n_instances."""

    def __init__(
        self,
        encoding_dim: int = 0,
        n_instances: int = 1,
        init_scale: float = 1.0,
        ignore_input: bool = False,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.encoding_dim = encoding_dim
        self.n_instances = n_instances
        self.ignore_input = ignore_input
        if encoding_dim > 0:
            table = torch.empty((n_instances, encoding_dim), device=device)
            nn.init.normal_(table, std=init_scale / max(encoding_dim, 1) ** 0.5, generator=generator)
            self.embedding = nn.Parameter(table)

    def rows(self, x: Union[torch.Tensor, List[str], None]) -> torch.Tensor:
        """The table rows (B,) that `x` selects: row 0 for None or
        `ignore_input` (a single scene shares one code)."""
        if self.ignore_input or x is None:
            return torch.zeros((1,), dtype=torch.long, device=self.embedding.device)
        if isinstance(x, (list, tuple)):
            # crc32, not hash(): python's hash is salted per process, and a
            # resumed run must map each sequence to the same code
            ids = [zlib.crc32(s.encode("utf8")) % self.n_instances for s in x]
            return torch.tensor(ids, dtype=torch.long, device=self.embedding.device)
        return torch.as_tensor(x, device=self.embedding.device).long() % self.n_instances

    def forward(self, x: Union[torch.Tensor, List[str], None]) -> Optional[torch.Tensor]:
        """(B, encoding_dim) codes, or None when encoding_dim <= 0."""
        if self.encoding_dim <= 0:
            return None
        return self.embedding[self.rows(x)]

    def get_encoding_dim(self) -> int:
        return self.encoding_dim
