"""Global (per-sequence / per-time) encoders (port of
pytorch3d_tpu/implicitron/models/global_encoder/global_encoder.py): a code
per sequence (`SequenceAutodecoder`) or a harmonic embedding of the frame's
timestamp (`HarmonicTimeEncoder`), concatenated to every point's embedding
by the implicit function."""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ....common import DEFAULT_DEVICE
from ....renderer.implicit.harmonic_embedding import HarmonicEmbedding
from ...tools.config import ReplaceableBase, expand_args_fields, registry
from .autodecoder import Autodecoder

Device = Union[str, torch.device]


class GlobalEncoderBase(ReplaceableBase):
    def get_encoding_dim(self) -> int:
        raise NotImplementedError

    def calculate_squared_encoding_norm(self):
        return None


@registry.register
class SequenceAutodecoder(GlobalEncoderBase, nn.Module):
    """A learned code per sequence name."""

    encoding_dim: int = 64
    n_instances: int = 100
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        self.autodecoder = Autodecoder(self.encoding_dim, self.n_instances, device=self.device,
                                       generator=self.generator)
        self.generator = None

    def get_encoding_dim(self) -> int:
        return self.encoding_dim

    def forward(self, frame_timestamp=None, sequence_name=None, **kwargs):
        return self.autodecoder(sequence_name)


@registry.register
class HarmonicTimeEncoder(GlobalEncoderBase, nn.Module):
    """The harmonic embedding of frame_timestamp / time_divisor."""

    n_harmonic_functions: int = 10
    append_input: bool = True
    time_divisor: float = 1.0
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        self._harmonic_embedding = HarmonicEmbedding(
            n_harmonic_functions=self.n_harmonic_functions, append_input=self.append_input
        )

    def get_encoding_dim(self) -> int:
        return HarmonicEmbedding.get_output_dim_static(1, self.n_harmonic_functions, self.append_input)

    def forward(self, frame_timestamp=None, sequence_name=None, **kwargs):
        if frame_timestamp is None:
            raise ValueError("HarmonicTimeEncoder requires frame_timestamp")
        t = torch.as_tensor(frame_timestamp, dtype=torch.float32, device=self.device).reshape(-1, 1)
        return self._harmonic_embedding(t / self.time_divisor)


for _cls in (SequenceAutodecoder, HarmonicTimeEncoder):
    expand_args_fields(_cls)
