"""IDR's surface shading network (port of
pytorch3d_tpu/implicitron/models/renderer/rgb_net.py): an MLP from
(points, view directions, surface normals, feature vectors) to tanh
colours, with an optional harmonic embedding of the directions, weight
norm (`idr_feature_field._WeightNormDense`), and modes that leave out the
normals ("no_normal") or the directions ("no_view_dir").

The layers are `linear{l}` in flax's layout; their input width is what the
mode concatenates (flax infers it; `d_in` is kept for the config's sake).
The kernels and biases start as torch's `nn.Linear` does, uniform in
+-1 / sqrt(fan_in), and weight norm's scale at the kernel's column norms.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ....common import DEFAULT_DEVICE
from ....renderer.implicit.harmonic_embedding import HarmonicEmbedding
from ..implicit_function.idr_feature_field import dense

Device = Union[str, torch.device]

MODES = ("idr", "no_view_dir", "no_normal")


class RayNormalColoringNetwork(nn.Module):
    def __init__(
        self,
        feature_vector_size: int = 3,
        mode: str = "idr",
        d_in: int = 9,
        d_out: int = 3,
        dims: Tuple[int, ...] = (512, 512, 512, 512),
        weight_norm: bool = True,
        n_harmonic_functions_dir: int = 0,
        pooled_feature_dim: int = 0,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"Unsupported rendering mode: {mode}")
        self.mode = mode
        self.embed_dir = HarmonicEmbedding(n_harmonic_functions_dir, append_input=True) \
            if n_harmonic_functions_dir > 0 else None
        width_dir = self.embed_dir.get_output_dim(3) if self.embed_dir is not None else 3
        width = 3 + feature_vector_size + pooled_feature_dim + (3 if mode != "no_normal" else 0) + (
            width_dir if mode != "no_view_dir" else 0)
        self.n_layers = len(dims) + 1
        for li, out_dim in enumerate(list(dims) + [d_out]):
            bound = 1.0 / math.sqrt(width)

            def uniform(t, bound=bound):
                t.copy_(torch.rand(t.shape, generator=generator, device=t.device) * (2 * bound) - bound)

            self.add_module(f"linear{li}", dense(width, out_dim, weight_norm, uniform, uniform, device))
            width = out_dim

    def forward(
        self,
        feature_vectors: torch.Tensor,  # (..., F)
        points: torch.Tensor,  # (..., 3)
        normals: torch.Tensor,  # (..., 3)
        directions: torch.Tensor,  # (..., 3) the view direction at each point
        pooling_fn=None,
    ) -> torch.Tensor:
        view_dirs = self.embed_dir(directions) if self.embed_dir is not None else directions
        parts = {"idr": [points, view_dirs, normals, feature_vectors],
                 "no_view_dir": [points, normals, feature_vectors],
                 "no_normal": [points, view_dirs, feature_vectors]}[self.mode]
        if pooling_fn is not None:
            parts.append(pooling_fn(points[None])[0])
        x = torch.cat(parts, dim=-1)
        for li in range(self.n_layers):
            x = getattr(self, f"linear{li}")(x)
            if li < self.n_layers - 1:
                x = torch.relu(x)
        return torch.tanh(x)
