"""Linear layer on (input, repeated-input) pairs, used by NeRF colour heads
(port of pytorch3d_tpu/common/linear_with_repeat.py)."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from . import DEFAULT_DEVICE


class LinearWithRepeat(nn.Module):
    """y = Linear(concat(x, broadcast(z))) without building the
    concatenation: two partial products.  x is (..., S, D1), z (..., D2)
    broadcast over S, and D1 + D2 = `in_features`.

    The parameters keep the flax layout and names: `kernel` (in, out),
    lecun-normal (truncated normal of variance 1 / in_features) as flax
    initialises it, and `bias` (out,), zero.
    """

    def __init__(self, in_features: int, out_features: int, device: Union[str, torch.device] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kernel = torch.empty((in_features, out_features), device=device)
        # flax's lecun_normal: std of the truncated (+-2) normal corrected to 1/sqrt(fan_in)
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        nn.init.trunc_normal_(kernel, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, inputs: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x, z = inputs
        d1 = x.shape[-1]
        return x @ self.kernel[:d1] + (z @ self.kernel[d1:])[..., None, :] + self.bias
