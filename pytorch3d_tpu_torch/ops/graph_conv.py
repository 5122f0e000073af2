"""Graph convolution over mesh edges (port of pytorch3d_tpu/ops/graph_conv.py).

The neighbour sum is a segment sum over the edges: `index_add_` into a
buffer of V + 1 rows whose last row takes the padding edges and is
dropped, as the JAX package's `segment_sum` does.  Its backward is
autograd's gather.  `GraphConv` is an `nn.Module` whose two `nn.Linear`s
take a flax `GraphConv`'s kernels transposed
(`convert.graph_conv_state_dict_from_flax`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..common import DEFAULT_DEVICE


def gather_scatter(input: torch.Tensor, edges: torch.Tensor, directed: bool = False) -> torch.Tensor:
    """out[i] = sum of input[j] over the edges (i, j), and over (j, i) too
    unless `directed`.  input (V, D); edges (E, 2) int, rows with a -1 are
    padding.  Returns (V, D)."""
    V = input.shape[0]
    valid = torch.all(edges >= 0, dim=-1)

    def segment(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        rows = input[src.clamp(min=0)] * valid[:, None]
        out = input.new_zeros((V + 1, input.shape[1]))
        return out.index_add_(0, torch.where(valid, dst, V), rows)

    out = segment(edges[:, 1], edges[:, 0])
    if not directed:
        out = out + segment(edges[:, 0], edges[:, 1])
    return out[:V]


def gather_scatter_python(input: torch.Tensor, edges: torch.Tensor, directed: bool = False) -> torch.Tensor:
    """PyTorch3D's name for its plain version: the same function."""
    return gather_scatter(input, edges, directed)


class GatherScatter:
    """`gather_scatter` as an object (PyTorch3D's autograd Function)."""

    def __init__(self, directed: bool = False) -> None:
        self.directed = directed

    def __call__(self, input: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
        return gather_scatter(input, edges, self.directed)


class GraphConv(nn.Module):
    """y_i = W0 x_i + sum over the neighbours j of i of W1 x_j.

    `init_method` "normal" draws the weights from N(0, 0.01^2) (from
    `generator` where given) and zeroes the biases; "zero" zeroes both."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        init_method: str = "normal",
        directed: bool = False,
        device=DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if init_method not in ("normal", "zero"):
            raise ValueError('Invalid GraphConv initialization "%s"' % init_method)
        self.input_dim, self.output_dim, self.directed = input_dim, output_dim, directed
        self.w0 = nn.Linear(input_dim, output_dim, device=device)
        self.w1 = nn.Linear(input_dim, output_dim, device=device)
        with torch.no_grad():
            for layer in (self.w0, self.w1):
                if init_method == "normal":
                    layer.weight.normal_(0.0, 0.01, generator=generator)
                else:
                    layer.weight.zero_()
                layer.bias.zero_()

    def forward(self, verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
        if verts.shape[0] == 0:
            return verts.new_zeros((0, self.output_dim))
        return self.w0(verts) + gather_scatter(self.w1(verts), edges, self.directed)
