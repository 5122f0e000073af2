"""Packed <-> padded gathers over ragged batches (port of
pytorch3d_tpu/ops/packed_to_padded.py).  Both directions are gathers with
computed indices; autograd's gather backward is their backward."""

from __future__ import annotations

import torch


def packed_to_padded(inputs: torch.Tensor, first_idxs: torch.Tensor, max_size: int) -> torch.Tensor:
    """(F, ...) packed with (N,) first indices -> (N, max_size, ...) padded;
    the rows past each segment are 0."""
    flat = inputs.ndim == 1
    if flat:
        inputs = inputs[:, None]
    F = inputs.shape[0]
    first_idxs = first_idxs.long()
    ends = torch.cat([first_idxs[1:], first_idxs.new_tensor([F])])
    k = torch.arange(max_size, device=inputs.device)[None, :]
    src = first_idxs[:, None] + k  # (N, M)
    valid = k < (ends - first_idxs)[:, None]
    out = inputs[torch.clamp(src, 0, F - 1)]
    out = torch.where(valid.reshape(valid.shape + (1,) * (out.ndim - 2)), out, 0.0)
    return out[..., 0] if flat else out


def padded_to_packed(
    inputs: torch.Tensor, first_idxs: torch.Tensor, num_inputs: int, max_size_dim: int = 1
) -> torch.Tensor:
    """(N, M, ...) padded -> (num_inputs, ...) packed rows."""
    inputs = torch.movedim(inputs, max_size_dim, 1)
    N, M = inputs.shape[:2]
    flat = inputs.reshape((N * M,) + tuple(inputs.shape[2:]))
    first_idxs = first_idxs.long()
    i = torch.arange(num_inputs, device=inputs.device)
    seg = torch.searchsorted(first_idxs, i, right=True) - 1
    return flat[seg * M + (i - first_idxs[seg])]
