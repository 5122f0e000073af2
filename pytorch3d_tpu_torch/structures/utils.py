"""List-to-padded conversion (port of pytorch3d_tpu/structures/utils.py;
`list_to_padded` so far).  It runs at the host boundary: a list of
variable-size tensors in, one padded tensor out.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def list_to_padded(
    x: Sequence[torch.Tensor],
    pad_size: Optional[Sequence[int]] = None,
    pad_value: float = 0.0,
    equisized: bool = False,
) -> torch.Tensor:
    """Stack a list of (Ki, ...) tensors into (N, K_max, ...) with padding.

    The result lies on the device and has the dtype of the first item.
    """
    if equisized:
        return torch.stack(list(x), dim=0)
    ndim = x[0].ndim
    if any(t.ndim != ndim for t in x):
        raise ValueError("All items have to have the same number of dimensions!")
    if pad_size is None:
        pad_dims = [max(t.shape[d] for t in x) for d in range(ndim)]
    else:
        if len(pad_size) != ndim:
            raise ValueError("Pad size must contain target size for all dimensions.")
        pad_dims = list(pad_size)
    out = torch.full(
        (len(x), *pad_dims), pad_value, dtype=x[0].dtype, device=x[0].device
    )
    for i, t in enumerate(x):
        if t.numel() == 0:
            continue
        out[(i,) + tuple(slice(0, s) for s in t.shape)] = t
    return out

