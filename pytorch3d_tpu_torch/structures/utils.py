"""List, padded and packed conversions (port of
pytorch3d_tpu/structures/utils.py).  They run at the host boundary: lists
of variable-size tensors in or out, and sizes read on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

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



def padded_to_list(x: torch.Tensor, split_size: Optional[Sequence] = None) -> List[torch.Tensor]:
    """Split (N, K, ...) into a list of N tensors, each cut to its entry of
    `split_size` (an int for dim 1, or a tuple of sizes for the leading dims)."""
    x_list = list(x.unbind(0))
    if split_size is None:
        return x_list
    if len(split_size) != x.shape[0]:
        raise ValueError("Split size must be of same length as inputs first dimension")
    for i, s in enumerate(split_size):
        if isinstance(s, int):
            x_list[i] = x_list[i][:s]
        else:
            x_list[i] = x_list[i][tuple(slice(0, d) for d in s)]
    return x_list


def list_to_packed(x: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate a list of (K_i, ...) tensors along dim 0.

    Returns (x_packed, num_items (N,), item_packed_first_idx (N,),
    item_packed_to_list_idx (sum K_i,)), the index tensors int64 on the
    first item's device.
    """
    device = x[0].device
    sizes = torch.tensor([int(t.shape[0]) for t in x], dtype=torch.int64, device=device)
    first_idx = torch.cumsum(sizes, 0) - sizes
    to_list_idx = torch.arange(len(x), device=device).repeat_interleave(sizes)
    return torch.cat(list(x), dim=0), sizes, first_idx, to_list_idx


def packed_to_list(x: torch.Tensor, split_size: Union[Sequence[int], int]) -> List[torch.Tensor]:
    """Split a packed (sum K_i, ...) tensor into a list: consecutive pieces
    of `split_size` rows, or of each size in the list."""
    if isinstance(split_size, int):
        n = x.shape[0] // split_size
        return [x[i * split_size:(i + 1) * split_size] for i in range(n)]
    return list(torch.split(x, [int(s) for s in split_size], dim=0))


def padded_to_packed(
    x: torch.Tensor,
    split_size: Optional[Sequence[int]] = None,
    pad_value: Optional[float] = None,
    max_size_dim: int = 1,
) -> torch.Tensor:
    """Flatten (N, K, ...) into packed rows, dropping the padding: all N*K
    rows, the first split_size[i] rows of item i, or the rows not entirely
    equal to `pad_value` (one host sync)."""
    if split_size is not None and pad_value is not None:
        raise ValueError("Only one of split_size or pad_value should be provided.")
    if max_size_dim != 1:
        x = torch.movedim(x, max_size_dim, 1)
    N, M = x.shape[:2]
    if split_size is None and pad_value is None:
        return x.reshape((N * M,) + tuple(x.shape[2:]))
    if pad_value is not None:
        keep = ~(x.reshape(N, M, -1) == pad_value).all(dim=-1)
        return x[keep]
    if len(split_size) != N:
        raise ValueError("Split size must be of same length as inputs first dimension")
    return torch.cat([x[i, : int(split_size[i])] for i in range(N)], dim=0)
