"""Row gathers by id with -1 for "none", for per-pixel and per-slot lookups."""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] of shape (*ids.shape, *table.shape[1:]) where ids >= 0.

    Where ids < 0 the result holds some row of the table: the caller masks
    what it derives from those rows, at the smallest tensor it can (a
    where over the gathered rows themselves costs a pass over the largest
    tensor of a render).  Gathers with `index_select`, whose backward is an
    `index_add_`.  Empty ids read rows spread over the table rather than all
    row 0, so that the backward adds their masked-out zeros without piling
    atomics onto one row (advanced indexing's backward serialises over such
    duplicates).
    """
    flat = ids.reshape(-1)
    spread = torch.arange(flat.numel(), device=flat.device) % max(table.shape[0], 1)
    rows = table.index_select(0, torch.where(flat >= 0, flat, spread))
    return rows.reshape(*ids.shape, *table.shape[1:])
