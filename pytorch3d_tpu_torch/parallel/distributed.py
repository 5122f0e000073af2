"""Process-group initialization and per-process data sharding (port of
pytorch3d_tpu/parallel/distributed.py).

JAX wires hosts together with `jax.distributed.initialize`; the port uses
`torch.distributed` as torchrun sets it up (MASTER_ADDR / MASTER_PORT /
RANK / WORLD_SIZE), NCCL on the card unless the caller names another
backend.  Data loading is per process: each rank reads only its slice of
the global batch (`local_shard_indices`).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch.distributed as dist


def _address(coordinator_address: str) -> str:
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Initialize the default process group when running multi-process.

    Resolution order: explicit arguments ("host:port" or an init URL) >
    torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE.  No-op
    (returns False) in a single-process run without any of these; True
    once a group exists.  The backend is NCCL unless `backend` names
    another (gloo for CPU tensors).
    """
    if dist.is_initialized():
        return True
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is not None:
        init_method = _address(coordinator_address)
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:
        return False
    dist.init_process_group(backend or "nccl", init_method=init_method, world_size=num_processes, rank=process_id)
    return True


def local_shard_indices(
    n_items: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[int]:
    """Indices of the global batch this process should load (contiguous
    block partition; the tail goes to the last process)."""
    pi = (dist.get_rank() if dist.is_initialized() else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if dist.is_initialized() else 1) if process_count is None else process_count
    per = n_items // pc
    lo = pi * per
    hi = n_items if pi == pc - 1 else lo + per
    return list(range(lo, hi))


class PerProcessLoader:
    """Wrap an indexable dataset so each process iterates only its shard of
    every global batch (the DistributedSampler analog).  `shuffle_key`
    seeds a numpy RandomState shuffle of the order, as in the JAX package."""

    def __init__(self, dataset, global_batch_size: int, shuffle_key=None):
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self._order = list(range(len(dataset)))
        if shuffle_key is not None:
            import numpy as np

            rng = np.random.RandomState(int(shuffle_key))
            rng.shuffle(self._order)

    def __iter__(self):
        n = len(self._order)
        for start in range(0, n - self.global_batch_size + 1, self.global_batch_size):
            batch_ids = self._order[start : start + self.global_batch_size]
            local = local_shard_indices(len(batch_ids))
            yield [self.dataset[batch_ids[i]] for i in local]

    def __len__(self):
        return len(self._order) // self.global_batch_size
