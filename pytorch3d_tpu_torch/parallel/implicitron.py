"""Ray-parallel training of Implicitron's GenericModel (port of
pytorch3d_tpu/parallel/implicitron.py).

Every rank of the mesh axis holds the same weights (rank 0's, broadcast when
the step is made) and the same batch, and draws its own rays: its generator
is seeded from the step's seed and its index on the axis, as the JAX step
folds the axis index into its key.  The objective and every gradient are
averaged over the axis (an all-reduce, then a division by its size), so
every rank takes the same optimizer step: the rays of a step grow with the
ranks at a constant memory per rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from .mesh import DeviceMesh
from .train import _flat_collective


def rank_seed(seed: int, index: int) -> int:
    """The seed of the generator of the rank at `index` on the axis for a
    step seeded `seed` (distinct for every (seed, index) with index < 2^16)."""
    return (int(seed) << 16) + int(index)


def make_sharded_generic_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: DeviceMesh,
    axis: str = "rays",
    static_model_kwargs: Optional[Dict[str, Any]] = None,
) -> Callable:
    """step(batch, seed) -> the objective averaged over the axis (detached).

    `batch` holds the model's keyword inputs (image_rgb, camera,
    fg_probability, and extras such as sequence_name), the same on every
    rank; the rank draws its rays from a generator on the parameters'
    device seeded `rank_seed(seed, its index on axis)`."""
    static_model_kwargs = dict(static_model_kwargs or {})
    group = mesh.group(axis)
    n = mesh.size(axis)
    index = mesh.coordinate(axis)
    device = next(model.parameters()).device
    if group is not None:
        with torch.no_grad():
            _flat_collective(list(model.parameters()) + list(model.buffers()),
                             lambda flat: dist.broadcast(flat, src=dist.get_process_group_ranks(group)[0], group=group))

    def step(batch: Dict[str, Any], seed: int) -> torch.Tensor:
        generator = torch.Generator(device=device).manual_seed(rank_seed(seed, index))
        optimizer.zero_grad(set_to_none=True)
        objective = model(**batch, **static_model_kwargs, generator=generator)["objective"]
        objective.backward()
        loss = objective.detach().reshape(1)
        if group is not None:
            shared = [p.grad for p in model.parameters() if p.grad is not None] + [loss]
            _flat_collective(shared, lambda flat: dist.all_reduce(flat, group=group))
            for t in shared:
                t.div_(n)
        optimizer.step()
        return loss[0]

    return step
