"""The NeRF training step, on one device or ray-sharded over a mesh of ranks
(port of pytorch3d_tpu/parallel/train.py).

With a mesh, the parameters are replicated (rank 0's are broadcast when the
step is made), each rank renders its (dp, rays) share of the step's rays
(`RadianceFieldRenderer(..., ray_sharding=shard_rays(mesh))`), and the
gradients are all-reduced so that every rank takes the same optimizer step
on the global mean loss: the DDP counterpart of the JAX step, whose jit
with NamedShardings has XLA insert the same all-reduce.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

from .mesh import DeviceMesh, shard_rays


def _flat_collective(tensors: List[torch.Tensor], collective: Callable[[torch.Tensor], object]) -> None:
    """Run `collective` in place on the tensors, one flat buffer per dtype
    (one call where a call per tensor pays a collective's latency each)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        collective(flat)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


def psum_grads(parameters: Union[torch.nn.Module, Iterable[torch.Tensor]], group=None) -> None:
    """All-reduce (sum) every parameter's `.grad` over `group` (the default
    group for None), in place: DDP's gradient sync."""
    if isinstance(parameters, torch.nn.Module):
        parameters = parameters.parameters()
    grads = [p.grad for p in parameters if p.grad is not None]
    _flat_collective(grads, lambda flat: dist.all_reduce(flat, group=group))


def make_nerf_train_step(model, optimizer, mesh: Optional[DeviceMesh] = None, compute_dtype=None) -> Callable:
    """step(cameras, image, generator=None, draws=None) -> metrics.

    The step renders a Monte-Carlo ray batch with `model`
    (a RadianceFieldRenderer), takes loss = mse_coarse + mse_fine against
    `image`, runs the backward and one `optimizer` step.  The metrics (mse and
    psnr of both passes, and the loss) come back detached.  `draws` hands in
    the call's random numbers (`RadianceFieldRenderer.make_draws`).

    With `mesh` (axes "dp" and "rays"), every rank calls the step with the
    same cameras, image and global draws (hand in `draws`, or generators
    seeded alike): each renders its share of the rays, the gradients are
    summed over the mesh's ranks and scaled to the global mean, and the
    metrics are the global ones (mse averaged over the ranks' equal
    shares, psnr from that mse), the same on every rank.
    """
    if compute_dtype is not None:
        raise NotImplementedError("mixed precision (compute_dtype) waits for a later slice of the port")
    sharding = None if mesh is None else shard_rays(mesh)
    group = None if mesh is None else mesh.group()
    shards = 1 if mesh is None else mesh.size("dp") * mesh.size("rays")
    if group is not None:
        with torch.no_grad():
            _flat_collective(list(model.parameters()) + list(model.buffers()),
                             lambda flat: dist.broadcast(flat, src=0, group=group))

    def step(cameras, image: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        if draws is None:
            draws = model.make_draws(len(cameras), True, generator)
        _, metrics = model(cameras, image=image, training=True, draws=draws, ray_sharding=sharding)
        loss = metrics["mse_coarse"] + metrics["mse_fine"]
        (loss / shards).backward()
        if group is not None:
            psum_grads(model, group)
        optimizer.step()
        if group is None:
            return {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}
        mse = torch.stack([metrics["mse_coarse"], metrics["mse_fine"]]).detach()
        dist.all_reduce(mse, group=group)
        mse = mse / shards
        psnr = -10.0 * torch.log10(mse.clamp(min=1e-12))
        return {"mse_coarse": mse[0], "mse_fine": mse[1], "psnr_coarse": psnr[0], "psnr_fine": psnr[1],
                "loss": mse[0] + mse[1]}

    return step
