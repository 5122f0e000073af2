"""Meshes of ranks and which dimension each mesh axis splits (port of
pytorch3d_tpu/parallel/mesh.py).

Axes, as in the JAX package:
- "dp"   — batch (scenes / images) data parallelism;
- "rays" — ray / pixel-row parallelism within an image.

A `DeviceMesh` lays the ranks of the process group out on a (dp, rays)
grid (`torch.distributed.device_mesh.init_device_mesh`), with one process
group per axis.  Where JAX hands a `NamedSharding` to XLA, the port's code
takes a rank's block of a tensor itself (`Sharding.local`), so no DTensor
is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


class DeviceMesh:
    """Ranks on a grid with named axes.  Built by `get_device_mesh`; a
    mesh of one rank in a process without a process group has no groups."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...], device_mesh=None) -> None:
        self.axis_names = tuple(axis_names)
        self._sizes = tuple(int(s) for s in shape)
        self.device_mesh = device_mesh  # torch's DeviceMesh, None for one process

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as a JAX mesh's `shape`."""
        return dict(zip(self.axis_names, self._sizes))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def group(self, axis: Optional[str] = None):
        """The process group of the ranks that share this rank's other
        coordinates (every rank of the mesh for None); None where the
        mesh is one process without a group."""
        if self.device_mesh is None:
            return None
        return dist.group.WORLD if axis is None else self.device_mesh.get_group(axis)


def get_device_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("dp", "rays"),
) -> DeviceMesh:
    """A 2D ("dp", "rays") mesh of the process group's ranks, one device a
    rank (where JAX lays out a list of devices).

    Default: every rank on the "rays" axis.  Without a process group the
    world is this one process, and only a mesh of one rank can be made.
    Raises ValueError where the shape does not hold the world's ranks.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (1, world)
    shape = tuple(int(s) for s in shape)
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != device count {world}")
    if not dist.is_initialized():
        return DeviceMesh(shape, axis_names)
    from torch.distributed.device_mesh import init_device_mesh

    # The device type names the groups' backend: NCCL groups hold the
    # card's tensors; a gloo group takes tensors on the CPU or the card.
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(shape, axis_names, init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which mesh axis splits each leading dimension of a tensor (None: not
    split), as a JAX `PartitionSpec` names them."""

    mesh: DeviceMesh
    spec: Tuple[Optional[str], ...]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of `x`: along each split dimension, the
        coordinate-th of the axis's equal parts.  Raises ValueError where a
        dimension does not divide."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.size(axis)
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide over '{axis}' ({n})")
            x = x.chunk(n, dim)[self.mesh.coordinate(axis)] if n > 1 else x
        return x


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, ())


def shard_rays(mesh: DeviceMesh, batch_axis: bool = True) -> Sharding:
    """Shard (B, R, ...) ray tensors: B over dp, R over rays."""
    return Sharding(mesh, ("dp", "rays") if batch_axis else ("rays",))


def shard_pixels(mesh: DeviceMesh) -> Sharding:
    """Shard (N, H, W, ...) images: N over dp, H (pixel rows) over rays."""
    return Sharding(mesh, ("dp", "rays"))


def shard_batch(mesh: DeviceMesh) -> Sharding:
    """Shard the leading batch dim over dp only."""
    return Sharding(mesh, ("dp",))
