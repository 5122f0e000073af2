"""Heterogeneous batches of point clouds (port of pytorch3d_tpu/structures/pointclouds.py).

The storage follows the JAX package exactly, as `Meshes` does:

- **Padded-first**: points `(N, P, 3)` with per-cloud counts, and optional
  normals `(N, P, 3)` and features `(N, P, C)`; padding rows hold zeros.
- **Packed views are reshapes**: cloud n's packed rows are `[n*P, (n+1)*P)`,
  so a packed point id is `n*P + local`; every consumer masks with
  `points_packed_mask()`.

`Pointclouds` is a plain class holding tensors.  `create` builds one on a
device (CUDA unless the caller names another) and `replace` returns a copy
with some fields swapped.  `offset_` and `scale_` update the points tensor
in place and return the same object, where the JAX package (immutable
arrays) returns a new one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from ..common import DEFAULT_DEVICE
from .utils import list_to_padded

Device = Union[str, torch.device]


def _padded(items, device: torch.device) -> Optional[torch.Tensor]:
    """A list of (P_i, C) arrays or an (N, P, C) array as a float tensor."""
    if items is None:
        return None
    if isinstance(items, (list, tuple)):
        return list_to_padded([torch.as_tensor(x, dtype=torch.float32, device=device) for x in items])
    return torch.as_tensor(items, dtype=torch.float32, device=device)


def _map(t: Optional[torch.Tensor], fn):
    return None if t is None else fn(t)


@dataclasses.dataclass(frozen=True)
class Pointclouds:
    """A batch of N point clouds with up to P points each."""

    _points_padded: torch.Tensor  # (N, P, 3) float
    _num_points_per_cloud: torch.Tensor  # (N,) int64
    _normals_padded: Optional[torch.Tensor] = None  # (N, P, 3)
    _features_padded: Optional[torch.Tensor] = None  # (N, P, C)

    @classmethod
    def create(
        cls,
        points: Union[Sequence[torch.Tensor], torch.Tensor],
        normals=None,
        features=None,
        num_points_per_cloud: Optional[torch.Tensor] = None,
        device: Device = DEFAULT_DEVICE,
    ) -> "Pointclouds":
        """Build from lists of per-cloud (P_i, 3) arrays or a padded
        (N, P, 3) array (normals and features in the same form as the
        points).  Items may be tensors or numpy arrays; all are moved to
        `device`.  Padded input without counts uses all P points of every
        cloud."""
        device = torch.device(device)
        if isinstance(points, (list, tuple)):
            counts = torch.tensor([len(p) for p in points], dtype=torch.int64, device=device)
            points_padded = _padded(points, device)
        else:
            points_padded = torch.as_tensor(points, dtype=torch.float32, device=device)
            if points_padded.ndim != 3 or points_padded.shape[-1] != 3:
                raise ValueError("points must be (N, P, 3)")
            if num_points_per_cloud is not None:
                counts = torch.as_tensor(num_points_per_cloud, dtype=torch.int64, device=device)
            else:
                counts = torch.full(
                    (points_padded.shape[0],), points_padded.shape[1], dtype=torch.int64, device=device
                )
        return cls(
            _points_padded=points_padded,
            _num_points_per_cloud=counts,
            _normals_padded=_padded(normals, device),
            _features_padded=_padded(features, device),
        )

    def replace(self, **changes) -> "Pointclouds":
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)

    def _apply(self, fn) -> "Pointclouds":
        """`fn` applied to every tensor field."""
        return Pointclouds(
            _points_padded=fn(self._points_padded),
            _num_points_per_cloud=fn(self._num_points_per_cloud),
            _normals_padded=_map(self._normals_padded, fn),
            _features_padded=_map(self._features_padded, fn),
        )

    # ------------------------------------------------------------------ #
    # Basic properties
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return self._points_padded.shape[0]

    @property
    def device(self) -> torch.device:
        return self._points_padded.device

    @property
    def max_points(self) -> int:
        return self._points_padded.shape[1]

    def isempty(self) -> bool:
        return len(self) == 0 or self.max_points == 0

    def num_points_per_cloud(self) -> torch.Tensor:
        return self._num_points_per_cloud

    # ------------------------------------------------------------------ #
    # Padded views
    # ------------------------------------------------------------------ #
    def points_padded(self) -> torch.Tensor:
        return self._points_padded

    def normals_padded(self) -> Optional[torch.Tensor]:
        return self._normals_padded

    def features_padded(self) -> Optional[torch.Tensor]:
        return self._features_padded

    def points_padded_mask(self) -> torch.Tensor:
        """(N, P) bool — which padded slots are real points."""
        ar = torch.arange(self.max_points, device=self.device)
        return ar[None, :] < self._num_points_per_cloud[:, None]

    # ------------------------------------------------------------------ #
    # Packed views (reshapes + masks)
    # ------------------------------------------------------------------ #
    def points_packed(self) -> torch.Tensor:
        """(N*P, 3) — cloud n occupies rows [n*P, (n+1)*P)."""
        N, P, _ = self._points_padded.shape
        return self._points_padded.reshape(N * P, 3)

    def points_packed_mask(self) -> torch.Tensor:
        return self.points_padded_mask().reshape(-1)

    def normals_packed(self) -> Optional[torch.Tensor]:
        return _map(self._normals_padded, lambda t: t.reshape(-1, t.shape[-1]))

    def features_packed(self) -> Optional[torch.Tensor]:
        return _map(self._features_padded, lambda t: t.reshape(-1, t.shape[-1]))

    def packed_to_cloud_idx(self) -> torch.Tensor:
        return torch.arange(len(self), device=self.device).repeat_interleave(self.max_points)

    def cloud_to_packed_first_idx(self) -> torch.Tensor:
        return torch.arange(len(self), device=self.device) * self.max_points

    def padded_to_packed_idx(self) -> torch.Tensor:
        """Packed position -> padded flat index: the identity over all
        N*P slots in this padded-first layout; compose with
        `points_packed_mask()` for validity."""
        return torch.arange(len(self) * self.max_points, device=self.device)

    # ------------------------------------------------------------------ #
    # Updates
    # ------------------------------------------------------------------ #
    def update_padded(
        self,
        new_points_padded: torch.Tensor,
        new_normals_padded: Optional[torch.Tensor] = None,
        new_features_padded: Optional[torch.Tensor] = None,
    ) -> "Pointclouds":
        """Replace the points (and, where given, normals and features)."""
        if new_points_padded.shape != self._points_padded.shape:
            raise ValueError("new values must have the same shape as the current.")
        return self.replace(
            _points_padded=new_points_padded,
            _normals_padded=new_normals_padded if new_normals_padded is not None else self._normals_padded,
            _features_padded=new_features_padded if new_features_padded is not None else self._features_padded,
        )

    def _packed_offsets(self, offsets_packed: torch.Tensor) -> torch.Tensor:
        offsets_packed = torch.as_tensor(offsets_packed, dtype=self._points_padded.dtype, device=self.device)
        if offsets_packed.shape == (3,):
            return offsets_packed.expand(self._points_padded.shape)
        if offsets_packed.shape != (len(self) * self.max_points, 3):
            raise ValueError("Offsets must have dimension (all_p, 3).")
        return offsets_packed.reshape(self._points_padded.shape)

    def _cloud_scales(self, scale) -> torch.Tensor:
        scale = torch.as_tensor(scale, dtype=self._points_padded.dtype, device=self.device)
        if scale.ndim == 0:
            scale = scale.expand(len(self))
        return scale[:, None, None]

    def offset(self, offsets_packed: torch.Tensor) -> "Pointclouds":
        """Points moved by a (3,) offset or one (N*P, 3) row per packed slot."""
        return self.update_padded(self._points_padded + self._packed_offsets(offsets_packed))

    def offset_(self, offsets_packed: torch.Tensor) -> "Pointclouds":
        """`offset` in place on the points tensor; returns self."""
        self._points_padded.add_(self._packed_offsets(offsets_packed))
        return self

    def scale(self, scale) -> "Pointclouds":
        """Points scaled by a scalar or one factor per cloud (N,)."""
        return self.replace(_points_padded=self._points_padded * self._cloud_scales(scale))

    def scale_(self, scale) -> "Pointclouds":
        """`scale` in place on the points tensor; returns self."""
        self._points_padded.mul_(self._cloud_scales(scale))
        return self

    def detach(self) -> "Pointclouds":
        return self._apply(torch.Tensor.detach)

    def clone(self) -> "Pointclouds":
        return self._apply(torch.Tensor.clone)

    def to(self, device: Device) -> "Pointclouds":
        return self._apply(lambda t: t.to(device))

    def cpu(self) -> "Pointclouds":
        return self.to("cpu")

    def cuda(self) -> "Pointclouds":
        return self.to("cuda")

    def subsample(
        self, max_points: int, generator: Optional[torch.Generator] = None, scores: Optional[torch.Tensor] = None
    ) -> "Pointclouds":
        """At most `max_points` points of each cloud, drawn without
        replacement: the points of the `max_points` smallest uniform scores
        (N, P) from `generator` (or the given `scores`, as a test hands in
        the JAX package's), real points before padding, in score order."""
        if max_points >= self.max_points:
            return self
        if scores is None:
            scores = torch.rand(self._points_padded.shape[:2], generator=generator, device=self.device)
        scores = torch.where(self.points_padded_mask(), scores.to(self.device), 2.0)
        idx = torch.argsort(scores, dim=1, stable=True)[:, :max_points]

        def take(t: torch.Tensor) -> torch.Tensor:
            return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))

        return Pointclouds(
            _points_padded=take(self._points_padded),
            _num_points_per_cloud=torch.clamp(self._num_points_per_cloud, max=max_points),
            _normals_padded=_map(self._normals_padded, take),
            _features_padded=_map(self._features_padded, take),
        )

    def estimate_normals(
        self, neighborhood_size: int = 50, disambiguate_directions: bool = True, assign_to_self: bool = False
    ):
        """Per-point normals by `estimate_pointcloud_normals`; with
        `assign_to_self` a copy holding them as its normals."""
        from ..ops.points_normals import estimate_pointcloud_normals

        normals = estimate_pointcloud_normals(
            self, neighborhood_size=neighborhood_size, disambiguate_directions=disambiguate_directions
        )
        if assign_to_self:
            return self.replace(_normals_padded=normals)
        return normals

    # ------------------------------------------------------------------ #
    # List accessors (host-side)
    # ------------------------------------------------------------------ #
    def _trimmed(self, padded: Optional[torch.Tensor]) -> Optional[List[torch.Tensor]]:
        if padded is None:
            return None
        return [padded[i, :n] for i, n in enumerate(self._num_points_per_cloud.tolist())]

    def points_list(self) -> List[torch.Tensor]:
        return self._trimmed(self._points_padded)

    def normals_list(self) -> Optional[List[torch.Tensor]]:
        return self._trimmed(self._normals_padded)

    def features_list(self) -> Optional[List[torch.Tensor]]:
        return self._trimmed(self._features_padded)

    def get_cloud(self, index: int):
        """(points, normals, features) of cloud `index`, trimmed to its count."""
        n = int(self._num_points_per_cloud[index])
        return tuple(
            None if t is None else t[index, :n]
            for t in (self._points_padded, self._normals_padded, self._features_padded)
        )

    # ------------------------------------------------------------------ #
    # Batch manipulation
    # ------------------------------------------------------------------ #
    def __getitem__(self, index) -> "Pointclouds":
        """The clouds at `index` (an int, a list, a slice or an index
        tensor), as one batch of the same padded width."""
        if isinstance(index, int):
            index = [index]
        if isinstance(index, (list, tuple)):
            index = torch.as_tensor(index, dtype=torch.int64, device=self.device)
        return self._apply(lambda t: t[index])

    def split(self, split_sizes) -> List["Pointclouds"]:
        """The batch cut into consecutive sub-batches of the given sizes."""
        if sum(int(s) for s in split_sizes) != len(self):
            raise ValueError("Split sizes must sum to the batch size.")
        out, start = [], 0
        for s in split_sizes:
            out.append(self[slice(start, start + int(s))])
            start += int(s)
        return out

    def extend(self, N: int) -> "Pointclouds":
        """Each cloud repeated N times, consecutively."""
        if not isinstance(N, int) or N <= 0:
            raise ValueError("N must be > 0.")
        return self[torch.arange(len(self), device=self.device).repeat_interleave(N)]

    def get_bounding_boxes(self) -> torch.Tensor:
        """(N, 3, 2): per cloud and axis the min and max over its points
        (+inf / -inf for an empty cloud)."""
        mask = self.points_padded_mask()[..., None]
        pts = self._points_padded
        mins = torch.where(mask, pts, torch.inf).amin(dim=1)
        maxs = torch.where(mask, pts, -torch.inf).amax(dim=1)
        return torch.stack([mins, maxs], dim=-1)

    def inside_box(self, box: torch.Tensor) -> torch.Tensor:
        """(N*P,) bool over packed slots: inside the axis-aligned box of
        cloud n, given as (2, 3) for all clouds or (N, 2, 3) min/max corners."""
        box = torch.as_tensor(box, dtype=self._points_padded.dtype, device=self.device)
        if box.ndim == 2:
            box = box[None]
        if box.shape[-2:] != (2, 3):
            raise ValueError("Input box must be of shape (2, 3) or (N, 2, 3).")
        pts = self._points_padded
        inside = ((pts >= box[:, 0][:, None]) & (pts <= box[:, 1][:, None])).all(dim=-1)
        return inside.reshape(-1)


def join_pointclouds_as_batch(pointclouds: Sequence[Pointclouds]) -> Pointclouds:
    """Concatenate several batches into one, padded to the widest."""
    P = max(p.max_points for p in pointclouds)

    def cat(field: str):
        items = [getattr(p, field) for p in pointclouds]
        if any(t is None for t in items):
            return None
        return torch.cat([torch.nn.functional.pad(t, (0, 0, 0, P - t.shape[1])) for t in items])

    return Pointclouds(
        _points_padded=cat("_points_padded"),
        _num_points_per_cloud=torch.cat([p.num_points_per_cloud() for p in pointclouds]),
        _normals_padded=cat("_normals_padded"),
        _features_padded=cat("_features_padded"),
    )


def join_pointclouds_as_scene(pointclouds: Pointclouds) -> Pointclouds:
    """The whole batch as one cloud of capacity N*P, real points first in
    packed order."""
    mask = pointclouds.points_packed_mask()
    order = torch.sort((~mask).to(torch.int8), stable=True).indices

    def take(t: Optional[torch.Tensor]):
        return None if t is None else t[order][None]

    return Pointclouds(
        _points_padded=take(pointclouds.points_packed()),
        _num_points_per_cloud=mask.sum()[None],
        _normals_padded=take(pointclouds.normals_packed()),
        _features_padded=take(pointclouds.features_packed()),
    )
