"""Voxel grids of Implicitron: dense and tensor-factorised (TensoRF's CP and
VM), with their interpolators (port of
pytorch3d_tpu/implicitron/models/implicit_function/voxel_grid.py).

The grid classes are stateless configs (registered `VoxelGridBase`s) whose
methods are functions of a values dict `{name: (n_grids, ...) tensor}`;
`VoxelGridModule` holds the values as parameters (or buffers) together
with its placement (`extents`, `translation`) as buffers.

Sampling gathers the corners of each point (`ops/grid_sample.py`'s
channel-last row gathers, whose backward is an `index_add_`) and blends
them in the JAX package's order.  The JAX package contracts small axes
with one-hot weight matrices instead, which suits the TPU's matrix unit;
on the card a (points x resolution) one-hot matrix would be far larger
than the gathers, so the port does not copy it: both agree within float32
rounding, at the edges and outside the grid too.

Resolution changes and crops are epoch-boundary transforms of the values
(`apply_resolution_change`, `crop_values`): they return new tensors, whose
shapes may differ, and the caller rebuilds its parameters and optimizer
(`implicitron.models.utils.load_state_dict_resized`).  `interpolate_tensor`
resizes by JAX's per-axis resize matrices (`torch.nn.functional.
interpolate`'s modes).  The VM and CP basis products and the resize
products run in full float32 on the card, never TF32, as JAX's HIGHEST
precision asks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....common import DEFAULT_DEVICE
from ....ops.grid_sample import _corner, _unnormalize
from ....renderer.implicit.raysampling import _linspace
from ...tools.config import ReplaceableBase, expand_args_fields, registry

Device = Union[str, torch.device]


# --------------------------------------------------------------------------- #
# Full float32 products
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def _full_fp32():
    """cuBLAS in full float32 (no TF32) inside the block, whatever the
    process set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _Fp32Matmul(torch.autograd.Function):
    """a @ b with the forward and both backward products in full float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _full_fp32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _full_fp32():
            return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def _basis_product(feats: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(G, P, R) x (G, R, F) -> (G, P, F)."""
    return _Fp32Matmul.apply(feats, basis)


# --------------------------------------------------------------------------- #
# Interpolation (points with a leading n_grids dim; results (G, P, C))
# --------------------------------------------------------------------------- #


def _sample(points: torch.Tensor, source: torch.Tensor, align_corners: bool = False,
            padding_mode: str = "zeros", mode: str = "bilinear") -> torch.Tensor:
    """points (G, P, n) in [-1, 1], coordinate i indexing the source's
    spatial axis i; source (G, C, *sizes) -> (G, P, C).  Linear modes blend
    along x first, then y (the JAX package's contraction order); 3D sums
    the eight weighted corners as its grid_sample does."""
    G, C = source.shape[:2]
    sizes = tuple(source.shape[2:])
    n = len(sizes)
    table = source.movedim(1, -1).reshape(-1, C)
    base = torch.arange(G, device=points.device).reshape(G, 1).expand(points.shape[:2])
    coords = [_unnormalize(points[..., i], sizes[i], align_corners) for i in range(n)]
    if mode == "nearest":
        return _corner(table, tuple(torch.round(c).long() for c in coords), sizes, base, padding_mode, None)
    lo = [torch.floor(c) for c in coords]
    w = [c - f for c, f in zip(coords, lo)]
    lo = [f.long() for f in lo]

    def corner(offsets):
        return _corner(table, tuple(i + o for i, o in zip(lo, offsets)), sizes, base, padding_mode, None)

    if n == 3:
        out = 0.0
        for dz, fz in ((0, 1 - w[2]), (1, w[2])):
            for dy, fy in ((0, 1 - w[1]), (1, w[1])):
                for dx, fx in ((0, 1 - w[0]), (1, w[0])):
                    out = out + corner((dx, dy, dz)) * (fx * fy * fz)[..., None]
        return out
    wx = w[0][..., None]
    if n == 1:
        return corner((0,)) * (1 - wx) + corner((1,)) * wx
    wy = w[1][..., None]
    y0 = corner((0, 0)) * (1 - wx) + corner((1, 0)) * wx
    y1 = corner((0, 1)) * (1 - wx) + corner((1, 1)) * wx
    return y0 * (1 - wy) + y1 * wy


def _interp_kwargs(kwargs) -> Dict[str, Any]:
    mode = kwargs.get("mode", "bilinear")
    return dict(align_corners=kwargs.get("align_corners", False), padding_mode=kwargs.get("padding_mode", "zeros"),
                mode="bilinear" if mode == "trilinear" else mode)


def interpolate_line(points: torch.Tensor, source: torch.Tensor, **kwargs) -> torch.Tensor:
    """Linear interpolation along W: points (G, P, 1) in [-1, 1], source
    (G, C, W) -> (G, P, C).  kwargs: align_corners (False), padding_mode
    ("zeros" or "border"), mode ("bilinear" or "nearest")."""
    return _sample(points, source, **_interp_kwargs(kwargs))


def interpolate_plane(points: torch.Tensor, source: torch.Tensor, **kwargs) -> torch.Tensor:
    """Bilinear interpolation: points (G, P, 2) in [-1, 1], x indexing the
    source's W and y its H; source (G, C, W, H) -> (G, P, C)."""
    return _sample(points, source, **_interp_kwargs(kwargs))


def interpolate_volume(points: torch.Tensor, source: torch.Tensor, **kwargs) -> torch.Tensor:
    """Trilinear interpolation: points (G, P, 3) in [-1, 1], (x, y, z)
    indexing the source's (W, H, D); source (G, C, W, H, D) -> (G, P, C)."""
    return _sample(points, source, **_interp_kwargs(kwargs))


# --------------------------------------------------------------------------- #
# torch.nn.functional.interpolate by per-axis resize matrices
# --------------------------------------------------------------------------- #


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (torch and PIL use a = -0.75)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * (ax**3 - 5.0 * ax**2 + 8.0 * ax - 4.0), 0.0),
    )


def _resize_matrix(n_in: int, n_out: int, mode: str, align_corners: bool, antialias: bool = False) -> np.ndarray:
    """(n_out, n_in) row-stochastic weights of one axis's resize, the JAX
    package's matrix for `F.interpolate`'s mode (float64)."""
    W = np.zeros((n_out, n_in), dtype=np.float64)
    i = np.arange(n_out, dtype=np.float64)
    scale = n_in / n_out

    def acc(rows, cols, w):
        np.add.at(W, (rows, np.clip(cols, 0, n_in - 1)), w)

    if mode == "nearest":
        acc(np.arange(n_out), np.floor(i * scale).astype(np.int64), np.ones(n_out))
    elif mode == "nearest-exact":
        acc(np.arange(n_out), np.floor((i + 0.5) * scale).astype(np.int64), np.ones(n_out))
    elif mode == "area":  # adaptive average pooling
        start = np.floor(i * n_in / n_out).astype(np.int64)
        end = np.ceil((i + 1) * n_in / n_out).astype(np.int64)
        for r in range(n_out):
            W[r, start[r]: end[r]] = 1.0 / (end[r] - start[r])
    elif mode in ("linear", "bicubic"):
        if align_corners:
            src = i * (n_in - 1) / max(n_out - 1, 1) if n_out > 1 else i * 0.0
        else:
            src = (i + 0.5) * scale - 0.5
        support = 1.0 if mode == "linear" else 2.0
        kern: Callable[[np.ndarray], np.ndarray] = (
            (lambda x: np.maximum(0.0, 1.0 - np.abs(x))) if mode == "linear" else _cubic_kernel)
        # antialias stretches the kernel by the downscale factor
        kscale = max(scale, 1.0) if (antialias and scale > 1.0) else 1.0
        half = support * kscale
        lo = np.floor(src - half).astype(np.int64)
        n_taps = int(np.ceil(2 * half)) + 2
        rows = np.repeat(np.arange(n_out), n_taps)
        cols = (lo[:, None] + np.arange(n_taps)[None, :]).reshape(-1)
        w = kern((cols.reshape(n_out, n_taps) - src[:, None]) / kscale)
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
        acc(rows, cols, w.reshape(-1))
    else:
        raise ValueError(f"Unsupported interpolate mode: {mode}")
    return W


def interpolate_tensor(x: torch.Tensor, size: Tuple[int, ...], mode: str = "linear", align_corners: bool = True,
                       antialias: bool = False) -> torch.Tensor:
    """`torch.nn.functional.interpolate` of the trailing len(size) axes of x,
    as the JAX package computes it: each axis resized by its (n_out, n_in)
    matrix (`_resize_matrix`), in full float32.  'linear' is linear along
    every axis (bi- / trilinear)."""
    n_sp = len(size)
    out = x
    for ax_off, n_out in enumerate(size):
        axis = x.ndim - n_sp + ax_off
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        M = torch.as_tensor(_resize_matrix(n_in, n_out, mode, align_corners, antialias), dtype=out.dtype,
                            device=out.device)
        with _full_fp32():
            out = torch.movedim(torch.tensordot(out, M, dims=([axis], [1])), -1, axis)
    return out


# --------------------------------------------------------------------------- #
# Grid classes
# --------------------------------------------------------------------------- #

VoxelGridValues = Dict[str, torch.Tensor]  # each value: (n_grids, *shape)


@dataclasses.dataclass
class VoxelGridValuesBase:
    """Named view of a values dict; accepted wherever `grid_values` is."""

    def as_dict(self) -> VoxelGridValues:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self) if getattr(self, f.name) is not None}


@dataclasses.dataclass
class FullResolutionVoxelGridValues(VoxelGridValuesBase):
    voxel_grid: torch.Tensor


@dataclasses.dataclass
class CPFactorizedVoxelGridValues(VoxelGridValuesBase):
    vector_components_x: torch.Tensor
    vector_components_y: torch.Tensor
    vector_components_z: torch.Tensor
    basis_matrix: Optional[torch.Tensor] = None


@dataclasses.dataclass
class VMFactorizedVoxelGridValues(VoxelGridValuesBase):
    vector_components_x: torch.Tensor
    vector_components_y: torch.Tensor
    vector_components_z: torch.Tensor
    matrix_components_xy: torch.Tensor
    matrix_components_yz: torch.Tensor
    matrix_components_xz: torch.Tensor
    basis_matrix: Optional[torch.Tensor] = None


def _values_as_dict(grid_values) -> VoxelGridValues:
    return grid_values.as_dict() if isinstance(grid_values, VoxelGridValuesBase) else grid_values


@dataclasses.dataclass(frozen=True)
class _GridLocator:
    """x_world = x_local * extents / 2 + translation: `translation` is the
    grid's world-space centre."""

    extents: Tuple[float, float, float]
    translation: Tuple[float, float, float]

    def world_to_local_coords(self, points: torch.Tensor) -> torch.Tensor:
        ext = torch.tensor(self.extents, dtype=points.dtype, device=points.device)
        tr = torch.tensor(self.translation, dtype=points.dtype, device=points.device)
        return (points - tr) * (2.0 / ext)

    def local_to_world_coords(self, points: torch.Tensor) -> torch.Tensor:
        ext = torch.tensor(self.extents, dtype=points.dtype, device=points.device)
        tr = torch.tensor(self.translation, dtype=points.dtype, device=points.device)
        return points * (ext / 2.0) + tr


class VoxelGridBase(ReplaceableBase):
    """Stateless voxel-grid config.  Grids are indexed (features, x, y, z);
    queries outside follow `padding`; `resolution_changes` maps training
    epochs to [width, height, depth]."""

    align_corners: bool = True
    padding: str = "zeros"
    mode: str = "bilinear"
    n_features: int = 1
    resolution_changes: Dict[int, Any] = dataclasses.field(default_factory=lambda: {0: [128, 128, 128]})

    def __post_init__(self):
        if 0 not in self.resolution_changes:
            raise ValueError("There has to be key `0` in `resolution_changes`.")

    def _kw(self) -> Dict[str, Any]:
        return dict(align_corners=self.align_corners, padding_mode=self.padding, mode=self.mode)

    def evaluate_world(self, points: torch.Tensor, grid_values, locator: _GridLocator) -> torch.Tensor:
        """Values at world points (n_grids, ..., 3) -> (n_grids, ..., n_features)."""
        return self.evaluate_local(locator.world_to_local_coords(points), _values_as_dict(grid_values))

    def evaluate_local(self, points: torch.Tensor, grid_values) -> torch.Tensor:
        """Values at local ([-1, 1]^3) points -> (n_grids, ..., n_features)."""
        raise NotImplementedError()

    def get_shapes(self, epoch: int) -> Dict[str, Tuple[int, ...]]:
        """Shapes (without the n_grids dim) of the value tensors at `epoch`."""
        raise NotImplementedError()

    def get_resolution(self, epoch: int) -> List[int]:
        """[width, height, depth] at `epoch`: that of the last change at or before it."""
        return list(self.resolution_changes[max([0] + [e for e in self.resolution_changes if e <= epoch])])

    @staticmethod
    def get_output_dim(args: Dict[str, Any]) -> int:
        return args["n_features"]

    def get_resolution_change_epochs(self) -> Tuple[int, ...]:
        return tuple(self.resolution_changes.keys())

    def get_align_corners(self) -> bool:
        return self.align_corners

    def change_resolution(self, grid_values: VoxelGridValues, *, epoch: Optional[int] = None,
                          grid_values_with_wanted_resolution: Optional[VoxelGridValues] = None, mode: str = "linear",
                          align_corners: bool = True, antialias: bool = False) -> Tuple[VoxelGridValues, bool]:
        """The values resampled to `epoch`'s resolution, or to that of
        another values dict: (new values, changed?)."""
        if (epoch is None) == (grid_values_with_wanted_resolution is None):
            raise ValueError("Exactly one of `epoch` or `grid_values_with_wanted_resolution` has to be defined.")
        if mode not in ("nearest", "bicubic", "linear", "area", "nearest-exact"):
            raise ValueError("`mode` should be one of 'nearest' | 'bicubic' | 'linear' | 'area' | 'nearest-exact'")

        def change_one(tensor, wanted):
            if tensor is None:
                return None
            if tuple(tensor.shape[2:]) == tuple(wanted):
                return tensor
            return interpolate_tensor(tensor, tuple(wanted), mode=mode, align_corners=align_corners,
                                      antialias=antialias)

        if epoch is not None:
            if epoch not in self.resolution_changes:
                return grid_values, False
            return {name: change_one(grid_values[name], shape[1:])
                    for name, shape in self.get_shapes(epoch=epoch).items()}, True
        return {name: change_one(grid_values.get(name), tensor.shape[2:])
                for name, tensor in grid_values_with_wanted_resolution.items() if tensor is not None}, True

    def crop_world(self, min_point_world: torch.Tensor, max_point_world: torch.Tensor, grid_values: VoxelGridValues,
                   volume_locator: _GridLocator) -> VoxelGridValues:
        """The values cropped to a world-space box, keeping every voxel that
        its corners need."""
        min_local = volume_locator.world_to_local_coords(min_point_world[None])[0]
        max_local = volume_locator.world_to_local_coords(max_point_world[None])[0]
        return self.crop_local(min_local, max_local, grid_values)

    def _crop_indices(self, min_point_local, max_point_local, resolution) -> Tuple[np.ndarray, np.ndarray]:
        """The first and last voxel index of the crop on each axis (host)."""
        lo = np.clip(_host64(min_point_local), -1, 1)
        hi = np.clip(_host64(max_point_local), -1, 1)
        res = np.asarray(resolution, np.float64)
        lo01, hi01 = (lo + 1) / 2, (hi + 1) / 2
        if self.align_corners:
            return np.floor(lo01 * (res - 1)).astype(np.int64), np.ceil(hi01 * (res - 1)).astype(np.int64)
        return np.floor(lo01 * res - 0.5).astype(np.int64), np.ceil(hi01 * res - 0.5).astype(np.int64)

    def crop_local(self, min_point_local, max_point_local, grid_values: VoxelGridValues) -> VoxelGridValues:
        raise NotImplementedError()


def _host64(x) -> np.ndarray:
    return x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


def _flat_points(points: torch.Tensor) -> torch.Tensor:
    return points.reshape(points.shape[0], -1, points.shape[-1])


@registry.register
class FullResolutionVoxelGrid(VoxelGridBase):
    """A dense (features, width, height, depth) grid: {"voxel_grid": (G, F, W, H, D)}."""

    values_type = FullResolutionVoxelGridValues

    def evaluate_local(self, points, grid_values):
        grid_values = _values_as_dict(grid_values)
        out = interpolate_volume(_flat_points(points), grid_values["voxel_grid"], **self._kw())
        return out.reshape(*points.shape[:-1], -1)

    def get_shapes(self, epoch: int) -> Dict[str, Tuple[int, ...]]:
        width, height, depth = self.get_resolution(epoch)
        return {"voxel_grid": (self.n_features, width, height, depth)}

    def crop_local(self, min_point_local, max_point_local, grid_values):
        vg = grid_values["voxel_grid"]
        assert np.all(_host64(min_point_local) < _host64(max_point_local))
        (minx, miny, minz), (maxx, maxy, maxz) = self._crop_indices(min_point_local, max_point_local, vg.shape[2:5])
        return {"voxel_grid": vg[:, :, minx: maxx + 1, miny: maxy + 1, minz: maxz + 1]}


def _crop_vectors(grid_values, mins, maxs) -> VoxelGridValues:
    out = {f"vector_components_{a}": grid_values[f"vector_components_{a}"][:, :, lo: hi + 1]
           for a, lo, hi in zip("xyz", mins, maxs)}
    if grid_values.get("basis_matrix") is not None:
        out["basis_matrix"] = grid_values["basis_matrix"]
    return out


def _resolution_of(grid_values) -> Tuple[int, int, int]:
    return tuple(grid_values[f"vector_components_{a}"].shape[-1] for a in "xyz")


@registry.register
class CPFactorizedVoxelGrid(VoxelGridBase):
    """CANDECOMP/PARAFAC rank-R grid, sum_r x_r (x) y_r (x) z_r, through a
    (R, n_features) basis matrix where there is one:
    vector_components_{x,y,z} (G, R, res) [+ basis_matrix (G, R, F)]."""

    values_type = CPFactorizedVoxelGridValues
    n_components: int = 24
    basis_matrix: bool = True

    def evaluate_local(self, points, grid_values):
        grid_values = _values_as_dict(grid_values)
        pts = _flat_points(points)
        mult = None
        for i, axis in enumerate("xyz"):
            f = interpolate_line(pts[..., i: i + 1], grid_values["vector_components_" + axis], **self._kw())
            mult = f if mult is None else mult * f  # (G, P, R)
        if grid_values.get("basis_matrix") is not None:
            result = _basis_product(mult, grid_values["basis_matrix"])
        else:
            result = mult.sum(dim=-1, keepdim=True)
        return result.reshape(*points.shape[:-1], -1)

    def get_shapes(self, epoch: int) -> Dict[str, Tuple[int, ...]]:
        if self.basis_matrix is False and self.n_features != 1:
            raise ValueError("Cannot set basis_matrix=False and n_features to != 1")
        width, height, depth = self.get_resolution(epoch)
        shape_dict = {"vector_components_x": (self.n_components, width),
                      "vector_components_y": (self.n_components, height),
                      "vector_components_z": (self.n_components, depth)}
        if self.basis_matrix:
            shape_dict["basis_matrix"] = (self.n_components, self.n_features)
        return shape_dict

    def crop_local(self, min_point_local, max_point_local, grid_values):
        assert np.all(_host64(min_point_local) < _host64(max_point_local))
        mins, maxs = self._crop_indices(min_point_local, max_point_local, _resolution_of(grid_values))
        return _crop_vectors(grid_values, mins, maxs)


@registry.register
class VMFactorizedVoxelGrid(VoxelGridBase):
    """TensoRF's vector-matrix factorisation, xy (x) z + xz (x) y + yz (x) x:
    matrix_components_{xy,yz,xz} (G, R, r0, r1), vector_components_{x,y,z}
    (G, R, r2) [+ basis_matrix (G, sum R, F)]."""

    values_type = VMFactorizedVoxelGridValues
    n_components: Optional[int] = None
    distribution_of_components: Optional[Tuple[int, int, int]] = None
    basis_matrix: bool = True

    def evaluate_local(self, points, grid_values):
        grid_values = _values_as_dict(grid_values)
        pts = _flat_points(points)
        kw = self._kw()
        a = interpolate_plane(pts[..., :2], grid_values["matrix_components_xy"], **kw) * interpolate_line(
            pts[..., 2:], grid_values["vector_components_z"], **kw)
        b = interpolate_plane(pts[..., [0, 2]], grid_values["matrix_components_xz"], **kw) * interpolate_line(
            pts[..., 1:2], grid_values["vector_components_y"], **kw)
        c = interpolate_plane(pts[..., 1:], grid_values["matrix_components_yz"], **kw) * interpolate_line(
            pts[..., :1], grid_values["vector_components_x"], **kw)
        feats = torch.cat([a, b, c], dim=-1)
        if grid_values.get("basis_matrix") is not None:
            result = _basis_product(feats, grid_values["basis_matrix"])
        else:
            result = feats.sum(dim=-1, keepdim=True)
        return result.reshape(*points.shape[:-1], -1)

    def _distribution(self) -> List[int]:
        if self.distribution_of_components is None and self.n_components is None:
            raise ValueError("You need to provide n_components or distribution_of_components")
        if self.distribution_of_components is not None and self.n_components is not None:
            raise ValueError("You cannot define n_components and distribution_of_components")
        if self.distribution_of_components is None:
            if self.n_components % 3 != 0:
                raise ValueError("n_components must be divisible by 3")
            return [self.n_components // 3] * 3
        return list(self.distribution_of_components)

    def get_shapes(self, epoch: int) -> Dict[str, Tuple[int, ...]]:
        if self.basis_matrix is False and self.n_features != 1:
            raise ValueError("Cannot set basis_matrix=False and n_features to != 1")
        dist = self._distribution()
        width, height, depth = self.get_resolution(epoch)
        shape_dict = {
            "vector_components_x": (dist[1], width),
            "vector_components_y": (dist[2], height),
            "vector_components_z": (dist[0], depth),
            "matrix_components_xy": (dist[0], width, height),
            "matrix_components_yz": (dist[1], height, depth),
            "matrix_components_xz": (dist[2], width, depth),
        }
        if self.basis_matrix:
            shape_dict["basis_matrix"] = (sum(dist), self.n_features)
        return shape_dict

    def crop_local(self, min_point_local, max_point_local, grid_values):
        assert np.all(_host64(min_point_local) < _host64(max_point_local))
        (minx, miny, minz), (maxx, maxy, maxz) = mins, maxs = self._crop_indices(
            min_point_local, max_point_local, _resolution_of(grid_values))
        out = _crop_vectors(grid_values, mins, maxs)
        out["matrix_components_xy"] = grid_values["matrix_components_xy"][:, :, minx: maxx + 1, miny: maxy + 1]
        out["matrix_components_yz"] = grid_values["matrix_components_yz"][:, :, miny: maxy + 1, minz: maxz + 1]
        out["matrix_components_xz"] = grid_values["matrix_components_xz"][:, :, minx: maxx + 1, minz: maxz + 1]
        return out


for _cls in (VoxelGridBase, FullResolutionVoxelGrid, CPFactorizedVoxelGrid, VMFactorizedVoxelGrid):
    expand_args_fields(_cls)


# --------------------------------------------------------------------------- #
# VoxelGridModule: the values as parameters, placed in the world
# --------------------------------------------------------------------------- #


class VoxelGridModule(nn.Module):
    """A voxel grid whose values are parameters (buffers where
    `hold_voxel_grid_as_parameters` is False), made at epoch 0's shapes
    from init_mean + init_std * N(0, 1) draws of `generator`; the buffers
    `extents` and `translation` place it in the world:
    x_world = x_local * extents / 2 + translation."""

    def __init__(
        self,
        voxel_grid_class_type: str = "FullResolutionVoxelGrid",
        voxel_grid_args: Optional[Dict[str, Any]] = None,
        extents: Tuple[float, float, float] = (2.0, 2.0, 2.0),
        translation: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        init_std: float = 0.1,
        init_mean: float = 0.0,
        hold_voxel_grid_as_parameters: bool = True,
        param_groups: Optional[Dict[str, str]] = None,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        # the config is `grid`: the dense grid's values are the parameter `voxel_grid`
        self.grid = registry.get(VoxelGridBase, voxel_grid_class_type)(**(voxel_grid_args or {}))
        self.hold_voxel_grid_as_parameters = hold_voxel_grid_as_parameters
        self.param_groups = param_groups
        self.value_names = tuple(self.grid.get_shapes(epoch=0))
        for name, shape in self.grid.get_shapes(epoch=0).items():
            value = torch.full((1, *shape), float(init_mean), device=device)
            if init_std:
                value = value + init_std * torch.randn((1, *shape), generator=generator, device=device)
            if hold_voxel_grid_as_parameters:
                self.register_parameter(name, nn.Parameter(value))
            else:
                self.register_buffer(name, value)
        self.register_buffer("extents", torch.tensor(extents, dtype=torch.float32, device=device))
        self.register_buffer("translation", torch.tensor(translation, dtype=torch.float32, device=device))

    def values(self) -> VoxelGridValues:
        return {name: getattr(self, name) for name in self.value_names}

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """World points (..., 3) -> (..., n_features)."""
        return self.evaluate(points, self.values(), self.extents, self.translation)

    def evaluate(self, points, values: VoxelGridValues, extents, translation) -> torch.Tensor:
        """The grid of `values` placed by `extents` and `translation` at world
        points (..., 3)."""
        local = (points - translation) * (2.0 / extents)
        return self.grid.evaluate_local(local[None], values)[0]

    @staticmethod
    def get_output_dim(args: Dict[str, Any]) -> int:
        grid_cls = registry.get(VoxelGridBase, args.get("voxel_grid_class_type", "FullResolutionVoxelGrid"))
        return grid_cls.get_output_dim({"n_features": 1, **(args.get("voxel_grid_args") or {})})

    def get_resolution_change_epochs(self) -> Tuple[int, ...]:
        return self.grid.get_resolution_change_epochs()

    def get_grid_points(self, epoch: int, extents=None, translation=None) -> torch.Tensor:
        """World-space voxel centres at `epoch`, (W, H, D, 3), from the given
        placement (default: this module's buffers).  The depths follow
        jnp.linspace's rule (`_linspace`), as the JAX package's do."""
        resolution = self.grid.get_resolution(epoch)
        ext = _host64(self.extents if extents is None else extents).tolist()
        tr = self.translation if translation is None else translation
        axes = []
        for e, res in zip(ext, resolution):
            if not self.grid.get_align_corners() and res > 1:
                e = e * (res - 1) / res
            bounds = (torch.tensor(v, dtype=torch.float32, device=self.extents.device) for v in (-e / 2, e / 2))
            axes.append(_linspace(*bounds, res, self.extents))
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=3)
        return grid + torch.as_tensor(tr, dtype=grid.dtype, device=grid.device)


def apply_resolution_change(module: VoxelGridModule, params: VoxelGridValues, epoch: int,
                            **interp_kwargs) -> Tuple[VoxelGridValues, bool]:
    """The module's values resampled to `epoch`'s resolution: (new values,
    changed?); the values as they are where the epoch changes nothing."""
    new_values, changed = module.grid.change_resolution(params, epoch=epoch, **interp_kwargs)
    return (new_values if changed else params), changed


def crop_values(module: VoxelGridModule, params: VoxelGridValues, buffers: Dict[str, torch.Tensor],
                min_point, max_point) -> Tuple[VoxelGridValues, Dict[str, torch.Tensor]]:
    """The grid cropped to the [min_point, max_point] world box and resampled
    back to its resolution, with `buffers`' extents and translation moved
    to that box: (new values, new buffers)."""
    grid = module.grid
    locator = _GridLocator(tuple(_host64(buffers["extents"]).tolist()), tuple(_host64(buffers["translation"]).tolist()))
    device = params[next(iter(params))].device
    mn64, mx64 = _host64(min_point), _host64(max_point)
    cropped = grid.crop_world(torch.as_tensor(min_point, dtype=torch.float32, device=device),
                              torch.as_tensor(max_point, dtype=torch.float32, device=device), params, locator)
    new_values, _ = grid.change_resolution(cropped, grid_values_with_wanted_resolution=params)
    new_buffers = dict(buffers,
                       extents=torch.tensor(mx64 - mn64, dtype=torch.float32, device=device),
                       translation=torch.tensor((mx64 + mn64) / 2, dtype=torch.float32, device=device))
    return new_values, new_buffers
