"""The voxel-grid implicit function of Implicitron, DVGO / TensoRF style
(port of
pytorch3d_tpu/implicitron/models/implicit_function/voxel_grid_implicit_function.py).

Two streams: density (grid, harmonic embedding, decoder, then
`density_activation`) and colour (grid, harmonic embedding, with the
harmonics of the ray's direction, decoder).  A low-resolution occupancy
"scaffold" (TensoRF's alpha mask) zeroes the points of empty space once it
is computed, and its bounding box crops the grids.

As in the JAX module, every point is evaluated and then multiplied by the
scaffold mask (upstream gathers the occupied points into a ragged set).
The epoch schedule (`subscribe_to_epochs`, `apply_epoch`: resolution
changes, the scaffold's computation, the crop) transforms the function's
state dict between steps and says whether parameter shapes or values
changed; the caller loads the new state
(`implicitron.models.utils.load_state_dict_resized`) and rebuilds its
optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ....common import DEFAULT_DEVICE, safe_norm
from ....renderer.implicit.harmonic_embedding import HarmonicEmbedding
from ....renderer.implicit.utils import ray_bundle_to_ray_points
from ...tools.config import expand_args_fields, registry
from .base import ImplicitFunctionBase
from .decoding_functions import DecoderFunctionBase
from .voxel_grid import VoxelGridModule, apply_resolution_change, crop_values

Device = Union[str, torch.device]

_GRID_CLASS_FOR_LEGACY_TYPE = {"full": "FullResolutionVoxelGrid", "cp": "CPFactorizedVoxelGrid",
                               "vm": "VMFactorizedVoxelGrid"}
_NO_HARMONICS = {"n_harmonic_functions": 0, "append_input": True}
_PLACEMENT = ("extents", "translation")
_STREAMS = ("voxel_grid_density", "voxel_grid_color")


def _sub_state(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")}


@registry.register
class VoxelGridImplicitFunction(ImplicitFunctionBase, nn.Module):
    """Density and colour from voxel grids.

    The `*_args` dicts give the full surface; where the grid ones are not
    given, the legacy fields (grid_type / resolution / n_components /
    n_features_* / scene_extent) make them.  `density_activation` defaults
    to 1 - exp(-softplus(x)) as the legacy class did; "identity" gives the
    raw density that the raymarcher caps."""

    voxel_grid_density_args: Optional[Dict[str, Any]] = None
    voxel_grid_color_args: Optional[Dict[str, Any]] = None
    harmonic_embedder_xyz_density_args: Optional[Dict[str, Any]] = None
    harmonic_embedder_xyz_color_args: Optional[Dict[str, Any]] = None
    harmonic_embedder_dir_color_args: Optional[Dict[str, Any]] = None
    decoder_density_class_type: str = "ElementwiseDecoder"
    decoder_density_args: Optional[Dict[str, Any]] = None
    decoder_color_class_type: str = "MLPDecoder"
    decoder_color_args: Optional[Dict[str, Any]] = None
    xyz_ray_dir_in_camera_coords: bool = False
    scaffold_calculating_epochs: Tuple[int, ...] = ()
    scaffold_resolution: Tuple[int, int, int] = (128, 128, 128)
    scaffold_empty_space_threshold: float = 0.001
    scaffold_max_pool_kernel_size: int = 3
    scaffold_filter_points: bool = True
    volume_cropping_epochs: Tuple[int, ...] = ()
    grid_type: str = "vm"
    resolution: Tuple[int, int, int] = (64, 64, 64)
    n_components: int = 24
    n_features_density: int = 1
    n_features_color: int = 27
    n_hidden_color: int = 64
    n_harmonic_functions_dir: int = 2
    scene_extent: float = 2.0
    density_activation: str = "one_minus_exp_softplus"
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        made = dict(device=self.device, generator=self.generator)
        self.voxel_grid_density = VoxelGridModule(**self._density_grid_args(), **made)
        self.voxel_grid_color = VoxelGridModule(**self._color_grid_args(), **made)
        self.voxel_grid_scaffold = VoxelGridModule(**self._scaffold_grid_args(), device=self.device)
        self.harmonic_embedder_xyz_density = HarmonicEmbedding(
            **(self.harmonic_embedder_xyz_density_args if self.harmonic_embedder_xyz_density_args is not None
               else _NO_HARMONICS))
        self.harmonic_embedder_xyz_color = HarmonicEmbedding(
            **(self.harmonic_embedder_xyz_color_args if self.harmonic_embedder_xyz_color_args is not None
               else _NO_HARMONICS))
        self.harmonic_embedder_dir_color = HarmonicEmbedding(
            **(self.harmonic_embedder_dir_color_args if self.harmonic_embedder_dir_color_args is not None
               else {"n_harmonic_functions": self.n_harmonic_functions_dir, "append_input": True}))
        width_density = self.harmonic_embedder_xyz_density.get_output_dim(
            VoxelGridModule.get_output_dim(self._density_grid_args()))
        width_color = (self.harmonic_embedder_xyz_color.get_output_dim(
            VoxelGridModule.get_output_dim(self._color_grid_args()))
            + self.harmonic_embedder_dir_color.get_output_dim(3))
        self.decoder_density = self._make_decoder("density", width_density)
        self.decoder_color = self._make_decoder("color", width_color)
        self.register_buffer("scaffold_ready", torch.zeros((), device=self.device))
        self.generator = None  # used once; a module keeps no generator

    # -- configuration ---------------------------------------------------------

    def _legacy_grid_args(self, n_features: int) -> Dict[str, Any]:
        grid_args: Dict[str, Any] = {"n_features": n_features, "resolution_changes": {0: list(self.resolution)}}
        if self.grid_type in ("cp", "vm"):
            grid_args["n_components"] = self.n_components
        return {"voxel_grid_class_type": _GRID_CLASS_FOR_LEGACY_TYPE[self.grid_type], "voxel_grid_args": grid_args,
                "extents": (2.0 * self.scene_extent,) * 3, "translation": (0.0, 0.0, 0.0)}

    def _density_grid_args(self) -> Dict[str, Any]:
        return self.voxel_grid_density_args or self._legacy_grid_args(self.n_features_density)

    def _color_grid_args(self) -> Dict[str, Any]:
        return self.voxel_grid_color_args or self._legacy_grid_args(self.n_features_color)

    def _scaffold_grid_args(self) -> Dict[str, Any]:
        """A dense occupancy grid placed as the density grid, sampled
        nearest; ones (occupied) until computed."""
        density = self._density_grid_args()
        return {
            "voxel_grid_class_type": "FullResolutionVoxelGrid",
            "voxel_grid_args": {"n_features": 1, "resolution_changes": {0: list(self.scaffold_resolution)},
                                "mode": "nearest"},
            "extents": density.get("extents", (2.0, 2.0, 2.0)),
            "translation": density.get("translation", (0.0, 0.0, 0.0)),
            "hold_voxel_grid_as_parameters": False,
            "init_std": 0.0,
            "init_mean": 1.0,
        }

    def _make_decoder(self, which: str, input_dim: int) -> nn.Module:
        """The density or colour decoder from the registry, at `input_dim`;
        without args the colour MLP is the legacy TensoRF head (Dense(H),
        ReLU, Dense(3), sigmoid)."""
        class_type = getattr(self, f"decoder_{which}_class_type")
        args = getattr(self, f"decoder_{which}_args")
        cls = registry.get(DecoderFunctionBase, class_type)
        expand_args_fields(cls)
        if args is None:
            args = {}
            if which == "color" and class_type == "MLPDecoder":
                args = {"network_args": {"n_layers": 2, "hidden_dim": self.n_hidden_color, "output_dim": 3,
                                         "input_skips": (), "last_activation": "sigmoid",
                                         "last_layer_bias_init": 0.0, "use_xavier_init": False}}
        fields = {f.name for f in dataclasses.fields(cls)}
        made = {k: v for k, v in dict(input_dim=input_dim, device=self.device, generator=self.generator).items()
                if k in fields}
        return cls(**{**made, **args})

    # -- evaluation ------------------------------------------------------------

    def _apply_density_activation(self, raw: torch.Tensor) -> torch.Tensor:
        if self.density_activation == "one_minus_exp_softplus":
            return 1.0 - torch.exp(-F.softplus(raw))
        if self.density_activation == "softplus":
            return F.softplus(raw)
        if self.density_activation == "relu":
            return torch.relu(raw)
        return raw  # "identity"

    def _get_density(self, points: torch.Tensor) -> torch.Tensor:
        harmonics = self.harmonic_embedder_xyz_density(self.voxel_grid_density(points))
        return self._apply_density_activation(self.decoder_density(harmonics))

    def _get_color(self, points: torch.Tensor, directions: torch.Tensor, camera=None) -> torch.Tensor:
        """points (..., S, 3), directions (..., 3) one a ray."""
        if self.xyz_ray_dir_in_camera_coords:
            if camera is None:
                raise ValueError("Camera must be given if xyz_ray_dir_in_camera_coords")
            directions = directions @ camera.R
        harmonics_color = self.harmonic_embedder_xyz_color(self.voxel_grid_color(points))
        d = directions / safe_norm(directions, dim=-1, keepdim=True).clamp(min=1e-12)
        harmonics_dir = self.harmonic_embedder_dir_color(d)
        harmonics_dir = harmonics_dir[..., None, :].expand(*points.shape[:-1], harmonics_dir.shape[-1])
        return self.decoder_color(torch.cat([harmonics_color, harmonics_dir], dim=-1))

    def _scaffold_mask(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 1): 0 in empty space, 1 elsewhere and before the scaffold is
        computed."""
        occupied = (self.voxel_grid_scaffold(points) > 0.0).to(points.dtype)
        return torch.where(self.scaffold_ready > 0, occupied, 1.0)

    def forward(self, ray_bundle, fun_viewpool=None, camera=None, global_code=None, density_noise_std: float = 0.0,
                **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Densities (..., S, 1) and colours (..., S, 3) at the bundle's
        points; the scaffold's empty space gives 0 for both."""
        points = ray_bundle_to_ray_points(ray_bundle)
        densities = self._get_density(points)
        colors = self._get_color(points, ray_bundle.directions, camera)
        if self.scaffold_filter_points:
            mask = self._scaffold_mask(points)
            densities, colors = densities * mask, colors * mask
        return densities, colors

    @staticmethod
    def allows_multiple_passes() -> bool:
        return True

    @staticmethod
    def requires_pooling_without_aggregation() -> bool:
        return False

    # -- the epoch schedule ----------------------------------------------------

    def subscribe_to_epochs(self) -> Tuple[int, ...]:
        """Epochs at which `apply_epoch` must run."""
        epochs = set(self.scaffold_calculating_epochs) | set(self.volume_cropping_epochs)
        for args in (self._density_grid_args(), self._color_grid_args()):
            changes = (args.get("voxel_grid_args") or {}).get("resolution_changes", {0: None})
            epochs |= {e for e in changes if e != 0}
        return tuple(sorted(epochs))

    def apply_epoch(self, state: Dict[str, torch.Tensor], epoch: int) -> Tuple[Dict[str, torch.Tensor], bool]:
        """The epoch's updates of this function's state dict: the grids'
        resolution changes, then the scaffold's computation, then the crop
        to its bounding box.  Returns (new state dict, whether trainable
        parameters changed: the caller rebuilds its optimizer then)."""
        state = dict(state)
        changed = False
        with torch.no_grad():
            for name in _STREAMS:
                module = getattr(self, name)
                values = {k: v for k, v in _sub_state(state, name).items() if k in module.value_names}
                new_values, ch = apply_resolution_change(module, values, epoch)
                if ch:
                    state.update({f"{name}.{k}": v for k, v in new_values.items()})
                    changed = True
            if epoch in self.scaffold_calculating_epochs:
                state = self._compute_scaffold(state)
            if epoch in self.volume_cropping_epochs:
                box = self._scaffold_bounding_box(state)
                if box is not None:
                    for name in _STREAMS:
                        sub = _sub_state(state, name)
                        module = getattr(self, name)
                        new_values, new_buffers = crop_values(
                            module, {k: sub[k] for k in module.value_names}, {k: sub[k] for k in _PLACEMENT}, *box)
                        state.update({f"{name}.{k}": v for k, v in {**new_values, **new_buffers}.items()})
                    changed = True
        return state, changed

    def _compute_scaffold(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The density at the scaffold's voxel centres, max-pooled over
        scaffold_max_pool_kernel_size^3 and thresholded at
        scaffold_empty_space_threshold."""
        scaffold = _sub_state(state, "voxel_grid_scaffold")
        points = self.voxel_grid_scaffold.get_grid_points(epoch=0, extents=scaffold["extents"],
                                                          translation=scaffold["translation"])
        density = _sub_state(state, "voxel_grid_density")
        module = self.voxel_grid_density
        feats = module.evaluate(points, {k: density[k] for k in module.value_names}, density["extents"],
                                density["translation"])
        raw = torch.func.functional_call(self.decoder_density, _sub_state(state, "decoder_density"),
                                         (self.harmonic_embedder_xyz_density(feats),))
        cube = self._apply_density_activation(raw)[..., 0]  # (W, H, D)
        k = self.scaffold_max_pool_kernel_size
        pooled = F.max_pool3d(cube[None, None], k, stride=1, padding=k // 2)[0, 0]
        occupancy = (pooled > self.scaffold_empty_space_threshold).to(cube.dtype)
        return dict(state, **{"voxel_grid_scaffold.voxel_grid": occupancy[None, None],
                              "scaffold_ready": torch.ones((), dtype=cube.dtype, device=cube.device)})

    def _scaffold_bounding_box(self, state: Dict[str, torch.Tensor]) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """World corners (min, max) of the occupied scaffold voxels; None if
        there are none or the scaffold is not computed."""
        ready = state.get("scaffold_ready")
        if ready is None or float(ready) <= 0:
            return None
        scaffold = _sub_state(state, "voxel_grid_scaffold")
        idx = torch.nonzero(scaffold["voxel_grid"][0, 0] > 0)
        if idx.shape[0] == 0:
            return None
        points = self.voxel_grid_scaffold.get_grid_points(epoch=0, extents=scaffold["extents"],
                                                          translation=scaffold["translation"])
        return points[tuple(idx.min(dim=0).values)], points[tuple(idx.max(dim=0).values)]


expand_args_fields(VoxelGridImplicitFunction)
