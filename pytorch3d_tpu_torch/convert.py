"""Build the port's objects from numpy arrays taken from the JAX package's.

The JAX objects are flax dataclasses of arrays; a caller converts their
fields with `np.asarray` and hands them here, so both packages render the
same scene from the same state.  Nothing here imports JAX.  The mesh and
point rendering paths have no learned weights: their state is geometry,
vertex colors, UV maps or atlases, point features, cameras, lights and
materials; pulsar's
state is its sphere table (positions, colours, radii, opacities), which
passes across as float32 arrays.  The NeRF
model's weights convert between a flax `RadianceFieldRenderer` param tree
(as nested dicts of numpy arrays) and the port's `state_dict`, and a flax
`LinearWithRepeat`'s, a flax `GraphConv`'s and an Implicitron
`GenericModel`'s into the port's modules.  A
`Volumes`' densities, features and locator pass across as float32 arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .common import DEFAULT_DEVICE
from .renderer.cameras import (
    FoVOrthographicCameras,
    FoVPerspectiveCameras,
    OrthographicCameras,
    PerspectiveCameras,
)
from .renderer.fisheyecameras import FishEyeCameras
from .renderer.lighting import AmbientLights, DirectionalLights, PointLights
from .renderer.materials import Materials
from .renderer.mesh.textures import TexturesAtlas, TexturesUV, TexturesVertex
from .structures import Meshes, Pointclouds, Volumes

Device = Union[str, torch.device]
Arrays = Union[np.ndarray, Sequence[np.ndarray]]


def _own(a):
    """A writable copy: `np.asarray` of a JAX array is a read-only view,
    which torch refuses to share."""
    if isinstance(a, (list, tuple)):
        return [np.array(x) for x in a]
    return None if a is None else np.array(a)


def meshes_from_numpy(
    verts: Arrays,
    faces: Arrays,
    num_verts_per_mesh: Optional[np.ndarray] = None,
    num_faces_per_mesh: Optional[np.ndarray] = None,
    verts_features: Optional[Arrays] = None,
    device: Device = DEFAULT_DEVICE,
) -> Meshes:
    """Meshes from per-mesh lists, or padded arrays (-1 padded faces) plus
    counts, with optional per-vertex colors (TexturesVertex)."""
    textures = None
    if verts_features is not None:
        textures = textures_vertex_from_numpy(verts_features, device=device)
    return Meshes.create(
        verts=_own(verts), faces=_own(faces), textures=textures,
        num_verts_per_mesh=_own(num_verts_per_mesh), num_faces_per_mesh=_own(num_faces_per_mesh),
        device=device,
    )


def textures_vertex_from_numpy(verts_features: Arrays, device: Device = DEFAULT_DEVICE) -> TexturesVertex:
    """TexturesVertex from a list of (V_i, C) or a padded (N, V, C) array."""
    return TexturesVertex.create(_own(verts_features), device=device)


def textures_uv_from_numpy(
    maps: Arrays,
    faces_uvs: Arrays,
    verts_uvs: Arrays,
    padding_mode: str = "border",
    align_corners: bool = True,
    sampling_mode: str = "bilinear",
    device: Device = DEFAULT_DEVICE,
) -> TexturesUV:
    """TexturesUV from lists of per-mesh arrays or batched ones: maps
    (N, H, W, C), faces_uvs (N, F, 3), verts_uvs (N, Vuv, 2)."""
    return TexturesUV.create(
        _own(maps), _own(faces_uvs), _own(verts_uvs), padding_mode=padding_mode,
        align_corners=align_corners, sampling_mode=sampling_mode, device=device,
    )


def textures_atlas_from_numpy(atlas: Arrays, device: Device = DEFAULT_DEVICE) -> TexturesAtlas:
    """TexturesAtlas from a list of (F_i, R, R, C) or a padded (N, F, R, R, C) array."""
    return TexturesAtlas.create(_own(atlas), device=device)


def fov_perspective_cameras_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    znear: np.ndarray,
    zfar: np.ndarray,
    aspect_ratio: np.ndarray,
    fov: np.ndarray,
    degrees: bool = True,
    device: Device = DEFAULT_DEVICE,
) -> FoVPerspectiveCameras:
    """FoVPerspectiveCameras from the JAX camera's R, T, znear, zfar,
    aspect_ratio and fov (degrees unless `degrees` is False)."""
    return FoVPerspectiveCameras.create(
        znear=_own(znear), zfar=_own(zfar), aspect_ratio=_own(aspect_ratio), fov=_own(fov),
        degrees=degrees, R=_own(R), T=_own(T), device=device,
    )


def pointclouds_from_numpy(
    points: Arrays,
    features: Optional[Arrays] = None,
    normals: Optional[Arrays] = None,
    num_points_per_cloud: Optional[np.ndarray] = None,
    device: Device = DEFAULT_DEVICE,
) -> Pointclouds:
    """Pointclouds from per-cloud lists, or padded arrays plus counts, with
    optional features and normals in the same form as the points."""
    return Pointclouds.create(
        _own(points), normals=_own(normals), features=_own(features),
        num_points_per_cloud=_own(num_points_per_cloud), device=device,
    )


def fov_orthographic_cameras_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    znear: np.ndarray,
    zfar: np.ndarray,
    max_y: np.ndarray,
    min_y: np.ndarray,
    max_x: np.ndarray,
    min_x: np.ndarray,
    scale_xyz: np.ndarray,
    device: Device = DEFAULT_DEVICE,
) -> FoVOrthographicCameras:
    """FoVOrthographicCameras from the JAX camera's R, T, znear, zfar, the
    view box bounds and scale_xyz."""
    return FoVOrthographicCameras.create(
        znear=_own(znear), zfar=_own(zfar), max_y=_own(max_y), min_y=_own(min_y),
        max_x=_own(max_x), min_x=_own(min_x), scale_xyz=_own(scale_xyz),
        R=_own(R), T=_own(T), device=device,
    )


def perspective_cameras_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    focal_length: np.ndarray,
    principal_point: np.ndarray,
    image_size: Optional[np.ndarray] = None,
    in_ndc: bool = True,
    device: Device = DEFAULT_DEVICE,
) -> PerspectiveCameras:
    """PerspectiveCameras from the JAX camera's R, T, focal_length,
    principal_point, image_size and in-NDC flag (`_in_ndc` there)."""
    return PerspectiveCameras.create(
        focal_length=_own(focal_length), principal_point=_own(principal_point), R=_own(R), T=_own(T),
        image_size=_own(image_size), in_ndc=in_ndc, device=device,
    )


def orthographic_cameras_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    focal_length: np.ndarray,
    principal_point: np.ndarray,
    image_size: Optional[np.ndarray] = None,
    in_ndc: bool = True,
    device: Device = DEFAULT_DEVICE,
) -> OrthographicCameras:
    """OrthographicCameras from the same fields as
    `perspective_cameras_from_numpy`."""
    return OrthographicCameras.create(
        focal_length=_own(focal_length), principal_point=_own(principal_point), R=_own(R), T=_own(T),
        image_size=_own(image_size), in_ndc=in_ndc, device=device,
    )


def point_lights_from_numpy(
    ambient_color: np.ndarray,
    diffuse_color: np.ndarray,
    specular_color: np.ndarray,
    location: np.ndarray,
    device: Device = DEFAULT_DEVICE,
) -> PointLights:
    return PointLights.create(
        ambient_color=_own(ambient_color), diffuse_color=_own(diffuse_color),
        specular_color=_own(specular_color), location=_own(location), device=device,
    )


def directional_lights_from_numpy(
    ambient_color: np.ndarray,
    diffuse_color: np.ndarray,
    specular_color: np.ndarray,
    direction: np.ndarray,
    device: Device = DEFAULT_DEVICE,
) -> DirectionalLights:
    return DirectionalLights.create(
        ambient_color=_own(ambient_color), diffuse_color=_own(diffuse_color),
        specular_color=_own(specular_color), direction=_own(direction), device=device,
    )


def ambient_lights_from_numpy(ambient_color: np.ndarray, device: Device = DEFAULT_DEVICE) -> AmbientLights:
    return AmbientLights.create(ambient_color=_own(ambient_color), device=device)


def materials_from_numpy(
    ambient_color: np.ndarray,
    diffuse_color: np.ndarray,
    specular_color: np.ndarray,
    shininess: np.ndarray,
    device: Device = DEFAULT_DEVICE,
) -> Materials:
    return Materials.create(
        ambient_color=_own(ambient_color), diffuse_color=_own(diffuse_color),
        specular_color=_own(specular_color), shininess=_own(shininess), device=device,
    )


# The NeRF field's dense layers, by the flax names the port keeps.
def fisheye_cameras_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    focal_length: np.ndarray,
    principal_point: np.ndarray,
    radial_params: np.ndarray,
    tangential_params: np.ndarray,
    thin_prism_params: np.ndarray,
    use_radial: bool = True,
    use_tangential: bool = True,
    use_thin_prism: bool = True,
    world_coordinates: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> FishEyeCameras:
    """FishEyeCameras from the JAX camera's fields and flags."""
    return FishEyeCameras.create(
        focal_length=_own(focal_length), principal_point=_own(principal_point),
        radial_params=_own(radial_params), tangential_params=_own(tangential_params),
        thin_prism_params=_own(thin_prism_params), R=_own(R), T=_own(T), world_coordinates=world_coordinates,
        use_radial=use_radial, use_tangential=use_tangential, use_thin_prism=use_thin_prism, device=device,
    )


def volumes_from_numpy(
    densities: np.ndarray,
    features: Optional[np.ndarray] = None,
    voxel_size: Union[float, np.ndarray] = 1.0,
    volume_translation: Union[Sequence[float], np.ndarray] = (0.0, 0.0, 0.0),
    align_corners: bool = True,
    device: Device = DEFAULT_DEVICE,
) -> Volumes:
    """Volumes from densities (N, C_d, D, H, W), optional features
    (N, C_f, D, H, W), voxel sizes (a scalar, (N,), (3,) or (N, 3)) and
    translations ((3,) or (N, 3)): a JAX `Volumes`' `densities()`,
    `features()`, `locator.voxel_size` and `locator.volume_translation`.
    Both packages' grids take align_corners=True only."""
    if not align_corners:
        raise ValueError("Volumes take align_corners=True only, in both packages")
    return Volumes.create(
        torch.from_numpy(_own(densities)), None if features is None else torch.from_numpy(_own(features)),
        voxel_size=torch.as_tensor(_own(voxel_size)), volume_translation=torch.as_tensor(_own(volume_translation)),
        device=device,
    )


def linear_with_repeat_state_dict_from_flax(params: Mapping, device: Device = DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """A `LinearWithRepeat` state_dict from the flax module's params
    (`{"params": {"kernel", "bias"}}` or its inside) as numpy; the kernel
    stays (in, out)."""
    tree = params.get("params", params)
    return {leaf: torch.as_tensor(np.array(tree[leaf]), dtype=torch.float32, device=device)
            for leaf in ("kernel", "bias")}


def graph_conv_state_dict_from_flax(params: Mapping, device: Device = DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """A `GraphConv` state_dict from the flax module's params (`{"params":
    {"w0", "w1"}}` or its inside) as numpy: each flax (in, out) kernel
    becomes its `nn.Linear`'s (out, in) weight."""
    tree = params.get("params", params)
    state = {}
    for layer in ("w0", "w1"):
        state[f"{layer}.weight"] = torch.as_tensor(np.array(tree[layer]["kernel"]).T, dtype=torch.float32, device=device)
        state[f"{layer}.bias"] = torch.as_tensor(np.array(tree[layer]["bias"]), dtype=torch.float32, device=device)
    return state


_NERF_FIELDS = ("_renderer_coarse_field", "_renderer_fine_field")
_NERF_HEAD = ("intermediate_linear", "density_layer", "color_layer_hidden", "color_layer_out")


def nerf_state_dict_from_flax(params: Mapping, device: Device = DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """A `RadianceFieldRenderer` state_dict from the flax param tree
    (`{"params": ...}` or its inside) as numpy:
    `{_renderer_coarse_field, _renderer_fine_field}/{mlp_xyz/layer{i},
    intermediate_linear, density_layer, color_layer_hidden,
    color_layer_out}/{kernel, bias}`.  Flax kernels are (in, out), as the
    port keeps them, so each tensor is copied as it is; the colour layer's
    kernel splits at H into wc1a / wc1b in
    `NeuralRadianceField.head_params`, as the JAX module splits it."""
    tree = params.get("params", params)
    state = {}
    for field in _NERF_FIELDS:
        mlp = tree[field]["mlp_xyz"]
        layers = [f"mlp_xyz.layer{i}" for i in range(len(mlp))]
        for name in layers + list(_NERF_HEAD):
            node = tree[field]
            for part in name.split("."):
                node = node[part]
            for leaf in ("kernel", "bias"):
                state[f"{field}.{name}.{leaf}"] = torch.as_tensor(np.array(node[leaf]), dtype=torch.float32, device=device)
    return state


def nerf_state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The flax param tree (`{"params": ...}`, numpy leaves) of a
    `RadianceFieldRenderer` state_dict: the inverse of
    `nerf_state_dict_from_flax`."""
    tree: Dict = {}
    for key, value in state_dict.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()
    return {"params": tree}


def generic_model_state_dict_from_flax(variables: Mapping, device: Device = DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """An Implicitron `GenericModel` state_dict from the flax variables
    (`{"params": ..., "buffers": ...}`, or the params' inside) as numpy,
    name for name:
    - each `implicit_function_{i}` (one where the passes share it): its
      trunk (`xyz_encoder/layer{l}`, or NeRFormer's `first`, `skip{l}`,
      `last` and `pool{l}` / `ray{l}` with `self_attn/{query, key, value,
      out}`, `norm1`, `norm2`, `linear1`, `linear2`), its density and colour
      layers, and any decoder (`network/layer{l}`, `skip_affine{l}{a, b}`):
      dense and attention kernels copied as they are (the port keeps flax's
      (in, out) and (d, heads, d / heads) layouts), layer norms' `scale` and
      `bias` too; IDR's `linear{l}` with weight norm's `scale`; a voxel
      grid function's grid values, and from the `buffers` collection its
      grids' `extents` / `translation`, the scaffold's `voxel_grid` and
      `scaffold_ready`;
    - the SDF renderer's colouring network (`_renderer_flax_module` ->
      `_renderer.rgb_network`);
    - the global encoder's table (`_global_encoder/autodecoder/Embed_0/
      embedding` -> `_global_encoder.autodecoder.embedding`);
    - `_image_feature_extractor`: conv kernels HWIO -> OIHW as `weight`
      (the projections' `bias` beside), the four `FrozenBatchNorm` vectors
      as they are."""
    trees = [variables["params"], variables.get("buffers", {})] if "params" in variables else [variables]
    renamed = {"_renderer_flax_module": ["_renderer", "rgb_network"]}
    state = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + ([] if key == "Embed_0" else [key]))
                continue
            value = np.array(value)
            if path[0] == "_image_feature_extractor" and key == "kernel":
                key, value = "weight", value.transpose(3, 2, 0, 1)
            state[".".join(path + [key])] = torch.as_tensor(value, dtype=torch.float32, device=device)

    for tree in trees:
        for top in tree:
            if top.startswith("implicit_function_") or top in ("_global_encoder", "_image_feature_extractor"):
                walk(tree[top], [top])
            elif top in renamed:
                walk(tree[top], renamed[top])
            else:
                raise ValueError(f"no port of the flax GenericModel's {top!r} variables yet")
    return state
