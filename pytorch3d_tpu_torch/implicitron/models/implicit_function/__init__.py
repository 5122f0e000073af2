"""Implicit functions (port of
pytorch3d_tpu/implicitron/models/implicit_function): NeRF, NeRFormer, IDR,
the voxel grids and the decoding functions so far."""
from .base import ImplicitFunctionBase
from .decoding_functions import DecoderFunctionBase, ElementwiseDecoder, MLPDecoder, MLPWithInputSkips
from .idr_feature_field import IdrFeatureField
from .neural_radiance_field import NeRFormerImplicitFunction, NeuralRadianceFieldImplicitFunction
from .voxel_grid import (
    CPFactorizedVoxelGrid,
    CPFactorizedVoxelGridValues,
    FullResolutionVoxelGrid,
    FullResolutionVoxelGridValues,
    VMFactorizedVoxelGrid,
    VMFactorizedVoxelGridValues,
    VoxelGridBase,
    VoxelGridModule,
    VoxelGridValuesBase,
    apply_resolution_change,
    crop_values,
    interpolate_line,
    interpolate_plane,
    interpolate_tensor,
    interpolate_volume,
)
from .voxel_grid_implicit_function import VoxelGridImplicitFunction

__all__ = [k for k in dir() if not k.startswith("_")]
