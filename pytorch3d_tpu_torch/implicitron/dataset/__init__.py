"""Implicitron's dataset layer (port of pytorch3d_tpu/implicitron/dataset):
`FrameData` and its builders, the annotation types, the dataset utilities
and the rendered-mesh provider so far."""
from .frame_data import FrameData, FrameDataBuilder, FrameDataBuilderBase, GenericFrameDataBuilder
from .rendered_mesh_dataset_map_provider import RenderedMeshDatasetMapProvider

__all__ = [k for k in dir() if not k.startswith("_")]
