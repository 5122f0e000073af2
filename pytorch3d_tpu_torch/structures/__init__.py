"""Core data structures (port of pytorch3d_tpu/structures): meshes, point
clouds and volumes."""
from .meshes import Meshes, join_meshes_as_batch, join_meshes_as_scene
from .pointclouds import Pointclouds, join_pointclouds_as_batch, join_pointclouds_as_scene
from .utils import list_to_packed, list_to_padded, packed_to_list, padded_to_list, padded_to_packed
from .volumes import VolumeLocator, Volumes

__all__ = [k for k in dir() if not k.startswith("_")]
