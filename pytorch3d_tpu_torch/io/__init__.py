"""Mesh and point cloud file IO (port of pytorch3d_tpu/io): OBJ with MTL,
PLY, OFF, glTF and the pluggable `IO`.  Parsing runs on the host; loaders
make their tensors on `device`, the card where it is None."""
from .obj_io import load_obj, load_objs_as_meshes, save_obj
from .off_io import load_off, save_off
from .pluggable import IO
from .ply_io import load_ply, save_ply

__all__ = [k for k in dir() if not k.startswith("_")]
