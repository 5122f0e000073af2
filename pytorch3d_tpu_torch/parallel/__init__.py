"""Parallelism over a mesh of ranks (port of pytorch3d_tpu/parallel):
process groups and meshes, row-band sharded rasterization, the
ray-sharded NeRF step and the ray-parallel step of Implicitron's
GenericModel."""
from .distributed import PerProcessLoader, local_shard_indices, maybe_initialize_distributed
from .implicitron import make_sharded_generic_train_step, rank_seed
from .mesh import DeviceMesh, Sharding, get_device_mesh, replicated, shard_batch, shard_pixels, shard_rays
from .raster import rasterize_fragments_shard_map, sharded_silhouette_loss_and_grad
from .train import make_nerf_train_step, psum_grads

__all__ = [k for k in dir() if not k.startswith("_")]
