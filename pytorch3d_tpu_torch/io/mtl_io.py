"""MTL material IO (port of pytorch3d_tpu/io/mtl_io.py): the public names
of the MTL reader and the texture-atlas baking, which live in `obj_io.py`."""

from .obj_io import _load_mtl as load_mtl  # noqa: F401
from .obj_io import make_material_atlas  # noqa: F401
from .obj_io import make_mesh_texture_atlas  # noqa: F401
