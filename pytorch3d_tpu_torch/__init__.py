"""pytorch3d_tpu_torch — the PyTorch/CUDA port of pytorch3d_tpu.

The package mirrors the module paths of the JAX package `pytorch3d_tpu`
(for example `renderer/mesh/rasterize_meshes.py` here is the counterpart of
the same path there) and keeps its layouts: padded-first mesh storage with
validity masks, packed views as reshapes, packed face ids offset by n*F.

Plain tensor code is PyTorch.  Each Pallas kernel of the JAX package that
this port has reached is a hand-written CUDA kernel under `csrc/`, built
at first use and bound through a plain C interface (`_build.py`).  Every
constructor and entry point takes a `device` and defaults to CUDA; the CPU
is used only when the caller asks for it.
"""

__version__ = "0.1.0"
