"""Implicitron (port of pytorch3d_tpu/implicitron): so far the tools and the
dataset pieces the NeRF trainers need."""
