"""Global / autodecoder encoders (port of
pytorch3d_tpu/implicitron/models/global_encoder)."""
from .autodecoder import Autodecoder
from .global_encoder import GlobalEncoderBase, HarmonicTimeEncoder, SequenceAutodecoder

__all__ = [k for k in dir() if not k.startswith("_")]
