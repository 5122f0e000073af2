"""Implicit functions (port of
pytorch3d_tpu/implicitron/models/implicit_function): NeRF, NeRFormer and the
decoding functions so far."""
from .base import ImplicitFunctionBase
from .decoding_functions import DecoderFunctionBase, ElementwiseDecoder, MLPDecoder, MLPWithInputSkips
from .neural_radiance_field import NeRFormerImplicitFunction, NeuralRadianceFieldImplicitFunction

__all__ = [k for k in dir() if not k.startswith("_")]
