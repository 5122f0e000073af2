"""Implicit functions (port of
pytorch3d_tpu/implicitron/models/implicit_function): the NeRF function so
far."""
from .base import ImplicitFunctionBase
from .neural_radiance_field import NeuralRadianceFieldImplicitFunction

__all__ = [k for k in dir() if not k.startswith("_")]
