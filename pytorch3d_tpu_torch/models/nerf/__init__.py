"""NeRF model family: raysamplers, the field MLP, the raymarcher and the
renderer (port of pytorch3d_tpu/models/nerf)."""
from .implicit_function import MLPWithInputSkips, NeuralRadianceField
from .nerf_renderer import RadianceFieldRenderer
from .raymarcher import EmissionAbsorptionNeRFRaymarcher
from .raysampler import NeRFRaysampler, ProbabilisticRaysampler
from .utils import calc_mse, calc_psnr, sample_images_at_mc_locs

__all__ = [k for k in dir() if not k.startswith("_")]
