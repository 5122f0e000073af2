"""The multi-pass emission-absorption renderer (port of
pytorch3d_tpu/implicitron/models/renderer/multipass_ea.py): a coarse pass,
then for each further implicit function an importance refine of the
coarse bundle on the previous pass's detached weights and a fine pass."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ...tools.config import registry
from .base import BaseRenderer, EvaluationMode, ImplicitronRayBundle, RendererOutput
from .ray_point_refiner import RayPointRefiner
from .raymarcher import RaymarcherBase


@registry.register
@dataclasses.dataclass
class MultiPassEmissionAbsorptionRenderer(BaseRenderer):
    """Coarse pass, importance refine, fine pass(es); each pass's output
    holds the one before it in `prev_stage`."""

    n_pts_per_ray_fine_training: int = 64
    n_pts_per_ray_fine_evaluation: int = 64
    stratified_sampling_coarse_training: bool = True
    stratified_sampling_coarse_evaluation: bool = False
    append_coarse_samples_to_fine: bool = True
    density_noise_std_train: float = 0.0
    return_weights: bool = False
    raymarcher_class_type: str = "EmissionAbsorptionRaymarcher"
    raymarcher_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    blurpool_weights: bool = False
    sample_pdf_eps: float = 1e-5

    def __post_init__(self):
        self._refiners = {
            EvaluationMode.TRAINING: RayPointRefiner(
                n_pts_per_ray=self.n_pts_per_ray_fine_training,
                random_sampling=self.stratified_sampling_coarse_training,
                add_input_samples=self.append_coarse_samples_to_fine,
            ),
            EvaluationMode.EVALUATION: RayPointRefiner(
                n_pts_per_ray=self.n_pts_per_ray_fine_evaluation,
                random_sampling=self.stratified_sampling_coarse_evaluation,
                add_input_samples=self.append_coarse_samples_to_fine,
            ),
        }
        self._raymarcher = registry.get(RaymarcherBase, self.raymarcher_class_type)(**self.raymarcher_args)

    def __call__(
        self,
        ray_bundle: ImplicitronRayBundle,
        implicit_functions: List = (),
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        generator: Optional[torch.Generator] = None,
        u_pdf: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> RendererOutput:
        """`u_pdf` (..., n_pts_per_ray_fine) are the refine's quantiles when
        it samples at random; drawn from `generator` where not given.  Every
        fine pass refines the coarse bundle with the same quantiles."""
        if not implicit_functions:
            raise ValueError("EA renderer expects implicit functions")
        density_noise_std = self.density_noise_std_train if evaluation_mode == EvaluationMode.TRAINING else 0.0
        fn_kwargs = {k: kwargs[k] for k in ("fun_viewpool", "camera", "global_code") if kwargs.get(k) is not None}

        def render_pass(fn, bundle):
            densities, features = fn(ray_bundle=bundle, density_noise_std=density_noise_std, **fn_kwargs)
            return self._raymarcher(densities, features, aux={}, ray_lengths=bundle.lengths,
                                    density_noise_std=density_noise_std)

        output = render_pass(implicit_functions[0], ray_bundle)
        weights = output.weights
        if self.return_weights:
            output.aux["weights"] = weights

        refiner = self._refiners[evaluation_mode]
        if len(implicit_functions) > 1 and refiner.random_sampling and u_pdf is None:
            lengths = ray_bundle.lengths
            u_pdf = torch.rand(lengths.shape[:-1] + (refiner.n_pts_per_ray,), generator=generator,
                               dtype=lengths.dtype, device=lengths.device)
        prev = output
        for fn in implicit_functions[1:]:
            refined = refiner(ray_bundle, weights.detach(), blurpool_weights=self.blurpool_weights,
                              sample_pdf_eps=self.sample_pdf_eps, u=u_pdf)
            cur = render_pass(fn, refined)
            cur.prev_stage = prev
            weights = cur.weights
            prev = cur
        return prev
