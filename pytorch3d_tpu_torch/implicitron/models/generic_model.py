"""GenericModel: Implicitron's pluggable neural-rendering pipeline (port of
pytorch3d_tpu/implicitron/models/generic_model.py): ray sampling, the
implicit function of each pass, the renderer, then the view metrics of
every pass and the weighted objective.

The components come from the registry (`raysampler_class_type`,
`renderer_class_type`, `implicit_function_class_type`, each with an
`*_args` dict), as in the JAX module.  The implicit functions are
submodules `implicit_function_{i}` (one, shared by every pass, with
`share_implicit_function_across_passes`), so the state dict mirrors the
flax variables (`convert.generic_model_state_dict_from_flax`).

Every random draw (the rays, their stratified depths, the refine's
quantiles, the SDF renderer's eikonal points) comes from a
`torch.Generator`, or is handed in through `draws` (`select`, `u_jiggle`,
`camera_ids`, `u_pdf`, `eikonal`), so a test can feed the JAX package's.
A renderer that asks for the object mask (the SDF renderer) gets the
thresholded foreground at each ray, as upstream's model samples it (the
JAX module passes none); a renderer with weights is the submodule
`_renderer`.  Functions without a `latent_dim` (the voxel grid, IDR) take
no global code, as in the JAX package.  `apply_epoch_callbacks` runs the
functions' epoch schedule (the voxel grid's) on a state dict, which
`models.utils.load_state_dict_resized` loads back.  Evaluation renders the
full grid in chunks of `chunk_size_grid` rays; the result equals the
unchunked render.

With `view_pooler_enabled`, a ResNet (`_image_feature_extractor`) extracts
feature maps from the batch's images (and masks, ones where none are
given), and every implicit function gets `fun_viewpool`: the features of
the batch's views (its source views) sampled at the points and aggregated
(`_view_pooler`), or kept per view for a function that attends over them
(NeRFormer).  Their width joins the global code's in the functions'
`latent_dim`.  `source_views` (a dict of image_rgb, camera and
fg_probability) gives the source views apart from the rendered cameras,
so a pose with no image of its own can be rendered (render_flyaround).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ...common import DEFAULT_DEVICE
from ..tools.config import expand_args_fields, registry
from ..tools.image_utils import mask_background
from .base_model import ImplicitronModelBase
from .global_encoder.global_encoder import GlobalEncoderBase
from ...renderer.utils import ndc_grid_sample
from .implicit_function.base import ImplicitFunctionBase
from .feature_extractor.resnet_feature_extractor import ResNetFeatureExtractor
from .implicit_function.idr_feature_field import IdrFeatureField  # noqa: F401 (registers)
from .implicit_function.neural_radiance_field import (  # noqa: F401 (registers)
    NeRFormerImplicitFunction,
    NeuralRadianceFieldImplicitFunction,
)
from .implicit_function.voxel_grid_implicit_function import VoxelGridImplicitFunction  # noqa: F401 (registers)
from .metrics import RegularizationMetrics, ViewMetrics
from .renderer.base import BaseRenderer, EvaluationMode, ImplicitronRayBundle, RendererOutput
from .renderer.multipass_ea import MultiPassEmissionAbsorptionRenderer  # noqa: F401 (registers)
from .renderer.ray_sampler import AdaptiveRaySampler, RaySamplerBase  # noqa: F401 (registers)
from .renderer.sdf_renderer import SignedDistanceFunctionRenderer  # noqa: F401 (registers)
from .view_pooler.view_pooler import ViewPooler

Device = Union[str, torch.device]

_RAY_DRAWS = ("select", "u_jiggle", "camera_ids")


def _default_loss_weights() -> Dict[str, float]:
    return {"loss_rgb_mse": 1.0, "loss_prev_stage_rgb_mse": 1.0}


def _build(cls, args: Optional[Dict[str, Any]], **made):
    """cls(**args) with those of `made` (device, generator, latent_dim)
    that cls has as fields."""
    expand_args_fields(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{**(args or {}), **{k: v for k, v in made.items() if k in fields}})


@registry.register
class GenericModel(ImplicitronModelBase, nn.Module):
    """Ray sampler -> implicit function(s) -> renderer -> losses."""

    render_image_width: int = 400
    render_image_height: int = 400
    num_passes: int = 2
    chunk_size_grid: int = 4096
    mask_images: bool = True
    mask_depths: bool = True
    mask_threshold: float = 0.5
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    raysampler_class_type: str = "AdaptiveRaySampler"
    raysampler_args: Optional[Dict[str, Any]] = None
    renderer_class_type: str = "MultiPassEmissionAbsorptionRenderer"
    renderer_args: Optional[Dict[str, Any]] = None
    implicit_function_class_type: str = "NeuralRadianceFieldImplicitFunction"
    implicit_function_args: Optional[Dict[str, Any]] = None
    # One implicit function for every pass, or the first pass its own class.
    share_implicit_function_across_passes: bool = False
    coarse_implicit_function_class_type: Optional[str] = None
    coarse_implicit_function_args: Optional[Dict[str, Any]] = None
    loss_weights: Optional[Dict[str, float]] = None

    view_pooler_enabled: bool = False
    image_feature_extractor_args: Optional[Dict[str, Any]] = None
    view_pooler_args: Optional[Dict[str, Any]] = None

    global_encoder_class_type: Optional[str] = None
    global_encoder_args: Optional[Dict[str, Any]] = None

    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        rs_args = dict(self.raysampler_args or {})
        rs_args.setdefault("image_width", self.render_image_width)
        rs_args.setdefault("image_height", self.render_image_height)
        self._raysampler = registry.get(RaySamplerBase, self.raysampler_class_type)(**rs_args)
        made = {"device": self.device, "generator": self.generator}
        # a renderer with weights (the SDF renderer's colouring network) is a submodule
        self._renderer = _build(registry.get(BaseRenderer, self.renderer_class_type), self.renderer_args, **made)

        # the code and the pooled features are concatenated to the embedding: the trunk's input widens by both
        latent_dim = 0
        if self.global_encoder_class_type:
            enc_cls = registry.get(GlobalEncoderBase, self.global_encoder_class_type)
            expand_args_fields(enc_cls)
            self._global_encoder = enc_cls(**(self.global_encoder_args or {}), **made)
            latent_dim += self._global_encoder.get_encoding_dim()
        if self.view_pooler_enabled:
            self._view_pooler = ViewPooler(**(self.view_pooler_args or {}))
            if not (self._needs_per_view() or self._view_pooler.has_aggregation()):
                raise ValueError("an identity aggregator's width grows with the number of source views: pair it"
                                 " with a function that attends over them (NeRFormerImplicitFunction)")
            self._image_feature_extractor = ResNetFeatureExtractor(**(self.image_feature_extractor_args or {}),
                                                                   **made)
            feat_dims = self._image_feature_extractor.get_feat_dims()
            latent_dim += (feat_dims if self._needs_per_view()
                           else self._view_pooler.get_aggregated_feature_dim(feat_dims, 0))
        latent = {"latent_dim": latent_dim} if latent_dim else {}

        def make_fn(class_type, args):
            return _build(registry.get(ImplicitFunctionBase, class_type), args, **latent, **made)

        n_made = 1 if self.share_implicit_function_across_passes else self.num_passes
        for i in range(n_made):
            if i == 0 and self.coarse_implicit_function_class_type and not self.share_implicit_function_across_passes:
                fn = make_fn(self.coarse_implicit_function_class_type, self.coarse_implicit_function_args)
            else:
                fn = make_fn(self.implicit_function_class_type, self.implicit_function_args)
            self.add_module(f"implicit_function_{i}", fn)
        self._view_metrics = ViewMetrics()
        self._reg_metrics = RegularizationMetrics()
        self.generator = None  # used once; a module keeps no generator

    def _needs_per_view(self) -> bool:
        """Whether an implicit function attends over the source views (takes
        their features without aggregation)."""
        types = [self.implicit_function_class_type, self.coarse_implicit_function_class_type]
        return any(registry.get(ImplicitFunctionBase, t).requires_pooling_without_aggregation() for t in types if t)

    @property
    def _implicit_functions(self):
        if self.share_implicit_function_across_passes:
            return [self.implicit_function_0] * self.num_passes
        return [getattr(self, f"implicit_function_{i}") for i in range(self.num_passes)]

    # Epoch-scheduled updates (voxel-grid resolution changes and the like):
    # transforms of the state dict, applied between steps.

    def epoch_subscriptions(self) -> tuple:
        """Epochs at which `apply_epoch_callbacks` must run (none for NeRF)."""
        fn = self.implicit_function_0
        return tuple(fn.subscribe_to_epochs()) if hasattr(fn, "subscribe_to_epochs") else ()

    def apply_epoch_callbacks(self, state_dict: Dict[str, torch.Tensor], epoch: int):
        """(new state dict, params_changed): each implicit function's entries
        passed through its `apply_epoch`; when params_changed the caller
        rebuilds the optimizer.  NeRF's functions have none: the state dict
        comes back as it is."""
        fn = self.implicit_function_0
        if not hasattr(fn, "apply_epoch"):
            return state_dict, False
        out, changed = dict(state_dict), False
        for i in range(1 if self.share_implicit_function_across_passes else self.num_passes):
            prefix = f"implicit_function_{i}."
            sub = {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}
            if not sub:
                continue
            new_sub, ch = fn.apply_epoch(sub, epoch)
            out = {k: v for k, v in out.items() if not k.startswith(prefix)}
            out.update({prefix + k: v for k, v in new_sub.items()})
            changed = changed or ch
        return out, changed

    def forward(
        self,
        *,
        image_rgb: Optional[torch.Tensor] = None,  # (N, H, W, 3)
        camera=None,
        fg_probability: Optional[torch.Tensor] = None,  # (N, H, W, 1)
        depth_map: Optional[torch.Tensor] = None,  # (N, H, W, 1)
        evaluation_mode: EvaluationMode = EvaluationMode.TRAINING,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, torch.Tensor]] = None,
        source_views: Optional[Dict[str, Any]] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        """preds: the render ("images_render", "depths_render",
        "masks_render", and the last pass's `RendererOutput` as
        "implicitron_render"), every loss of every pass ("loss_*",
        "loss_prev_stage_*") and the weighted "objective".  source_views:
        {"image_rgb", "camera"[, "fg_probability"]} of the views to pool
        from, where they are not the batch's own."""
        draws = draws or {}
        image_rgb, fg_probability, depth_map = self._preprocess_input(image_rgb, fg_probability, depth_map)
        mask = fg_probability[..., 0] if fg_probability is not None else None
        ray_bundle = self._raysampler(camera, evaluation_mode, mask=mask, generator=generator,
                                      **{k: draws[k] for k in _RAY_DRAWS if k in draws})

        renderer_kwargs: Dict[str, Any] = {"generator": generator}
        if "eikonal" in draws:
            renderer_kwargs["eikonal_points"] = draws["eikonal"]
        if fg_probability is not None and self._renderer.requires_object_mask():
            # the foreground at each ray, as upstream samples it for the SDF renderer
            sampled = ndc_grid_sample(fg_probability.movedim(-1, 1), ray_bundle.xys, mode="nearest")
            renderer_kwargs["object_mask"] = (sampled[:, 0] > 0.5).reshape(sampled.shape[0], -1)
        if self.view_pooler_enabled:
            if source_views is not None:
                src_image, src_mask, _ = self._preprocess_input(
                    source_views["image_rgb"], source_views.get("fg_probability"), None)
                src_camera = source_views["camera"]
            else:
                src_image, src_mask, src_camera = image_rgb, fg_probability, camera
            if src_image is not None:
                renderer_kwargs["fun_viewpool"] = self._view_pool(src_image, src_mask, src_camera)
                renderer_kwargs["camera"] = camera
        if self.global_encoder_class_type:
            renderer_kwargs["global_code"] = self._global_encoder(
                sequence_name=kwargs.get("sequence_name"), frame_timestamp=kwargs.get("frame_timestamp")
            )
        if evaluation_mode == EvaluationMode.EVALUATION and self.chunk_size_grid > 0:
            rendered = self._render_chunked(ray_bundle, evaluation_mode, renderer_kwargs, draws.get("u_pdf"))
        else:
            rendered = self._renderer(ray_bundle, implicit_functions=self._implicit_functions,
                                      evaluation_mode=evaluation_mode, u_pdf=draws.get("u_pdf"), **renderer_kwargs)

        preds: Dict[str, Any] = {
            "images_render": rendered.features,
            "depths_render": rendered.depths,
            "masks_render": rendered.masks,
            "implicitron_render": rendered,
        }
        # losses of this pass, then of each earlier one
        results: Dict[str, Any] = {}
        gt = dict(image_rgb=image_rgb, depth_map=depth_map, fg_probability=fg_probability, xys=ray_bundle.xys,
                  camera_ids=ray_bundle.camera_ids)
        self._view_metrics(results, rendered, **gt)
        stage, prefix = rendered.prev_stage, "loss_prev_stage_"
        while stage is not None:
            self._view_metrics(results, stage, keys_prefix=prefix, **gt)
            stage, prefix = stage.prev_stage, "loss_prev_stage_" + prefix[len("loss_"):]
        self._reg_metrics(results, model=self, raymarched=rendered)
        preds.update(results)

        weighted = [w * results[name] for name, w in (self.loss_weights or _default_loss_weights()).items()
                    if name in results and w != 0.0]
        preds["objective"] = sum(weighted) if weighted else rendered.features.new_zeros(())
        return preds

    def _view_pool(self, image_rgb, fg_probability, camera) -> "_ViewPool":
        """fun_viewpool over the source views: their images' feature maps
        (the masks ones where none are given, so the extractor's channels
        stay fixed) sampled from their cameras."""
        masks = fg_probability if fg_probability is not None else image_rgb.new_ones(image_rgb.shape[:-1] + (1,))
        feats = self._image_feature_extractor(image_rgb, masks=masks)
        return _ViewPool(self._view_pooler, feats, camera, self._needs_per_view())

    def _preprocess_input(self, image_rgb, fg_probability, depth_map):
        """The foreground mask thresholded, the image's background set to
        `bg_color` and the depth's to 0 (channel-last), so the losses
        supervise an object-confined field."""
        fg_mask = fg_probability
        if fg_mask is not None and self.mask_threshold > 0.0:
            fg_mask = (fg_mask >= self.mask_threshold).to(fg_mask.dtype)
        if self.mask_images and fg_mask is not None and image_rgb is not None:
            image_rgb = mask_background(image_rgb, fg_mask, bg_color=self.bg_color)
        if self.mask_depths and fg_mask is not None and depth_map is not None:
            depth_map = depth_map * fg_mask
        return image_rgb, fg_mask, depth_map

    def _render_chunked(self, ray_bundle: ImplicitronRayBundle, evaluation_mode: EvaluationMode,
                        renderer_kwargs: Dict[str, Any], u_pdf: Optional[torch.Tensor] = None) -> RendererOutput:
        """The full grid rendered `chunk_size_grid` rays of every image at a
        time; features, depths and masks put back in the grid's shape."""
        B = ray_bundle.origins.shape[0]
        spatial = tuple(ray_bundle.origins.shape[1:-1])
        n_rays = math.prod(spatial)
        flat = {k: getattr(ray_bundle, k).reshape(B, n_rays, -1) for k in ("origins", "directions", "lengths", "xys")}
        if u_pdf is not None:
            u_pdf = u_pdf.reshape(B, n_rays, -1)
        object_mask = renderer_kwargs.get("object_mask")
        parts = []
        for start in range(0, n_rays, self.chunk_size_grid):
            sl = slice(start, start + self.chunk_size_grid)
            chunk_kwargs = dict(renderer_kwargs)
            if object_mask is not None:
                chunk_kwargs["object_mask"] = object_mask[:, sl]
            out = self._renderer(
                ImplicitronRayBundle(**{k: v[:, sl] for k, v in flat.items()}),
                implicit_functions=self._implicit_functions, evaluation_mode=evaluation_mode,
                u_pdf=None if u_pdf is None else u_pdf[:, sl], **chunk_kwargs,
            )
            parts.append((out.features, out.depths, out.masks))

        def unflat(i):
            x = torch.cat([p[i] for p in parts], dim=1)
            return x.reshape(B, *spatial, x.shape[-1])

        return RendererOutput(features=unflat(0), depths=unflat(1), masks=unflat(2))


class _ViewPool:
    """fun_viewpool(points (..., 3)): the source views' features at the
    points, aggregated and concatenated by name in sorted order (..., C),
    or with `per_view` each view's (V, ..., C)."""

    def __init__(self, pooler: ViewPooler, feats: Dict[str, torch.Tensor], camera, per_view: bool) -> None:
        self.pooler, self.feats, self.camera, self.per_view = pooler, feats, camera, per_view

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        flat = pts.reshape(1, -1, 3)
        if self.per_view:
            sampled, _ = self.pooler.sample_per_view(pts=flat, camera=self.camera, feats=self.feats, masks=None)
            per = torch.cat([sampled[k] for k in sorted(sampled)], dim=-1)  # (V, P, C)
            return per.reshape((per.shape[0],) + tuple(pts.shape[:-1]) + (per.shape[-1],))
        pooled = self.pooler(pts=flat, camera=self.camera, feats=self.feats, masks=None)
        agg = torch.cat([pooled[k] for k in sorted(pooled)], dim=-1)
        return agg.reshape(tuple(pts.shape[:-1]) + (agg.shape[-1],))


expand_args_fields(GenericModel)
