"""IDR's renderer: sphere tracing, then surface shading (port of
pytorch3d_tpu/implicitron/models/renderer/sdf_renderer.py).

The trace (`RayTracing`) is not differentiated.  Gradients enter through
the SDF at the traced points: in training a surface point moves with the
weights as t(theta) = t - (sdf(x; theta) - sdf0) / <grad sdf, d> (IDR's
implicit differentiation), and the eikonal samples (uniform draws in the
bounding box, then the traced points) return their SDF gradients in
`aux["grad_theta"]`.  Those gradients, and the normals the colouring
network takes, are `torch.autograd.grad` of the SDF with respect to the
points, with create_graph in training so that the eikonal loss and the
normals reach the weights (the JAX module differentiates through
`jax.grad` alike); evaluation takes them without a graph.

The renderer is an `nn.Module` whose `rgb_network`
(`RayNormalColoringNetwork`, where `ray_normal_coloring_network_args` is
given) is a submodule of the model; without it the colours are the
implicit function's feature channels.  The eikonal draws come from
`generator`, or are handed in (`eikonal_points`).  Misses take the
background colour and a soft mask sigmoid(-soft_mask_alpha * sdf).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ....common import DEFAULT_DEVICE
from ...tools.config import expand_args_fields, registry
from .base import BaseRenderer, EvaluationMode, ImplicitronRayBundle, RendererOutput
from .ray_tracing import RayTracing
from .rgb_net import RayNormalColoringNetwork

Device = Union[str, torch.device]
Traced = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def sdf_gradient(fn, points: torch.Tensor, create_graph: bool) -> torch.Tensor:
    """d sdf / d points of implicit function `fn` (its channel 0) at
    `points` (..., 3).  Where the points carry a graph (training's surface
    points) it stays; with create_graph the result is differentiable with
    respect to the weights."""
    with torch.enable_grad():
        p = points if points.requires_grad else points.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(fn(p)[..., 0].sum(), p, create_graph=create_graph)
    return grad


@registry.register
class SignedDistanceFunctionRenderer(BaseRenderer, nn.Module):
    render_features_dimensions: int = 3
    object_bounding_sphere: float = 1.0
    ray_tracer_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ray_normal_coloring_network_args: Optional[Dict[str, Any]] = None
    bg_color: tuple = (0.0,)
    soft_mask_alpha: float = 50.0
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    __call__ = nn.Module.__call__  # BaseRenderer's raising __call__ would shadow the module's

    def __post_init__(self):
        args = dict(self.ray_tracer_args)
        args.setdefault("object_bounding_sphere", self.object_bounding_sphere)
        self._ray_tracer = RayTracing(**args)
        self.rgb_network = (
            RayNormalColoringNetwork(**self.ray_normal_coloring_network_args, device=self.device,
                                     generator=self.generator)
            if self.ray_normal_coloring_network_args is not None else None)
        self.generator = None  # used once; a module keeps no generator

    def requires_object_mask(self) -> bool:
        return True

    def trace(self, fn, origins: torch.Tensor, object_mask: torch.Tensor, directions: torch.Tensor) -> Traced:
        """The ray tracer on fn's SDF: (points (B*R, 3), hit (B*R,), depths (B*R,))."""
        return self._ray_tracer(lambda p: fn(p)[..., 0], origins, object_mask, directions)

    def forward(
        self,
        ray_bundle: ImplicitronRayBundle,
        implicit_functions: List = (),
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        object_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        eikonal_points: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> RendererOutput:
        """object_mask (B, ...) of the rays (> 0.5: on the object; all rays
        where None) confines training's surface to it.  eikonal_points
        (B*R // 2, 3): the eikonal draws, uniform in the bounding box, drawn
        from `generator` where not given."""
        if not implicit_functions:
            raise ValueError("SDF renderer expects an implicit function")
        fn = implicit_functions[0]
        B = ray_bundle.origins.shape[0]
        spatial = tuple(ray_bundle.origins.shape[1:-1])
        origins = ray_bundle.origins.reshape(B, -1, 3)
        dirs = ray_bundle.directions.reshape(B, -1, 3)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
        R = origins.shape[1]
        if object_mask is None:
            object_mask = torch.ones((B, R), dtype=torch.bool, device=origins.device)
        else:
            object_mask = object_mask.reshape(B, R) > 0.5

        points, net_mask, dists = self.trace(fn, origins, object_mask, dirs)
        dirs_flat, cam_flat, mask_flat = dirs.reshape(-1, 3), origins.reshape(-1, 3), object_mask.reshape(-1)
        sdf_output = fn(points)[..., 0:1]  # (B*R, 1) with the weights' gradients
        training = evaluation_mode == EvaluationMode.TRAINING
        aux: Dict[str, Any] = {}
        if training:
            surface_mask = net_mask & mask_flat
            g_surf = sdf_gradient(fn, points, create_graph=False)
            dot = (g_surf * dirs_flat).sum(dim=-1, keepdim=True)
            denom = dot.abs().clamp(min=1e-4) * torch.where(dot >= 0.0, 1.0, -1.0)
            dists_theta = dists[:, None] - (sdf_output - sdf_output.detach()) / denom
            pts_use = torch.where(surface_mask[:, None], cam_flat + dists_theta * dirs_flat, points)
            if eikonal_points is None:
                r = self.object_bounding_sphere
                eikonal_points = torch.rand((max(points.shape[0] // 2, 1), 3), generator=generator,
                                            dtype=points.dtype, device=points.device) * (2 * r) - r
            aux["grad_theta"] = sdf_gradient(fn, torch.cat([eikonal_points, points]), create_graph=True)
        else:
            surface_mask = net_mask
            pts_use = points

        out = fn(pts_use)  # (B*R, 1 + C)
        if self.rgb_network is not None:
            normals = sdf_gradient(fn, pts_use, create_graph=training)
            features = self.rgb_network(out[..., 1:], pts_use, normals, dirs_flat)
        else:
            features = out[..., 1:]
        features = features[..., : self.render_features_dimensions]
        bg = torch.as_tensor(self.bg_color, dtype=features.dtype, device=features.device).expand(
            self.render_features_dimensions)
        features = torch.where(surface_mask[:, None], features, bg)
        mask = torch.where(surface_mask[:, None], 1.0, torch.sigmoid(-self.soft_mask_alpha * sdf_output))
        return RendererOutput(
            features=features.reshape(B, *spatial, -1),
            depths=dists.reshape(B, *spatial, 1),
            masks=mask.reshape(B, *spatial, 1),
            aux=aux,
        )


expand_args_fields(SignedDistanceFunctionRenderer)
