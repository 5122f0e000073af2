"""Sphere tracing of an SDF for IDR (port of
pytorch3d_tpu/implicitron/models/renderer/ray_tracing.py).

As in the JAX module, fixed-count loops run over every ray of the batch
(inactive rays carry through unchanged), with no compaction of the rays:
1. start and end tracers march inward from the bounding sphere's
   intersections, each frozen once its SDF falls below `sdf_threshold` or
   the two cross; a tracer that overshoots inside backs off;
2. a ray the tracers resolved hits where t_start < t_end;
3. a ray whose start tracer is still marching after `sphere_tracing_iters`
   (grazing rays) is sampled densely, `n_steps` points over its remaining
   span [t_start, t_end]; the first non-positive sample marks the crossing;
4. `n_secant_steps` secant steps refine it on the bracketing pair;
5. a ray that misses returns the point of minimal SDF: over the tight
   span for sampled rays, over the sphere's chord for the others.
Sample depths follow jnp.linspace's rule (`raysampling._linspace`), as the
JAX package's do.  The trace is not differentiated (it runs under
no_grad).  Three behaviours of the JAX module are kept on purpose (ROADMAP,
"Known faults of the reference"): the masks after the loop are a step
stale, `object_mask` is unused, and the chord's sweep runs in evaluation
too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ....renderer.implicit.raysampling import _linspace
from ...tools.config import Configurable


def _fractions(n: int, like: torch.Tensor) -> torch.Tensor:
    """jnp.linspace(0, 1, n): i / (n - 1), and 1 last."""
    zero, one = like.new_zeros(()), like.new_ones(())
    return _linspace(zero, one, n, like)


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[:, None])[:, 0]


@dataclasses.dataclass
class RayTracing(Configurable):
    object_bounding_sphere: float = 1.0
    sdf_threshold: float = 5.0e-5
    line_search_step: float = 0.5
    line_step_iters: int = 1
    sphere_tracing_iters: int = 10
    n_steps: int = 100
    n_secant_steps: int = 8

    def __call__(
        self,
        sdf: Callable[[torch.Tensor], torch.Tensor],  # (M, 3) -> (M,)
        cam_loc: torch.Tensor,  # (B, R, 3) ray origins
        object_mask: torch.Tensor,  # (B, R) bool
        ray_directions: torch.Tensor,  # (B, R, 3) unit
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(points (B*R, 3), network_object_mask (B*R,), dists (B*R,))."""
        with torch.no_grad():
            return self._trace(sdf, cam_loc.reshape(-1, 3), ray_directions.reshape(-1, 3))

    def _trace(self, sdf, o, d):
        M = o.shape[0]
        b = (o * d).sum(dim=-1)
        c = (o * o).sum(dim=-1) - self.object_bounding_sphere**2
        disc = b * b - c
        hit_sphere = disc > 0
        sq = torch.sqrt(disc.clamp(min=0.0))
        t_near = (-b - sq).clamp(min=0.0)
        t_far = (-b + sq).clamp(min=0.0)

        def eval_sdf(t):
            return sdf(o + t[:, None] * d)

        # two-sided sphere tracing with overshoot backtracking
        t_s, t_e, unf_s, unf_e = t_near, t_far, hit_sphere, hit_sphere
        for _ in range(self.sphere_tracing_iters):
            v_s, v_e = eval_sdf(t_s), eval_sdf(t_e)
            unf_s = unf_s & (v_s > self.sdf_threshold)
            unf_e = unf_e & (v_e > self.sdf_threshold)
            step_s = torch.where(unf_s, v_s, 0.0)
            step_e = torch.where(unf_e, v_e, 0.0)
            t_s_new, t_e_new = t_s + step_s, t_e - step_e
            for k in range(self.line_step_iters):
                v_s_new, v_e_new = eval_sdf(t_s_new), eval_sdf(t_e_new)
                back = (1.0 - self.line_search_step) / (2.0**k)
                t_s_new = torch.where(unf_s & (v_s_new < 0.0), t_s_new - back * step_s, t_s_new)
                t_e_new = torch.where(unf_e & (v_e_new < 0.0), t_e_new + back * step_e, t_e_new)
            alive = t_s_new < t_e_new
            t_s, t_e, unf_s, unf_e = t_s_new, t_e_new, unf_s & alive, unf_e & alive
        tracer_hit = t_s < t_e
        sampler_mask = unf_s

        # dense sampling of the remaining span of every ray (used where sampler_mask)
        frac = _fractions(self.n_steps, t_s)
        ts = t_s[:, None] + (t_e - t_s).clamp(min=0.0)[:, None] * frac
        vals = sdf((o[:, None] + ts[..., None] * d[:, None]).reshape(-1, 3)).reshape(M, self.n_steps)
        neg = vals <= 0
        any_cross = neg.any(dim=-1)
        first = neg.to(torch.uint8).argmax(dim=-1)
        lo_idx = (first - 1).clamp(min=0)
        t_lo, t_hi = _pick(ts, lo_idx), _pick(ts, first)
        f_lo, f_hi = _pick(vals, lo_idx), _pick(vals, first)

        # secant refinement; the last estimate is the answer
        t_secant = 0.5 * (t_lo + t_hi)
        for _ in range(self.n_secant_steps):
            denom = f_hi - f_lo
            t_mid = t_lo - f_lo * (t_hi - t_lo) / torch.where(denom.abs() < 1e-12, 1.0, denom)
            f_mid = eval_sdf(t_mid)
            lo = f_mid > 0
            t_lo, f_lo = torch.where(lo, t_mid, t_lo), torch.where(lo, f_mid, f_lo)
            t_hi, f_hi = torch.where(lo, t_hi, t_mid), torch.where(lo, f_hi, f_mid)
            t_secant = t_mid
        t_secant = torch.where(first == 0, t_s, t_secant)

        # misses: the point of minimal SDF, over the tight span for sampled
        # rays and over the sphere's chord for the tracer's
        t_min_tight = _pick(ts, vals.argmin(dim=-1))
        ts_wide = t_near[:, None] + (t_far - t_near).clamp(min=0.0)[:, None] * frac
        vals_wide = sdf((o[:, None] + ts_wide[..., None] * d[:, None]).reshape(-1, 3)).reshape(M, self.n_steps)
        t_min_wide = _pick(ts_wide, vals_wide.argmin(dim=-1))
        t_min = torch.where(sampler_mask, t_min_tight, t_min_wide)

        network_object_mask = hit_sphere & torch.where(sampler_mask, sampler_mask & any_cross, tracer_hit)
        t_hit = torch.where(sampler_mask, t_secant, t_s)
        t_final = torch.where(network_object_mask, t_hit, t_min)
        return o + t_final[:, None] * d, network_object_mask, t_final
