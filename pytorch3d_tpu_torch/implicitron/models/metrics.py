"""View and regularization metrics (port of
pytorch3d_tpu/implicitron/models/metrics.py): pixel losses between a pass's
render and the ground truth sampled at the rays' NDC locations, and the
model's regularizers."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ...renderer.utils import ndc_grid_sample, ndc_grid_sample_packed
from ..tools.config import ReplaceableBase, registry


def safe_sqrt(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """sqrt(x) where x > eps^2, else eps; its gradient finite everywhere."""
    ok = x > eps * eps
    return torch.where(ok, torch.sqrt(torch.where(ok, x, torch.ones_like(x))), torch.full_like(x, eps))


def _huber(dfsq: torch.Tensor, scaling: float = 0.03) -> torch.Tensor:
    """Huber loss of squared differences."""
    loss = (safe_sqrt(dfsq, eps=1e-4) - scaling) * scaling
    return torch.where(dfsq <= scaling**2, 0.5 * dfsq, loss + 0.5 * scaling**2)


def _avg(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return x.mean()
    w = mask.expand_as(x)
    return (x * w).sum() / w.sum().clamp(min=1.0)


def _psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse.clamp(min=1e-12))


class ViewMetricsBase(ReplaceableBase):
    pass


class RegularizationMetricsBase(ReplaceableBase):
    pass


@registry.register
@dataclasses.dataclass
class ViewMetrics(ViewMetricsBase):
    """RGB mse / huber / psnr (and on the foreground), mask BCE and negative
    IoU, depth error: the render against channel-last (N, H, W, C) images
    sampled at the rays' xys, bilinear for RGB and nearest for masks and
    depths."""

    def __call__(
        self,
        results: Dict[str, Any],
        raymarched,
        image_rgb: Optional[torch.Tensor] = None,  # (N, H, W, 3)
        depth_map: Optional[torch.Tensor] = None,  # (N, H, W, 1)
        fg_probability: Optional[torch.Tensor] = None,  # (N, H, W, 1)
        xys: Optional[torch.Tensor] = None,  # (N, ..., 2) NDC ray locations
        camera_ids: Optional[torch.Tensor] = None,  # (R,) for a packed bundle
        keys_prefix: str = "loss_",
        **kwargs,
    ) -> Dict[str, Any]:
        metrics = {}

        def sample(img, mode="bilinear"):
            if img is None or xys is None:
                return None
            chan = img.movedim(-1, 1)  # (N, C, H, W)
            if camera_ids is not None:  # one source image per packed ray
                spatial = xys.shape[:-1]
                ids = camera_ids.reshape((-1,) + (1,) * (len(spatial) - 1)).expand(spatial).reshape(-1)
                out = ndc_grid_sample_packed(chan, xys.reshape(-1, 2), ids, mode=mode)  # (R, C)
                return out.reshape(*spatial, chan.shape[1])
            return ndc_grid_sample(chan, xys, mode=mode).movedim(1, -1)

        gt_rgb = sample(image_rgb)
        gt_mask = sample(fg_probability, "nearest")
        gt_depth = sample(depth_map, "nearest")
        pred_rgb, pred_mask, pred_depth = raymarched.features, raymarched.masks, raymarched.depths

        if gt_rgb is not None:
            df = pred_rgb - gt_rgb
            mse = (df * df).mean()
            metrics[keys_prefix + "rgb_mse"] = mse
            metrics[keys_prefix + "rgb_huber"] = _huber((df * df).sum(dim=-1, keepdim=True)).mean()
            metrics[keys_prefix + "rgb_psnr"] = _psnr(mse)
            if gt_mask is not None:
                metrics[keys_prefix + "rgb_mse_fg"] = _avg(df * df, gt_mask)
                metrics[keys_prefix + "rgb_psnr_fg"] = _psnr(_avg(df * df, gt_mask))
        if gt_mask is not None and pred_mask is not None:
            m = pred_mask.clamp(1e-6, 1.0 - 1e-6)
            bce = -(gt_mask * torch.log(m) + (1.0 - gt_mask) * torch.log(1.0 - m))
            metrics[keys_prefix + "mask_bce"] = bce.mean()
            inter = torch.minimum(pred_mask, gt_mask).sum()
            union = torch.maximum(pred_mask, gt_mask).sum()
            metrics[keys_prefix + "mask_neg_iou"] = -(inter / union.clamp(min=1e-6))
        if gt_depth is not None and pred_depth is not None:
            dfd = pred_depth - gt_depth
            valid = (gt_depth > 0).to(dfd.dtype)
            metrics[keys_prefix + "depth_abs"] = _avg(dfd.abs(), valid)
            if gt_mask is not None:
                metrics[keys_prefix + "depth_abs_fg"] = _avg(dfd.abs(), valid * gt_mask)
        results.update(metrics)
        return results


@registry.register
@dataclasses.dataclass
class RegularizationMetrics(RegularizationMetricsBase):
    """The negative-depth penalty and, where the renderer returns SDF
    gradients (`aux["grad_theta"]`), the eikonal term."""

    def __call__(self, results: Dict[str, Any], model=None, keys_prefix: str = "loss_", raymarched=None,
                 **kwargs) -> Dict[str, Any]:
        if raymarched is not None and raymarched.depths is not None:
            results[keys_prefix + "depth_neg_penalty"] = (raymarched.depths.clamp(max=0.0) ** 2).mean()
        grad_theta = raymarched.aux.get("grad_theta") if raymarched is not None and raymarched.aux else None
        if grad_theta is not None:
            norms = torch.sqrt((grad_theta**2).sum(dim=-1) + 1e-12)
            results[keys_prefix + "eikonal"] = ((norms - 1.0) ** 2).mean()
        return results
