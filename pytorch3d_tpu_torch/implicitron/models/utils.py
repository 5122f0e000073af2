"""Model helpers (port of pytorch3d_tpu/implicitron/models/utils.py):
chunked application over rays, the dataclass concatenation, input
preprocessing and the weighted sum of losses."""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Iterator

import torch

from ..tools.image_utils import mask_background


def chunk_generator(
    chunk_size: int,
    ray_bundle,
    chunked_inputs: Dict[str, Any],
    *args,
    tqdm_trigger_threshold: int = 16,
    **kwargs,
) -> Iterator:
    """Yields ([chunk of the bundle, *args], kwargs) for each chunk of
    `chunk_size` rays of every image; tensors of `chunked_inputs` with two or
    more dims are cut along their ray dim (dim 1) too."""
    B = ray_bundle.origins.shape[0]
    n_rays = int(math.prod(ray_bundle.origins.shape[1:-1]))
    S = ray_bundle.lengths.shape[-1]
    flat = {
        "origins": ray_bundle.origins.reshape(B, n_rays, 3),
        "directions": ray_bundle.directions.reshape(B, n_rays, 3),
        "lengths": ray_bundle.lengths.reshape(B, n_rays, S),
        "xys": ray_bundle.xys.reshape(B, n_rays, 2),
    }
    chunk_size = max(chunk_size, 1)
    for start in range(0, n_rays, chunk_size):
        sl = slice(start, min(start + chunk_size, n_rays))
        chunk_bundle = type(ray_bundle)(**{k: v[:, sl] for k, v in flat.items()})
        extra = {k: (v[:, sl] if isinstance(v, torch.Tensor) and v.ndim >= 2 else v) for k, v in chunked_inputs.items()}
        yield [chunk_bundle, *args], {**kwargs, **extra}


def _map_structure(fn, *xs):
    """fn over the matching leaves of dicts, lists, tuples and dataclasses."""
    first = xs[0]
    if isinstance(first, dict):
        return {k: _map_structure(fn, *(x[k] for x in xs)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_structure(fn, *parts) for parts in zip(*xs))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return type(first)(**{f.name: _map_structure(fn, *(getattr(x, f.name) for x in xs))
                              for f in dataclasses.fields(first)})
    if first is None:
        return None
    return fn(*xs)


def apply_chunked(func, chunk_generator, tensor_collator) -> Any:
    """func on each chunk, the results' leaves collated with
    `tensor_collator` (a list of a leaf's values -> one value)."""
    outs = [func(*a, **kw) for a, kw in chunk_generator]
    return _map_structure(lambda *xs: tensor_collator(list(xs)), *outs)


def cat_dataclass(batch, tensor_collator):
    """A list of dataclass instances concatenated field by field: tensors
    collated, Nones kept, other fields taken from the first."""
    out = {}
    first = batch[0]
    for f in dataclasses.fields(first):
        vals = [getattr(b, f.name) for b in batch]
        if all(v is None for v in vals):
            out[f.name] = None
        elif isinstance(vals[0], torch.Tensor):
            out[f.name] = tensor_collator(vals)
        else:
            out[f.name] = vals[0]
    return type(first)(**out)


def preprocess_input(image_rgb, fg_probability, depth_map, mask_images: bool, mask_depths: bool,
                     mask_threshold: float, bg_color):
    """The foreground mask thresholded, and the image's and the depth's
    backgrounds masked where asked (channel-last (B, H, W, C))."""
    if image_rgb is not None and image_rgb.ndim == 3:
        raise ValueError("Model received unbatched inputs. Perhaps they came from a FrameData which had not been "
                         "collated.")
    fg_mask = fg_probability
    if fg_mask is not None and mask_threshold > 0.0:
        warnings.warn("Thresholding masks!")
        fg_mask = (fg_mask >= mask_threshold).to(fg_mask.dtype)
    if mask_images and fg_mask is not None and image_rgb is not None:
        warnings.warn("Masking images!")
        image_rgb = mask_background(image_rgb, fg_mask, bg_color=bg_color)
    if mask_depths and fg_mask is not None and depth_map is not None:
        assert mask_threshold > 0.0, "Depths should be masked only with thresholded masks"
        warnings.warn("Masking depths!")
        depth_map = depth_map * fg_mask
    return image_rgb, fg_mask, depth_map


def log_loss_weights(loss_weights, logger) -> None:
    """Log a table of the loss weights."""
    logger.info("-------\nloss_weights:\n" + "\n".join(f"{k:40s}: {w:1.2e}" for k, w in loss_weights.items())
                + "-------")


def weighted_sum_losses(preds, loss_weights):
    """The losses of `preds` times their weights, summed; None (with a
    warning) where no weighted loss is present."""
    losses_weighted = [preds[k] * float(w) for k, w in loss_weights.items() if k in preds and w != 0.0]
    if len(losses_weighted) == 0:
        warnings.warn("No main objective found.")
        return None
    return sum(losses_weighted)


def load_state_dict_resized(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """`module.load_state_dict(state_dict, strict=True)` where a tensor may
    have another shape than the module's (a voxel grid after a resolution
    change): such a parameter or buffer is replaced by the new tensor (a
    new `nn.Parameter` for a parameter, so an optimizer over the old one
    must be rebuilt); the others are copied in place."""
    own = module.state_dict(keep_vars=True)
    missing, unexpected = sorted(set(own) - set(state_dict)), sorted(set(state_dict) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict keys: missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, value in state_dict.items():
            current = own[name]
            if current.shape == value.shape:
                current.copy_(value)
                continue
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if isinstance(current, torch.nn.Parameter):
                setattr(owner, attr, torch.nn.Parameter(value.detach().clone().to(current.device, current.dtype),
                                                        requires_grad=current.requires_grad))
            else:
                owner.register_buffer(attr, value.detach().clone().to(current.device, current.dtype))
