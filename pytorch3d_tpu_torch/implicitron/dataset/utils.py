"""Dataset image, bbox and camera utilities (port of
pytorch3d_tpu/implicitron/dataset/utils.py): host numpy data preparation,
the frame-type tests, the PNG loaders, and the camera adjustments to a crop
and a resize, which return new port cameras on the input camera's device.
Images are channels-last (H, W, C) numpy arrays.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ...common import DEFAULT_DEVICE

DATASET_TYPE_TRAIN = "train"
DATASET_TYPE_TEST = "test"
DATASET_TYPE_KNOWN = "known"
DATASET_TYPE_UNKNOWN = "unseen"


def is_train_frame(frame_type) -> np.ndarray:
    if isinstance(frame_type, str):
        frame_type = [frame_type]
    return np.asarray(
        [str(t).startswith(DATASET_TYPE_TRAIN) for t in frame_type]
    )


def is_known_frame(frame_type) -> np.ndarray:
    if isinstance(frame_type, str):
        frame_type = [frame_type]
    return np.asarray(
        [str(t).endswith(DATASET_TYPE_KNOWN) for t in frame_type]
    )


def get_1d_bounds(arr: np.ndarray) -> Tuple[int, int]:
    nz = np.flatnonzero(arr)
    return int(nz[0]), int(nz[-1]) + 1


def get_bbox_from_mask(
    mask: np.ndarray, thr: float, decrease_quant: float = 0.05
) -> Tuple[int, int, int, int]:
    """xywh bbox of the mask's support, lowering thr until non-empty."""
    if mask.size == 0:
        warnings.warn("Empty mask is provided for bbox extraction.")
        return 0, 0, 1, 1
    if mask.min() < 0.0:
        warnings.warn("Negative values in the mask for bbox extraction.")
        mask = mask.clip(min=0.0)
    masks_for_box = np.zeros_like(mask)
    while masks_for_box.sum() <= 1.0:
        masks_for_box = (mask > thr).astype(np.float32)
        thr -= decrease_quant
    if thr <= 0.0:
        warnings.warn(f"Empty masks_for_bbox (thr={thr}) => using full image.")
    x0, x1 = get_1d_bounds(masks_for_box.sum(axis=0))
    y0, y1 = get_1d_bounds(masks_for_box.sum(axis=1))
    return x0, y0, x1 - x0, y1 - y0


def bbox_xyxy_to_xywh(xyxy: np.ndarray) -> np.ndarray:
    return np.concatenate([xyxy[:2], xyxy[2:] - xyxy[:2]])


def bbox_xywh_to_xyxy(
    xywh: np.ndarray, clamp_size: Optional[float] = None
) -> np.ndarray:
    wh = xywh[2:]
    if clamp_size is not None:
        wh = np.clip(wh, clamp_size, None)
    return np.concatenate([xywh[:2], xywh[:2] + wh])


def get_clamp_bbox(
    bbox: np.ndarray, box_crop_context: float = 0.0, image_path: str = ""
) -> np.ndarray:
    """Expand an xywh bbox by `box_crop_context` -> float xyxy."""
    bbox = np.asarray(bbox, np.float64).copy()
    if box_crop_context > 0.0:
        c = box_crop_context
        bbox[0] -= bbox[2] * c / 2
        bbox[1] -= bbox[3] * c / 2
        bbox[2] += bbox[2] * c
        bbox[3] += bbox[3] * c
    if (bbox[2:] <= 1.0).any():
        raise ValueError(
            f"squashed image {image_path}!! The bounding box contains no pixels."
        )
    bbox[2:] = np.clip(bbox[2:], 2, None)
    return bbox_xywh_to_xyxy(bbox, clamp_size=2)


def clamp_box_to_image_bounds_and_round(
    bbox_xyxy: np.ndarray, image_size_hw: Tuple[int, int]
) -> np.ndarray:
    out = np.asarray(bbox_xyxy, np.float64).copy()
    out[[0, 2]] = np.clip(out[[0, 2]], 0, image_size_hw[-1])
    out[[1, 3]] = np.clip(out[[1, 3]], 0, image_size_hw[-2])
    return np.round(out).astype(np.int64)


def rescale_bbox(bbox, orig_res, new_res) -> np.ndarray:
    assert bbox is not None
    assert np.prod(orig_res) > 1e-8
    rel_size = (new_res[0] / orig_res[0] + new_res[1] / orig_res[1]) / 2.0
    return np.asarray(bbox, np.float64) * rel_size


def crop_around_box(
    image: np.ndarray, bbox_xyxy: np.ndarray, impath: str = ""
) -> np.ndarray:
    """Crop (H, W, C) by int xyxy."""
    bbox = clamp_box_to_image_bounds_and_round(
        bbox_xyxy, image.shape[:2]
    )
    out = image[bbox[1] : bbox[3], bbox[0] : bbox[2]]
    assert all(c > 0 for c in out.shape), f"squashed image {impath}"
    return out


def resize_image(
    image: np.ndarray,
    image_height: Optional[int],
    image_width: Optional[int],
    mode: str = "bilinear",
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Aspect-preserving resize of (H, W, C) with zero padding to
    (image_height, image_width) through PIL's float ("F") images; returns
    (resized, scale, crop mask), the crop mask becoming FrameData.mask_crop."""
    if (
        image_height is None
        or image_width is None
        or image.shape[0] == 0
        or image.shape[1] == 0
    ):
        return image, 1.0, np.ones(image.shape[:2] + (1,), np.float32)

    from PIL import Image

    minscale = min(
        image_height / image.shape[0], image_width / image.shape[1]
    )
    new_h = max(1, int(round(minscale * image.shape[0])))
    new_w = max(1, int(round(minscale * image.shape[1])))
    resample = Image.BILINEAR if mode == "bilinear" else Image.NEAREST
    chans = []
    for c in range(image.shape[2]):
        chans.append(
            np.asarray(
                Image.fromarray(image[..., c].astype(np.float32), "F").resize(
                    (new_w, new_h), resample
                ),
                np.float32,
            )
        )
    imre = np.stack(chans, axis=-1)
    out = np.zeros((image_height, image_width, image.shape[2]), np.float32)
    out[:new_h, :new_w] = imre
    mask = np.zeros((image_height, image_width, 1), np.float32)
    mask[:new_h, :new_w] = 1.0
    return out, minscale, mask


def _convert_ndc_to_pixels(focal_length, principal_point, image_size_wh):
    half = np.asarray(image_size_wh, np.float64) / 2
    rescale = half.min()
    principal_point_px = half - np.asarray(principal_point) * rescale
    focal_length_px = np.asarray(focal_length) * rescale
    return focal_length_px, principal_point_px


def _convert_pixels_to_ndc(
    focal_length_px, principal_point_px, image_size_wh
):
    half = np.asarray(image_size_wh, np.float64) / 2
    rescale = half.min()
    principal_point = (half - np.asarray(principal_point_px)) / rescale
    focal_length = np.asarray(focal_length_px) / rescale
    return focal_length, principal_point


def _camera_with(camera, fl, pp):
    """A copy of `camera` with NDC focal length and principal point (1, 2)
    from float64 numpy, as float32 on the camera's device."""
    return camera.replace(
        focal_length=torch.as_tensor(np.asarray(fl, np.float32)[None], device=camera.device),
        principal_point=torch.as_tensor(np.asarray(pp, np.float32)[None], device=camera.device),
    )


def _camera_intrinsics(camera):
    return (
        camera.focal_length.detach().cpu().numpy()[0],
        camera.principal_point.detach().cpu().numpy()[0],
    )


def adjust_camera_to_bbox_crop(camera, image_size_wh, clamp_bbox_xywh):
    """A new camera with its focal length and principal point remapped to
    the crop window (the cameras are immutable)."""
    fl_px, pp_px = _convert_ndc_to_pixels(*_camera_intrinsics(camera), image_size_wh)
    pp_px_cropped = pp_px - np.asarray(clamp_bbox_xywh[:2], np.float64)
    fl, pp = _convert_pixels_to_ndc(fl_px, pp_px_cropped, np.asarray(clamp_bbox_xywh[2:], np.float64))
    return _camera_with(camera, fl, pp)


def adjust_camera_to_image_scale(camera, original_size_wh, new_size_wh):
    """A new camera with its intrinsics scaled for the aspect-preserving
    resize."""
    fl_px, pp_px = _convert_ndc_to_pixels(*_camera_intrinsics(camera), original_size_wh)
    new_wh = np.asarray(new_size_wh, np.float64)
    scale = (new_wh / np.asarray(original_size_wh, np.float64)).min()
    fl, pp = _convert_pixels_to_ndc(fl_px * scale, pp_px * scale, new_wh)
    return _camera_with(camera, fl, pp)


class GenericWorkaround:
    """Kept for API compatibility: upstream works around an OmegaConf and
    Generic-base dataclass problem that the plain-dict configs do not have."""


def is_known_frame_scalar(frame_type: str) -> bool:
    """Whether a single frame-type string marks a known frame."""
    return frame_type.endswith("known")


def transpose_normalize_image(image: np.ndarray) -> np.ndarray:
    """HWC uint8 -> CHW float32 in [0, 1] (channels first, as upstream's
    loaders give them; FrameData itself is channels last)."""
    im = np.atleast_3d(image).transpose((2, 0, 1))
    return im.astype(np.float32) / 255.0


def load_image(
    path: str, try_read_alpha: bool = False, pil_format: str = "RGB"
) -> np.ndarray:
    """(C, H, W) float image in [0, 1], host numpy."""
    from PIL import Image

    with Image.open(path) as pil_im:
        if try_read_alpha and pil_im.mode == "RGBA":
            im = np.array(pil_im)
        else:
            im = np.array(pil_im.convert(pil_format))
    return transpose_normalize_image(im)


def load_mask(path: str) -> np.ndarray:
    """(1, H, W) float mask in [0, 1], host numpy."""
    from PIL import Image

    with Image.open(path) as pil_im:
        mask = np.array(pil_im)
    return transpose_normalize_image(mask)


def load_16big_png_depth(depth_png: str) -> np.ndarray:
    """(H, W) float32 depth from a 16-bit PNG whose pixels are float16 bits."""
    from PIL import Image

    with Image.open(depth_png) as depth_pil:
        depth = (
            np.frombuffer(
                np.array(depth_pil, dtype=np.uint16), dtype=np.float16
            )
            .astype(np.float32)
            .reshape((depth_pil.size[1], depth_pil.size[0]))
        )
    return depth


def load_1bit_png_mask(file: str) -> np.ndarray:
    """Binary (H, W) float mask."""
    from PIL import Image

    with Image.open(file) as pil_im:
        mask = (np.array(pil_im.convert("L")) > 0.0).astype(np.float32)
    return mask


def load_depth(path: str, scale_adjustment: float) -> np.ndarray:
    """(1, H, W) float depth with scale adjustment; .png only (upstream
    also reads .exr through OpenCV, which is not a dependency)."""
    if not path.lower().endswith(".png"):
        raise ValueError('unsupported depth file name "%s"' % path)
    d = load_16big_png_depth(path) * scale_adjustment
    d[~np.isfinite(d)] = 0.0
    return d[None]


def load_depth_mask(path: str) -> np.ndarray:
    """(1, H, W) binary depth mask from a 1-bit png."""
    if not path.lower().endswith(".png"):
        raise ValueError('unsupported depth mask file name "%s"' % path)
    return load_1bit_png_mask(path)[None]


def safe_as_tensor(data, dtype, device=None):
    """None-propagating tensor conversion, on `device` (None: the card)."""
    if data is None:
        return None
    return torch.as_tensor(data, dtype=dtype, device=DEFAULT_DEVICE if device is None else device)


def load_pointcloud(pcl_path, max_points: int = 0, device=None, scores=None):
    """Load a point cloud through the pluggable IO on `device` (None: the
    card), subsampled to `max_points` where that is > 0 (by the given
    (1, P) uniform `scores`, else a fresh draw)."""
    from ...io import IO

    pcl = IO().load_pointcloud(pcl_path, device=device)
    if max_points > 0:
        pcl = pcl.subsample(max_points, scores=scores)
    return pcl


def adjust_camera_to_bbox_crop_(camera, image_size_wh, clamp_bbox_xywh):
    """Upstream's in-place variant; returns the adjusted camera (the
    cameras are immutable)."""
    return adjust_camera_to_bbox_crop(camera, image_size_wh, clamp_bbox_xywh)


def adjust_camera_to_image_scale_(camera, original_size_wh, new_size_wh):
    """Upstream's in-place variant; returns the adjusted camera."""
    return adjust_camera_to_image_scale(camera, original_size_wh, new_size_wh)
