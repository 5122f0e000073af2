"""NeRF datasets (port of projects/nerf/dataset.py): a Blender-synthetic
scene from a local `transforms_*.json` dump, or a sphere rendered in the
process (`RenderedMeshDatasetMapProvider`).  Frames hold (1, H, W, 3)
image tensors and the port's cameras on the given device."""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ...common import DEFAULT_DEVICE
from ...implicitron.dataset.rendered_mesh_dataset_map_provider import RenderedMeshDatasetMapProvider
from ...renderer import FoVPerspectiveCameras

Device = Union[str, torch.device]


class NeRFFrame(NamedTuple):
    image: torch.Tensor  # (1, H, W, 3)
    camera: object  # FoVPerspectiveCameras


def load_blender_dataset(
    base_dir: str, split: str = "train", image_size: Optional[int] = None, device: Device = DEFAULT_DEVICE
) -> List[NeRFFrame]:
    """A Blender-synthetic scene's split (transforms_{split}.json + PNGs),
    each image composited onto white."""
    from PIL import Image

    with open(os.path.join(base_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fov = float(np.degrees(float(meta["camera_angle_x"])))
    # OpenGL camera-to-world (columns right, up, -forward, position) to the
    # row-vector world-to-view R, T with +X left, +Y up, +Z in.
    flip = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    frames = []
    for fr in meta["frames"]:
        im = Image.open(os.path.join(base_dir, fr["file_path"] + ".png"))
        if image_size is not None:
            im = im.resize((image_size, image_size))
        im = np.asarray(im, np.float32) / 255.0
        if im.shape[-1] == 4:
            im = im[..., :3] * im[..., 3:] + (1.0 - im[..., 3:])
        c2w = np.asarray(fr["transform_matrix"], np.float32)
        R = (c2w[:3, :3] @ flip).astype(np.float32)
        T = (-c2w[:3, 3] @ R).astype(np.float32)
        cam = FoVPerspectiveCameras.create(R=torch.tensor(R)[None], T=torch.tensor(T)[None], fov=fov, device=device)
        frames.append(NeRFFrame(image=torch.tensor(im, device=device)[None], camera=cam))
    return frames


def get_nerf_datasets(
    dataset_name: str = "rendered_sphere",
    image_size: Tuple[int, int] = (64, 64),
    data_root: Optional[str] = None,
    num_views: int = 40,
    device: Device = DEFAULT_DEVICE,
):
    """(train, val, test) frame lists: a Blender scene `dataset_name` under
    `data_root`, or, for "rendered_sphere", the sphere rendered at
    image_size[0] from `num_views` views."""
    if dataset_name != "rendered_sphere" and data_root is not None:
        base = os.path.join(data_root, dataset_name)
        return tuple(load_blender_dataset(base, split, image_size[0], device) for split in ("train", "val", "test"))
    provider = RenderedMeshDatasetMapProvider(num_views=num_views, resolution=image_size[0], device=device)
    dsmap = provider.get_dataset_map()

    def conv(frames):
        return [NeRFFrame(image=f.image_rgb, camera=f.camera) for f in frames]

    return conv(dsmap["train"]), conv(dsmap["val"]), conv(dsmap["test"])
