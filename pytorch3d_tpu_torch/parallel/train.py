"""The NeRF training step (port of pytorch3d_tpu/parallel/train.py), on one
device: the sharded step over a mesh of cards waits for the port's parallel
slice."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def make_nerf_train_step(model, optimizer, mesh=None, compute_dtype=None) -> Callable:
    """step(cameras, image, generator=None, draws=None) -> metrics.

    The step renders a Monte-Carlo ray batch with `model`
    (a RadianceFieldRenderer), takes loss = mse_coarse + mse_fine against
    `image`, runs the backward and one `optimizer` step.  The metrics (mse and
    psnr of both passes, and the loss) come back detached.  `draws` hands in
    the call's random numbers (`RadianceFieldRenderer.make_draws`)."""
    if mesh is not None:
        raise NotImplementedError("a mesh of devices waits for the port's parallel slice")
    if compute_dtype is not None:
        raise NotImplementedError("mixed precision (compute_dtype) waits for a later slice of the port")

    def step(cameras, image: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        _, metrics = model(cameras, image=image, training=True, generator=generator, draws=draws)
        loss = metrics["mse_coarse"] + metrics["mse_fine"]
        loss.backward()
        optimizer.step()
        return {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}

    return step
