"""Edge length regularizer (port of pytorch3d_tpu/loss/mesh_edge_loss.py)."""

from __future__ import annotations

import torch

from ..common.math_utils import safe_norm


def mesh_edge_loss(meshes, target_length: float = 0.0) -> torch.Tensor:
    """Mean (per mesh, then over the batch) of (||e|| - target)^2."""
    if meshes.isempty():
        return torch.tensor(0.0, dtype=torch.float32, device=meshes.device)
    N = len(meshes)
    edges = meshes.edges_packed()  # (E, 2), -1 padded
    verts = meshes.verts_packed()
    emask = meshes.edges_packed_mask()
    edge_to_mesh = meshes.edges_packed_to_mesh_idx()
    num_edges = meshes.num_edges_per_mesh().to(verts.dtype)  # (N,)

    w = torch.where(emask, 1.0 / num_edges[edge_to_mesh.clamp(min=0)].clamp(min=1.0), 0.0)
    e = edges.clamp(min=0)
    length = safe_norm(verts[e[:, 1]] - verts[e[:, 0]], dim=1)
    loss = (length - target_length) ** 2 * w
    return torch.sum(loss) / N
