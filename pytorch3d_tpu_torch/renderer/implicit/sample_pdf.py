"""Inverse-CDF importance sampling along rays (port of
pytorch3d_tpu/renderer/implicit/sample_pdf.py).

`sample_pdf_with_draws` takes its uniforms as an argument, so a test can
feed it the numbers another framework drew; `sample_pdf` draws them from a
`torch.Generator` (or spaces them evenly when `det`).
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_pdf_with_draws(
    bins: torch.Tensor,  # (..., n_bins + 1) bin edges
    weights: torch.Tensor,  # (..., n_bins)
    u: torch.Tensor,  # (..., n_samples) in [0, 1]
    eps: float = 1e-5,
) -> torch.Tensor:
    """Samples (..., n_samples) at the quantiles `u` of the piecewise
    constant density `weights` over `bins`."""
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    u = u.contiguous()
    # the count of cdf entries <= u, as the JAX package counts them
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(0, cdf.shape[-1] - 1)
    above = inds.clamp(0, cdf.shape[-1] - 1)
    cdf_g0, cdf_g1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_g0, bins_g1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample depths in proportion to `weights`: evenly spaced quantiles when
    `det`, else uniforms from `generator`.  Returns (..., n_samples)."""
    shape = weights.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=weights.dtype, device=weights.device).expand(shape)
    else:
        u = torch.rand(shape, generator=generator, dtype=weights.dtype, device=weights.device)
    return sample_pdf_with_draws(bins, weights, u, eps)


def sample_pdf_python(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference's name for `sample_pdf`; with `u` (..., n_samples),
    the samples at those quantiles (`sample_pdf_with_draws`)."""
    if u is not None:
        return sample_pdf_with_draws(bins, weights, u, eps)
    return sample_pdf(bins, weights, n_samples, det, eps, generator)
