"""Harmonic (positional) embedding (port of
pytorch3d_tpu/renderer/implicit/harmonic_embedding.py), with the
integrated embedding of mip-NeRF: given the diagonal of each point's
covariance, every sine and cosine of frequency f is damped by
exp(-f^2 var / 2), its expectation under that Gaussian.
"""

from __future__ import annotations

from typing import Optional

import torch


class HarmonicEmbedding:
    """[sin(f x), cos(f x)] for frequencies f = omega_0 * 2^i (or linearly
    spaced), with the input appended."""

    def __init__(
        self,
        n_harmonic_functions: int = 6,
        omega_0: float = 1.0,
        logspace: bool = True,
        append_input: bool = True,
    ) -> None:
        if logspace:
            frequencies = 2.0 ** torch.arange(n_harmonic_functions, dtype=torch.float32)
        else:
            frequencies = torch.linspace(1.0, 2.0 ** (n_harmonic_functions - 1), n_harmonic_functions)
        self._frequencies = frequencies * omega_0
        self._on_device = {}  # (device, dtype) -> the frequencies there, copied once
        self.append_input = append_input
        self.n_harmonic_functions = n_harmonic_functions

    def _frequencies_like(self, x: torch.Tensor) -> torch.Tensor:
        key = (x.device, x.dtype)
        if key not in self._on_device:
            self._on_device[key] = self._frequencies.to(x.device, x.dtype)
        return self._on_device[key]

    def __call__(self, x: torch.Tensor, diag_cov: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., D) -> (..., D * 2 * n_harmonic_functions [+ D]); with
        `diag_cov` (..., D), the variances of x, the integrated embedding."""
        freqs = self._frequencies_like(x)
        embed = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
        parts = [torch.sin(embed), torch.cos(embed)]
        if diag_cov is not None:
            atten = torch.exp(-0.5 * (diag_cov[..., None] * freqs**2).reshape(*x.shape[:-1], -1))
            parts = [p * atten for p in parts]
        if self.append_input:
            parts.append(x)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def get_output_dim_static(input_dims: int, n_harmonic_functions: int, append_input: bool) -> int:
        return input_dims * (2 * n_harmonic_functions + int(append_input))

    def get_output_dim(self, input_dims: int = 3) -> int:
        return self.get_output_dim_static(input_dims, self.n_harmonic_functions, self.append_input)
