"""Harmonic (positional) embedding (port of
pytorch3d_tpu/renderer/implicit/harmonic_embedding.py).

The integrated embedding of mip-NeRF (`diag_cov`) waits for a later slice.
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
        """x (..., D) -> (..., D * 2 * n_harmonic_functions [+ D])."""
        if diag_cov is not None:
            raise NotImplementedError("the integrated (mip-NeRF) embedding waits for a later slice of the port")
        embed = (x[..., None] * self._frequencies_like(x)).reshape(*x.shape[:-1], -1)
        parts = [torch.sin(embed), torch.cos(embed)] + ([x] if self.append_input else [])
        return torch.cat(parts, dim=-1)

    @staticmethod
    def get_output_dim_static(input_dims: int, n_harmonic_functions: int, append_input: bool) -> int:
        return input_dims * (2 * n_harmonic_functions + int(append_input))

    def get_output_dim(self, input_dims: int = 3) -> int:
        return self.get_output_dim_static(input_dims, self.n_harmonic_functions, self.append_input)
