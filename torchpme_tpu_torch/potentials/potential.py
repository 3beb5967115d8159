"""Base interface for range-separated pair potentials between monopoles.

Counterpart of :mod:`torchpme_tpu.potentials.potential`.  Potentials are
``nn.Module``s holding their scalars (``smearing``, ``prefactor``) as plain
Python floats: the port's slice serves MD steps with fixed parameters, so
nothing here is trainable.  The smooth exclusion window of the JAX package
is not ported; ``exclusion_radius`` must be ``None``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Potential"]


class Potential(nn.Module):
    r"""Abstract range-separated pair potential, :math:`V(r) = V_{SR}(r) + V_{LR}(r)`.

    :param smearing: length scale of the SR/LR switching (``None`` disables
        range separation).
    :param exclusion_radius: must be ``None`` (the exclusion window belongs
        to a later slice of the port).
    :param prefactor: global prefactor, e.g. an electrostatics unit constant
        (see :mod:`torchpme_tpu_torch.prefactors`).
    """

    def __init__(
        self,
        smearing: float | None = None,
        exclusion_radius: float | None = None,
        prefactor: float = 1.0,
    ):
        super().__init__()
        if exclusion_radius is not None:
            raise ValueError(
                "`exclusion_radius` is not supported by the torch port yet; "
                "pass None"
            )
        if smearing is not None and float(smearing) <= 0:
            raise ValueError(f"`smearing` is {smearing} but must be positive")
        self.smearing = None if smearing is None else float(smearing)
        self.exclusion_radius = None
        self.prefactor = float(prefactor)

    def extra_repr(self) -> str:
        return f"smearing={self.smearing}, prefactor={self.prefactor}"

    def from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        """Full pair potential :math:`V(r)` at the given distances."""
        raise NotImplementedError(
            f"from_dist is not implemented for {type(self).__name__}"
        )

    def lr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        r"""Long-range part :math:`V_{LR}(r)` in real space."""
        raise NotImplementedError(
            f"lr_from_dist is not implemented for {type(self).__name__}"
        )

    def sr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        r"""Short-range part :math:`V_{SR}(r) = V(r) - V_{LR}(r)`."""
        if self.smearing is None:
            raise ValueError(
                "Cannot compute range-separated potential when `smearing` is "
                "not specified."
            )
        return self.from_dist(dist) - self.lr_from_dist(dist)

    def lr_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        r"""Fourier transform :math:`\hat V_{LR}` as a function of :math:`k^2`."""
        raise NotImplementedError(
            f"lr_from_k_sq is not implemented for {type(self).__name__}"
        )

    def kernel_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        """K-space-kernel protocol: a potential can drive a
        :class:`~torchpme_tpu_torch.ops.kspace.KSpaceFilter`."""
        return self.lr_from_k_sq(k_sq)

    def self_contribution(self) -> float:
        """Potential a particle's own screening density generates at its
        position; always subtracted from k-space sums."""
        raise NotImplementedError(
            f"self_contribution is not implemented for {type(self).__name__}"
        )

    def background_correction(self) -> float:
        """Neutralizing-background term compensating a non-neutral cell."""
        raise NotImplementedError(
            f"background_correction is not implemented for {type(self).__name__}"
        )

    def pbc_correction(self, periodic, positions, cell, charges) -> torch.Tensor:
        """Correction for 2D (slab) periodicity; zero by default."""
        return self.prefactor * torch.zeros_like(charges)
