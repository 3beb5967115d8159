"""Base interface for range-separated pair potentials between monopoles.

Counterpart of :mod:`torchpme_tpu.potentials.potential`.  Potentials are
``nn.Module``s holding their scalars (``smearing``, ``exclusion_radius``,
``prefactor``) as plain Python floats; what is trainable is a module
parameter (the weights of
:class:`~torchpme_tpu_torch.potentials.CombinedPotential`), so that autograd
reaches it through every calculator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Potential"]


class Potential(nn.Module):
    r"""Abstract range-separated pair potential, :math:`V(r) = V_{SR}(r) + V_{LR}(r)`.

    :param smearing: length scale of the SR/LR switching (``None`` disables
        range separation).
    :param exclusion_radius: if set, the potential is smoothly zeroed inside
        this local-environment radius (raised-cosine cutoff).
    :param exclusion_degree: exponent of the raised-cosine cutoff.
    :param prefactor: global prefactor, e.g. an electrostatics unit constant
        (see :mod:`torchpme_tpu_torch.prefactors`).

    Example
    -------
    The raised-cosine exclusion window is 1 at the origin, 1/2 when the
    cosine hits zero, and 0 beyond the exclusion radius:

    >>> import torch
    >>> from torchpme_tpu_torch.potentials import CoulombPotential
    >>> pot = CoulombPotential(smearing=1.0, exclusion_radius=2.0)
    >>> print(pot.f_cutoff(torch.tensor([0.0, 1.0, 2.5])))
    tensor([1.0000, 0.5000, 0.0000])
    """

    #: Optional analytic-force hook ``sr_derivative(dist, sr_values) ->
    #: dV_SR/d(dist)``; the window's exact route uses it (range-separated,
    #: no exclusion window) in place of autograd of the pair values.
    sr_derivative = None
    #: Stronger variant ``sr_pair_force(dist, vq, pair_e) -> q_iq_jV'`` in
    #: terms of the masked charge product and the pair energy; wins over
    #: :attr:`sr_derivative` where both exist.
    sr_pair_force = None
    #: float32 window hook ``sr_window_math(dist_sq) -> (V, V'/d)`` from the
    #: squared distance (one shared Gaussian, ``rsqrt`` for every divide):
    #: the pair math of kernel C and of its float32 plain version.
    sr_window_math = None

    def __init__(
        self,
        smearing: float | None = None,
        exclusion_radius: float | None = None,
        exclusion_degree: int = 1,
        prefactor: float = 1.0,
    ):
        super().__init__()
        if smearing is not None and float(smearing) <= 0:
            raise ValueError(f"`smearing` is {smearing} but must be positive")
        if exclusion_radius is not None and float(exclusion_radius) <= 0:
            raise ValueError(
                f"`exclusion_radius` is {exclusion_radius} but must be positive"
            )
        self.smearing = None if smearing is None else float(smearing)
        self.exclusion_radius = None if exclusion_radius is None else float(exclusion_radius)
        self.exclusion_degree = int(exclusion_degree)
        self.prefactor = float(prefactor)

    def extra_repr(self) -> str:
        return (
            f"smearing={self.smearing}, exclusion_radius={self.exclusion_radius}, "
            f"prefactor={self.prefactor}"
        )

    def f_cutoff(self, dist: torch.Tensor) -> torch.Tensor:
        r"""Raised-cosine cutoff :math:`1 - ((1-\cos\pi r/r_c)/2)^n` inside
        ``exclusion_radius``, zero outside."""
        if self.exclusion_radius is None:
            raise ValueError(
                "Cannot compute cutoff function when `exclusion_radius` is not set"
            )
        r_c = self.exclusion_radius
        window = 1 - ((1 - torch.cos(math.pi * (dist / r_c))) * 0.5) ** self.exclusion_degree
        return torch.where(dist < r_c, window, torch.zeros_like(dist))

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
        r"""Short-range part :math:`V_{SR}(r) = V(r) - V_{LR}(r)`; with
        ``exclusion_radius`` set, :math:`-V_{LR}(r) f_{cut}(r)`, so that the
        total potential goes smoothly to zero inside the local region."""
        if self.smearing is None:
            raise ValueError(
                "Cannot compute range-separated potential when `smearing` is "
                "not specified."
            )
        if self.exclusion_radius is None:
            return self.from_dist(dist) - self.lr_from_dist(dist)
        return -self.lr_from_dist(dist) * self.f_cutoff(dist)

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
