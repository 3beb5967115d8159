"""Smoothed Coulomb 1/r potential with Gaussian range separation.

Counterpart of :mod:`torchpme_tpu.potentials.coulomb`.
"""

from __future__ import annotations

import math

import torch

from ..ops.math import coulomb_alpha, coulomb_c_gauss, det3
from .potential import Potential

__all__ = ["CoulombPotential", "erfc_f32_from_gauss", "slab_correction_1r"]

# Abramowitz & Stegun 7.1.26 constants, shared with csrc/window.cu
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def erfc_f32_from_gauss(y: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    r"""Abramowitz & Stegun 7.1.26 rational for :math:`\mathrm{erfc}(y)`,
    phrased to reuse an already-computed :math:`e^{-y^2}` factor.

    :math:`|\varepsilon| \le 1.5\times10^{-7}` absolute, below float32
    roundoff; valid for :math:`y \ge 0` (window distances always are).
    """
    a1, a2, a3, a4, a5 = _AS_A
    t = 1.0 / (1.0 + _AS_P * y)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return poly * gauss


def slab_correction_1r(periodic, positions, cell, charges) -> torch.Tensor:
    r"""Yeh–Berkowitz-style slab (2D-periodic) energy correction for 1/r.

    Active only when exactly two directions are periodic; ``periodic=None``
    (the fully periodic MD step) gives zeros.
    """
    if periodic is None:
        return torch.zeros_like(charges)
    periodic = torch.as_tensor(periodic, dtype=torch.bool, device=charges.device)
    is_2d = periodic.sum() == 2
    axis = torch.argmax(torch.where(is_2d, (~periodic).long(), 0))
    z_i = positions.index_select(1, axis.reshape(1))  # (N, 1)
    basis_len = torch.linalg.norm(cell, dim=-1)[axis]
    volume = torch.abs(det3(cell))
    charge_tot = charges.sum(dim=0)
    m_axis = (charges * z_i).sum(dim=0)
    m_axis_sq = (charges * z_i**2).sum(dim=0)
    e_slab = (4.0 * math.pi / volume) * (
        z_i * m_axis
        - 0.5 * (m_axis_sq + charge_tot * z_i**2)
        - charge_tot / 12.0 * basis_len**2
    )
    return torch.where(is_2d, e_slab, torch.zeros_like(charges))


class CoulombPotential(Potential):
    r"""Smoothed electrostatic Coulomb potential :math:`1/r`.

    The SR/LR split is the Ewald erf/erfc split of Gaussian width
    :math:`\sigma` (``smearing``); the Fourier kernel is
    :math:`4\pi e^{-\sigma^2 k^2/2}/k^2`, zero at :math:`k = 0`.

    Example
    -------
    >>> import torch
    >>> pot = CoulombPotential(smearing=1.0)
    >>> r = torch.tensor([1.0, 2.0], dtype=torch.float64)
    >>> print(bool(torch.allclose(pot.sr_from_dist(r) + pot.lr_from_dist(r),
    ...                           pot.from_dist(r))))
    True
    """

    def _alpha(self) -> float:
        return coulomb_alpha(self.smearing)

    def from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        return self.prefactor * (1.0 / torch.clamp(dist, min=1e-15))

    def lr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        if self.smearing is None:
            raise ValueError(
                "Cannot compute long-range contribution without specifying `smearing`."
            )
        result = torch.special.erf(dist / self.smearing / 2.0**0.5) / torch.clamp(
            dist, min=1e-12
        )
        return self.prefactor * result

    def sr_derivative(self, dist: torch.Tensor, sr_values: torch.Tensor) -> torch.Tensor:
        r"""Analytic :math:`dV_{SR}/dr = -V_{SR}/r - p\,\tfrac{2\alpha}{\sqrt\pi}
        e^{-\alpha^2r^2}/r` from the already computed ``sr_values``."""
        alpha = self._alpha()
        gauss = torch.exp(-((alpha * dist) ** 2))
        c = coulomb_c_gauss(self.prefactor, self.smearing)
        return -sr_values / dist - c * gauss / dist

    def sr_pair_force(
        self, dist: torch.Tensor, vq: torch.Tensor, pair_e: torch.Tensor
    ) -> torch.Tensor:
        r"""Pair-force numerator :math:`q_iq_j\,V'_{SR}(r)` from the pair
        energy ``pair_e`` = :math:`q_iq_jV_{SR}` and the masked charge
        product ``vq`` (the exact path of the window)."""
        alpha = self._alpha()
        gauss = torch.exp(-((alpha * dist) ** 2))
        c = self.prefactor * 2.0 * alpha / math.pi**0.5
        return -(pair_e + vq * (c * gauss)) / dist

    def sr_window_math(self, dist_sq: torch.Tensor):
        r"""``(V_SR(d), V_SR'(d)/d)`` as functions of :math:`d^2`: the
        float32 window math, one shared Gaussian, every divide an ``rsqrt``.
        ``csrc/window.cu`` evaluates the same expression per pair."""
        alpha = self._alpha()
        rd = torch.rsqrt(dist_sq)
        gauss = torch.exp(-(alpha * alpha) * dist_sq)
        v = self.prefactor * erfc_f32_from_gauss(alpha * (dist_sq * rd), gauss) * rd
        c = coulomb_c_gauss(self.prefactor, self.smearing)
        w = -(v + c * gauss) * (rd * rd)
        return v, w

    def lr_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        if self.smearing is None:
            raise ValueError(
                "Cannot compute long-range kernel without specifying `smearing`."
            )
        # double-where keeps the k = 0 singularity out of the backward pass
        zero = k_sq == 0
        masked = torch.where(zero, torch.ones_like(k_sq), k_sq)
        return self.prefactor * torch.where(
            zero,
            torch.zeros_like(k_sq),
            4 * math.pi * torch.exp(-0.5 * self.smearing**2 * masked) / masked,
        )

    def self_contribution(self) -> float:
        if self.smearing is None:
            raise ValueError(
                "Cannot compute self contribution without specifying `smearing`."
            )
        return self.prefactor * (2 / math.pi) ** 0.5 / self.smearing

    def background_correction(self) -> float:
        if self.smearing is None:
            raise ValueError(
                "Cannot compute background correction without specifying `smearing`."
            )
        return self.prefactor * math.pi * self.smearing**2

    def pbc_correction(self, periodic, positions, cell, charges) -> torch.Tensor:
        return self.prefactor * slab_correction_1r(periodic, positions, cell, charges)
