"""Inverse power-law potentials :math:`1/r^p` for integer exponents.

Counterpart of :mod:`torchpme_tpu.potentials.inverse_power_law`.  The
exponent selects among closed-form incomplete-gamma expressions
(:mod:`torchpme_tpu_torch.ops.math`), so it is a Python integer, checked when
the potential is built.
"""

from __future__ import annotations

import math

import torch

from ..ops.math import (
    gammainc_over_powerlaw,
    gammaincc_over_powerlaw,
    power_law_alpha_sq,
    power_law_c_gauss,
)
from .coulomb import erfc_f32_from_gauss, slab_correction_1r
from .potential import Potential

__all__ = ["InversePowerLawPotential"]


class InversePowerLawPotential(Potential):
    r"""Range-separated :math:`1/r^p` potential for integer ``p = 1..6``.

    The long-range part is :math:`P(p/2, r^2/2\sigma^2)/r^p` (regularized
    lower incomplete gamma), its Fourier transform a closed form of the
    upper incomplete gamma over a power law.  For ``p > 3`` the
    :math:`k \to 0` limit is finite and assigned exactly; for ``p ≤ 3`` the
    k = 0 value is zeroed (a uniform neutralizing background).

    Example
    -------
    >>> import torch
    >>> pot = InversePowerLawPotential(exponent=2, smearing=1.0)
    >>> print(f"{float(pot.from_dist(torch.tensor(2.0))):.4f}")  # 1/r²
    0.2500
    >>> r = torch.tensor([0.7, 1.8], dtype=torch.float64)
    >>> print(bool(torch.allclose(pot.sr_from_dist(r) + pot.lr_from_dist(r),
    ...                           pot.from_dist(r))))
    True
    """

    def __init__(
        self,
        exponent: int = 1,
        smearing: float | None = None,
        exclusion_radius: float | None = None,
        exclusion_degree: int = 1,
        prefactor: float = 1.0,
    ):
        super().__init__(smearing, exclusion_radius, exclusion_degree, prefactor)
        if int(exponent) != exponent or not 1 <= int(exponent) <= 6:
            raise ValueError(f"Unsupported exponent: {exponent}")
        self.exponent = int(exponent)

    def extra_repr(self) -> str:
        return f"exponent={self.exponent}, {super().extra_repr()}"

    def _alpha_sq(self) -> float:
        return power_law_alpha_sq(self.smearing)

    def _c_gauss(self) -> float:
        """:math:`P\\,2\\alpha^p/\\Gamma(p/2)`, the Gaussian term of
        :math:`V'_{SR}`."""
        return power_law_c_gauss(self.prefactor, self.exponent, self.smearing)

    def from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        return self.prefactor * torch.clamp(dist, min=1e-15) ** (-float(self.exponent))

    def lr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        if self.smearing is None:
            raise ValueError(
                "Cannot compute long-range contribution without specifying `smearing`."
            )
        x = torch.clamp(0.5 * dist**2 / self.smearing**2, min=1e-15)
        prefac = 1.0 / (2 * self.smearing**2) ** (self.exponent / 2)
        return self.prefactor * (prefac * gammainc_over_powerlaw(self.exponent, x))

    def sr_derivative(self, dist: torch.Tensor, sr_values: torch.Tensor) -> torch.Tensor:
        r"""Analytic :math:`dV_{SR}/dr = -p V_{SR}/r - P\,\frac{2\alpha^p}
        {\Gamma(p/2)}\,e^{-\alpha^2r^2}/r` from the computed ``sr_values``."""
        gauss = torch.exp(-self._alpha_sq() * dist**2)
        return -(self.exponent * sr_values + self._c_gauss() * gauss) / dist

    def sr_pair_force(
        self, dist: torch.Tensor, vq: torch.Tensor, pair_e: torch.Tensor
    ) -> torch.Tensor:
        r"""Pair-force numerator :math:`q_iq_jV'_{SR}` from the pair energy
        ``pair_e`` = :math:`q_iq_jV_{SR}` and the masked charge product."""
        gauss = torch.exp(-self._alpha_sq() * dist**2)
        return -(self.exponent * pair_e + vq * (self._c_gauss() * gauss)) / dist

    def sr_window_math(self, dist_sq: torch.Tensor):
        r"""``(V_SR(d), V_SR'(d)/d)`` as functions of :math:`d^2`, the float32
        window math that ``csrc/window.cu`` evaluates per pair.  With
        :math:`z = \alpha^2d^2`, :math:`V_{SR} = P\,Q(p/2, z)/d^p` and
        :math:`Q` (regularized upper incomplete gamma) elementary:
        :math:`\mathrm{erfc}(\sqrt z)` plus Gaussian terms for odd ``p`` (the
        A&S 7.1.26 erfc on the shared Gaussian), a polynomial times
        :math:`e^{-z}` for even ``p``; :math:`V'/d = -(pV + c\,e^{-z})/d^2`."""
        p = self.exponent
        alpha_sq = self._alpha_sq()
        rd = torch.rsqrt(dist_sq)
        rd2 = rd * rd
        z = alpha_sq * dist_sq
        gauss = torch.exp(-z)
        if p % 2:
            sz = alpha_sq**0.5 * (dist_sq * rd)
            erfc = erfc_f32_from_gauss(sz, gauss)
            two_rpi = 2.0 / math.pi**0.5
            if p == 1:
                q_upper = erfc
            elif p == 3:
                q_upper = erfc + two_rpi * sz * gauss
            else:
                q_upper = erfc + two_rpi * sz * (1.0 + 2.0 / 3.0 * z) * gauss
            inv_dp = rd2 ** ((p - 1) // 2) * rd
        else:
            if p == 2:
                q_upper = gauss
            elif p == 4:
                q_upper = (1.0 + z) * gauss
            else:
                q_upper = (1.0 + z * (1.0 + 0.5 * z)) * gauss
            inv_dp = rd2 ** (p // 2)
        v = self.prefactor * q_upper * inv_dp
        w = -(p * v + self._c_gauss() * gauss) * rd2
        return v, w

    def lr_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        if self.smearing is None:
            raise ValueError(
                "Cannot compute long-range kernel without specifying `smearing`."
            )
        p = self.exponent
        peff = (3 - p) / 2
        prefac = math.pi**1.5 / math.gamma(p / 2) * (2 * self.smearing**2) ** peff
        x = 0.5 * self.smearing**2 * k_sq
        zero = x == 0
        # NaN-safe backward: the k = 0 singularity never reaches the closed form
        masked = torch.where(zero, torch.ones_like(x), x)
        # p > 3: the finite k -> 0 limit; p <= 3: zeroed (neutralizing background)
        k0_limit = -prefac / peff if p > 3 else 0.0
        return self.prefactor * torch.where(
            zero, torch.full_like(x, k0_limit), prefac * gammaincc_over_powerlaw(p, masked)
        )

    def self_contribution(self) -> float:
        if self.smearing is None:
            raise ValueError(
                "Cannot compute self contribution without specifying `smearing`."
            )
        phalf = self.exponent / 2
        return self.prefactor / math.gamma(phalf + 1.0) / (2 * self.smearing**2) ** phalf

    def background_correction(self) -> float:
        # diverges at p = 3 and is not needed for p > 3 (arXiv:2412.03281 SI)
        if self.smearing is None:
            raise ValueError(
                "Cannot compute background correction without specifying `smearing`."
            )
        p = self.exponent
        if p >= 3:
            return 0.0
        prefac = math.pi**1.5 * (2 * self.smearing**2) ** ((3 - p) / 2)
        prefac /= (3 - p) * math.gamma(p / 2)
        return self.prefactor * prefac

    def pbc_correction(self, periodic, positions, cell, charges) -> torch.Tensor:
        if self.exponent == 1:
            return self.prefactor * slab_correction_1r(periodic, positions, cell, charges)
        return super().pbc_correction(periodic, positions, cell, charges)
