"""Point-dipole pair interaction with Ewald range separation.

Counterpart of :mod:`torchpme_tpu.potentials.dipole`.  A standalone kernel
(not a :class:`~torchpme_tpu_torch.potentials.Potential` subclass): the
real-space terms are 3×3 tensors per pair acting on neighbor *vectors*, not
scalar functions of the distance.

The parameters are Python floats, or 0-d tensors where a caller wants their
gradient; a parameter that requires grad (and any ``exclusion_radius``)
sends the cell-list window down its plain autograd path
(:mod:`torchpme_tpu_torch.ops.rspace_cells_dipole`; on a card that path
needs ``plain=True``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .coulomb import erfc_f32_from_gauss

__all__ = ["PotentialDipole"]


def _scalar(value):
    """Python numbers become floats; tensors (trainable scalars) stay."""
    if value is None or isinstance(value, torch.Tensor):
        return value
    return float(value)


class PotentialDipole(nn.Module):
    r"""Dipole–dipole tensor kernel
    :math:`V(\vec r) = (\vec\mu_i\cdot\vec\mu_j)/r^3 -
    3(\vec\mu_i\cdot\vec r)(\vec\mu_j\cdot\vec r)/r^5`.

    :param smearing: Gaussian width of the Ewald split (``None`` = direct).
    :param exclusion_radius: optional local-environment cutoff radius.
    :param exclusion_degree: raised-cosine cutoff exponent.
    :param epsilon: dielectric constant of the embedding medium (0 =
        vacuum/"tin-foil" boundary term disabled).
    :param prefactor: global unit prefactor.

    Example
    -------
    Two parallel unit dipoles a distance 2 apart along x (so
    :math:`V = (\mu_i\cdot\mu_j)/r^3 = 1/8` for dipoles along z):

    >>> import torch
    >>> pot = PotentialDipole()
    >>> rij = torch.tensor([[2.0, 0.0, 0.0]])
    >>> K = pot.from_dist(rij)  # (1, 3, 3) tensor kernel
    >>> print(f"{float(K[0, 2, 2]):.4f}")
    0.1250
    """

    def __init__(
        self,
        smearing=None,
        exclusion_radius=None,
        exclusion_degree: int = 1,
        epsilon=0.0,
        prefactor=1.0,
    ):
        super().__init__()
        self.smearing = _scalar(smearing)
        self.exclusion_radius = _scalar(exclusion_radius)
        self.exclusion_degree = int(exclusion_degree)
        self.epsilon = _scalar(epsilon)
        self.prefactor = _scalar(prefactor)

    def extra_repr(self) -> str:
        return (
            f"smearing={self.smearing}, exclusion_radius={self.exclusion_radius}, "
            f"epsilon={self.epsilon}, prefactor={self.prefactor}"
        )

    def has_trainable_parameters(self) -> bool:
        """Whether any scalar of the potential is a tensor that requires
        grad (the fused window passes produce no parameter cotangents)."""
        return any(
            isinstance(v, torch.Tensor) and v.requires_grad
            for v in (self.smearing, self.exclusion_radius, self.epsilon, self.prefactor)
        )

    def _alpha(self):
        return 1 / (2 * self.smearing**2)

    def _f_cutoff_dist(self, dist: torch.Tensor) -> torch.Tensor:
        r_c = self.exclusion_radius
        window = 1 - ((1 - torch.cos(math.pi * (dist / r_c))) * 0.5) ** self.exclusion_degree
        return torch.where(dist < r_c, window, torch.zeros_like(dist))

    def f_cutoff(self, vector: torch.Tensor) -> torch.Tensor:
        """Raised-cosine exclusion cutoff evaluated on pair vectors, ``(P, 1)``."""
        if self.exclusion_radius is None:
            raise ValueError(
                "Cannot compute cutoff function when `exclusion_radius` is not set"
            )
        return self._f_cutoff_dist(torch.linalg.norm(vector, dim=1, keepdim=True))

    def from_dist(self, vector: torch.Tensor) -> torch.Tensor:
        """Full dipolar 3×3 tensor kernel per pair vector, shape ``(P, 3, 3)``."""
        r_mag = torch.linalg.norm(vector, dim=1, keepdim=True)
        inv_r3 = 1.0 / r_mag**3
        outer = vector[:, :, None] * vector[:, None, :]
        eye = torch.eye(3, dtype=vector.dtype, device=vector.device)
        return self.prefactor * (
            inv_r3[..., None] * eye[None] - 3.0 * outer / r_mag[..., None] ** 5
        )

    def sr_from_dist(self, vector: torch.Tensor) -> torch.Tensor:
        """Short-range tensor kernel (full minus LR, or windowed LR)."""
        if self.smearing is None:
            raise ValueError(
                "Cannot compute range-separated potential when `smearing` is "
                "not specified."
            )
        if self.exclusion_radius is None:
            return self.from_dist(vector) - self.lr_from_dist(vector)
        return -self.lr_from_dist(vector) * self.f_cutoff(vector)[..., None]

    def lr_from_dist(self, vector: torch.Tensor) -> torch.Tensor:
        r"""Long-range tensor kernel: the Ewald ``B(r) I − C(r) r⊗r`` split."""
        if self.smearing is None:
            raise ValueError(
                "Cannot compute long-range contribution without specifying `smearing`."
            )
        r_mag = torch.linalg.norm(vector, dim=1, keepdim=True)
        b_term, c_term = self._lr_scalar_kernels(r_mag)
        outer = vector[:, :, None] * vector[:, None, :]
        eye = torch.eye(3, dtype=vector.dtype, device=vector.device)
        return b_term[..., None] * eye[None] - outer * c_term[..., None]

    # -- scalar (B, C) forms -------------------------------------------------
    #
    # Every tensor kernel above is ``B(r)·I − C(r)·r⊗r``.  The cell-list
    # window (:mod:`torchpme_tpu_torch.ops.rspace_cells_dipole`) contracts
    # the dipoles with the *scalars* instead of materializing (…, 3, 3)
    # tensors per pair: ``μᵢᵀKμⱼ = B(μᵢ·μⱼ) − C(μᵢ·r)(μⱼ·r)``.

    def scalar_kernels(self, dist: torch.Tensor):
        r"""Direct-mode ``(B, C)`` with ``B = p/r³``, ``C = 3p/r⁵``."""
        inv_r2 = 1.0 / dist**2
        b = self.prefactor * inv_r2 / dist
        return b, 3.0 * b * inv_r2

    def scalar_kernel_derivative(self, dist, b, c) -> torch.Tensor:
        r"""Direct-mode :math:`dC/dr` (:math:`dB/dr = -C\,r` holds
        identically for every ``B·I − C·r⊗r`` interaction tensor that is a
        gradient field, so only ``C′`` needs a hook)."""
        del c
        return -15.0 * b / dist**3

    def window_scalar_math(self, cutoff: float):
        r"""``d -> (B, C, C')`` free of transcendentals, as the JAX package's
        fused TPU window evaluates it: the exact rationals in direct mode,
        the Chebyshev/Clenshaw fits of the entire SR numerators
        (:func:`torchpme_tpu_torch.ops.polyfit.dipole_window_scalar_math`)
        otherwise.  ``None`` for parameters that require grad, an exclusion
        window (its extra ``f(r)`` terms are not covered), or an unreachable
        fit tolerance.  ``csrc/window_dipole.cu`` does not need it (the card
        has ``expf``); it is kept as the port of the hook.
        """
        from ..ops.polyfit import dipole_window_scalar_math

        if self.exclusion_radius is not None or self.has_trainable_parameters():
            return None
        if self.smearing is None:
            prefactor = float(self.prefactor)

            def scalar_math(d):
                inv_d2 = 1.0 / (d * d)
                b = prefactor * inv_d2 / d
                c = 3.0 * b * inv_d2
                cp = -15.0 * b * inv_d2 / d
                return b, c, cp

            return scalar_math
        return dipole_window_scalar_math(
            float(self.prefactor), float(self.smearing), float(cutoff)
        )

    def sr_scalar_kernel_derivative(self, dist, b, c) -> torch.Tensor:
        r"""Short-range :math:`dC/dr` for the fused dipolar force pass.

        Substituting :math:`E = \mathrm{erfc}(\sqrt\alpha r)` out via the
        already-computed ``b`` collapses the derivative to one new ``exp``:

        .. math:: C' = -\Bigl(\frac{15\,B}{r^3}
                  + p\,g(r)\bigl(\tfrac{4\alpha^2}{r}
                  + \tfrac{10\alpha}{r^3}\bigr)\Bigr),
                  \quad g = 2\sqrt{\alpha/\pi}\,e^{-\alpha r^2}

        Valid for the pure Ewald split (``exclusion_radius`` unset).
        """
        del c
        alpha = self._alpha()
        gauss = 2 * (alpha / math.pi) ** 0.5 * torch.exp(-alpha * dist**2)
        return -(
            15.0 * b / dist**3
            + self.prefactor * gauss * (4 * alpha**2 / dist + 10 * alpha / dist**3)
        )

    def window_scalar_math_sq(self, dist_sq: torch.Tensor):
        r"""``(B(d), C(d), C'(d)/d)`` as functions of :math:`d^2`: the
        float32 dipolar window math (the dipolar analog of
        :meth:`CoulombPotential.sr_window_math`), which
        ``csrc/window_dipole.cu`` evaluates per pair.

        One shared Gaussian feeds the A&S 7.1.26 erfc, both scalars and the
        force hook; every divide is an ``rsqrt`` power of the squared
        distance.  Direct mode (``smearing=None``) is pure rationals of
        :math:`d^2`.  Valid only without an exclusion window.
        """
        rd = torch.rsqrt(dist_sq)
        rd2 = rd * rd
        if self.smearing is None:
            b = self.prefactor * rd2 * rd
            return b, 3.0 * b * rd2, -15.0 * b * (rd2 * rd2)
        alpha = self._alpha()
        gauss_raw = torch.exp(-alpha * dist_sq)
        erfc = erfc_f32_from_gauss(alpha**0.5 * (dist_sq * rd), gauss_raw)
        g = 2 * (alpha / math.pi) ** 0.5 * gauss_raw
        b = self.prefactor * (erfc * (rd2 * rd) + g * rd2)
        c = self.prefactor * (
            3.0 * erfc * (rd2 * rd2 * rd) + g * (2 * alpha + 3.0 * rd2) * rd2
        )
        cp_over_d = -(
            15.0 * b * (rd2 * rd2)
            + self.prefactor * g * (4 * alpha**2 * rd2 + 10 * alpha * (rd2 * rd2))
        )
        return b, c, cp_over_d

    def _lr_scalar_kernels(self, dist: torch.Tensor):
        alpha = self._alpha()
        r2 = dist**2
        erfc_term = torch.special.erfc(alpha**0.5 * dist)
        gauss = 2 * (alpha / math.pi) ** 0.5 * torch.exp(-alpha * r2)
        b = 1.0 / dist**3 - erfc_term / dist**3 - gauss / r2
        c = 3.0 / dist**5 - 3.0 * erfc_term / dist**5 - gauss * (2 * alpha + 3 / r2) / r2
        return self.prefactor * b, self.prefactor * c

    def sr_scalar_kernels(self, dist: torch.Tensor):
        r"""Short-range ``(B, C)`` scalars (Ewald split, or windowed LR).

        Consistent with :meth:`sr_from_dist`:
        ``sr_from_dist(v) == B(|v|)·I − C(|v|)·v⊗v`` element-wise.
        """
        if self.smearing is None:
            raise ValueError(
                "Cannot compute range-separated potential when `smearing` is "
                "not specified."
            )
        b_lr, c_lr = self._lr_scalar_kernels(dist)
        if self.exclusion_radius is None:
            b_full, c_full = self.scalar_kernels(dist)
            return b_full - b_lr, c_full - c_lr
        f = self._f_cutoff_dist(dist)
        return -b_lr * f, -c_lr * f

    def lr_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        """Same Gaussian-screened Fourier kernel as the Coulomb potential."""
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

    def self_contribution(self):
        if self.smearing is None:
            raise ValueError(
                "Cannot compute long-range contribution without specifying `smearing`."
            )
        alpha = self._alpha()
        return self.prefactor * 4 * math.pi / 3 * ((alpha / math.pi) ** 3) ** 0.5

    def background_correction(self, volume: torch.Tensor) -> torch.Tensor:
        """Dielectric surface term, 4π/(2ε+1)/V (zero for ε = 0)."""
        eps = self.epsilon
        if not isinstance(eps, torch.Tensor):
            if eps == 0.0:
                return torch.zeros_like(volume)
            return self.prefactor * 4 * math.pi / (2 * eps + 1) / volume
        safe = torch.where(eps == 0.0, torch.ones_like(eps), 2 * eps + 1)
        return torch.where(
            eps == 0.0,
            torch.zeros_like(volume),
            self.prefactor * 4 * math.pi / safe / volume,
        )
