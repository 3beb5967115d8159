"""Minimax-ish polynomial fits of the dipolar window scalars.

Counterpart of :mod:`torchpme_tpu.ops.polyfit` (numpy + scipy only; the
coefficients equal the JAX package's bit for bit).  The JAX package's fused
TPU window replaces the SR pair math's transcendentals (``erfc``, ``exp``)
with Chebyshev polynomials because its TPU compiler lowers no ``erfc``: the
target functions are *entire*, so a Chebyshev least-squares fit on the full
``[0, cutoff]`` pair-distance domain converges fast (degree 14–18 reaches
~2e-7 absolute, below float32 roundoff) and needs no domain guard.
Evaluation uses the Clenshaw recurrence *in the Chebyshev basis*: the
power-basis (Horner) conversion is ill-conditioned in float32 beyond degree
~20.  Coefficients are computed in float64 and kept as float32 constants.

On the card the window kernel (``csrc/window_dipole.cu``) evaluates
``expf`` and the A&S erfc rational directly
(:meth:`~torchpme_tpu_torch.potentials.PotentialDipole.window_scalar_math_sq`),
one transcendental instead of three degree-14–18 recurrences per pair; the
fits stay as the port of
:meth:`~torchpme_tpu_torch.potentials.PotentialDipole.window_scalar_math`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "clenshaw",
    "dipole_window_scalar_math",
    "fit_f32_cheb",
]


def fit_f32_cheb(fn, lo, hi, tol=4e-7, max_degree=24):
    """Chebyshev coefficients of a fit of ``fn`` on ``[lo, hi]``.

    Fits in the normalized variable ``u = 2(r - lo)/(hi - lo) - 1`` by
    Chebyshev least squares in f64 and verifies the **f32 Clenshaw**
    evaluation (the exact arithmetic the kernel performs) against f64 ground
    truth on a dense grid.  Returns the f32 coefficient array (degree order,
    ``T_0`` first) of the lowest degree whose verified error is ``< tol``,
    or ``None`` if no degree up to ``max_degree`` reaches it — callers keep
    the transcendental path.
    """
    lo, hi = float(lo), float(hi)
    r = np.linspace(lo, hi, 8001)
    u = 2.0 * (r - lo) / (hi - lo) - 1.0
    y = np.asarray(fn(r), np.float64)
    uf = u.astype(np.float32)
    for deg in range(4, max_degree + 1):
        c = np.polynomial.chebyshev.chebfit(u, y, deg).astype(np.float32)
        err = np.max(np.abs(_clenshaw_f32(c, uf).astype(np.float64) - y))
        if err < tol:
            return c
    return None


def _clenshaw_f32(coeffs, u):
    """Reference f32 Clenshaw used by the fit verification (numpy)."""
    b1 = np.zeros_like(u)
    b2 = np.zeros_like(u)
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = (2 * u * b1 - b2 + coeffs[k]).astype(np.float32), b1
    return u * b1 - b2 + coeffs[0]


def clenshaw(coeffs, u):
    """Evaluate Chebyshev-basis ``coeffs`` (``T_0`` first) at ``u`` by the
    Clenshaw recurrence — two fused multiply-adds per degree, numerically
    stable in f32 at any practical degree; works on numpy arrays and
    torch tensors alike."""
    b1 = u * 0.0
    b2 = b1
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = 2 * u * b1 - b2 + coeffs[k], b1
    return u * b1 - b2 + coeffs[0]


def dipole_window_scalar_math(prefactor, smearing, cutoff):
    r"""Kernel ``(B, C, C')`` scalars for the short-range dipolar kernel.

    The SR dipolar scalars (:meth:`PotentialDipole.sr_scalar_kernels` /
    ``sr_scalar_kernel_derivative``) diverge at :math:`r \to 0` like the
    full kernel, but their *numerators* are entire — with
    :math:`\alpha = 1/(2\sigma^2)`, :math:`g = 2\sqrt{\alpha/\pi}\,
    e^{-\alpha r^2}`:

    .. math::
        B &= P\,f_B/r^3,  &f_B &= \mathrm{erfc}(\sqrt\alpha\,r) + g\,r,\\
        C &= P\,f_C/r^5,  &f_C &= 3\,\mathrm{erfc}(\sqrt\alpha\,r)
                                   + g\,(2\alpha r^3 + 3r),\\
        C' &= -P\,f_{C'}/r^6, &f_{C'} &= 15 f_B + g\,(4\alpha^2 r^5
                                   + 10\alpha r^3),

    so the same Chebyshev/Clenshaw treatment as the scalar family applies:
    fit the three entire numerators on the full ``[0, cutoff]`` domain (no
    domain guard needed — the masked placeholder ``d = 1`` lives inside)
    and divide by the power of ``d`` in the kernel.  The fit tolerance is
    scaled by each numerator's magnitude (f32 Clenshaw arithmetic cannot
    beat relative roundoff).  Returns a ``d -> (B, C, C')`` callable for
    the window pair math, or ``None`` when a fit cannot reach
    tolerance.
    """
    from scipy import special as _sps

    prefactor = float(prefactor)
    smearing = float(smearing)
    cutoff = float(cutoff)
    alpha = 1.0 / (2.0 * smearing**2)
    sa = alpha**0.5
    c_g = 2.0 * (alpha / np.pi) ** 0.5

    def f_b(r):
        return _sps.erfc(sa * r) + c_g * r * np.exp(-alpha * r**2)

    def f_c(r):
        return 3.0 * _sps.erfc(sa * r) + c_g * np.exp(-alpha * r**2) * (
            2.0 * alpha * r**3 + 3.0 * r
        )

    def f_cp(r):
        return 15.0 * f_b(r) + c_g * np.exp(-alpha * r**2) * (
            4.0 * alpha**2 * r**5 + 10.0 * alpha * r**3
        )

    grid = np.linspace(0.0, cutoff, 2001)
    coeffs = []
    for fn in (f_b, f_c, f_cp):
        tol = 4e-7 * max(1.0, float(np.max(np.abs(fn(grid)))))
        c = fit_f32_cheb(fn, 0.0, cutoff, tol=tol)
        if c is None:
            return None
        coeffs.append(c)
    c_b, c_c, c_cp = coeffs
    u_scale = 2.0 / cutoff  # u = 2 d / cutoff - 1

    def scalar_math(d):
        u = u_scale * d - 1.0
        inv_d = 1.0 / d
        inv_d3 = inv_d * inv_d * inv_d
        b = prefactor * clenshaw(c_b, u) * inv_d3
        c = prefactor * clenshaw(c_c, u) * (inv_d3 * inv_d * inv_d)
        cp = -prefactor * clenshaw(c_cp, u) * (inv_d3 * inv_d3)
        return b, c, cp

    return scalar_math
