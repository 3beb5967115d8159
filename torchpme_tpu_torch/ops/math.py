"""Closed-form 3×3 cell algebra and the scalar math of range-separated
potentials (counterpart of :mod:`torchpme_tpu.ops.math`).

Every cell matrix in this library is 3×3, so the inverse and determinant
are branch-free cofactor expressions: exact elementary arithmetic, fully
differentiable through autograd, and no LAPACK / cuSOLVER call on the step.

PyTorch has no exponential integral, so :func:`exp1` is written here: the
Abramowitz & Stegun rational forms in float32 (the JAX package's), and in
float64 a power series below ``x = 2`` and a continued fraction above it,
each with a fixed number of terms and no branch, so that it runs on the card
without a host round trip (the k-space filters of the 1/r³ and 1/r⁵
potentials evaluate it in float64 every call).  Its derivative
:math:`-e^{-x}/x` is its own autograd rule.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "CustomExp1",
    "det3",
    "exp1",
    "gamma",
    "gammainc_over_powerlaw",
    "gammaincc_over_powerlaw",
    "inv3",
]


def coulomb_alpha(smearing) -> float:
    r""":math:`\alpha = 1/(\sigma\sqrt2)` of the Coulomb range split."""
    return 1.0 / (smearing * 2.0**0.5)


def coulomb_c_gauss(prefactor, smearing) -> float:
    r""":math:`P\,2\alpha/\sqrt\pi`, the Gaussian term of the Coulomb
    :math:`V'_{SR}`."""
    return prefactor * (2.0 * coulomb_alpha(smearing) / math.pi**0.5)


def power_law_alpha_sq(smearing) -> float:
    r""":math:`\alpha^2 = 1/(2\sigma^2)` of the :math:`1/r^p` range split."""
    return 0.5 / smearing**2


def power_law_c_gauss(prefactor, exponent: int, smearing) -> float:
    r""":math:`P\,2\alpha^p/\Gamma(p/2)`, the Gaussian term of the
    :math:`1/r^p` :math:`V'_{SR}`."""
    alpha_sq = power_law_alpha_sq(smearing)
    return prefactor * 2.0 * alpha_sq ** (exponent / 2) / math.gamma(exponent / 2)


def inv3(cell: torch.Tensor) -> torch.Tensor:
    r"""Closed-form inverse of a 3×3 matrix (adjugate over determinant).

    Example
    -------
    >>> import torch
    >>> m = torch.tensor([[2.0, 0, 0], [1, 3, 0], [0, 1, 4]])
    >>> print(bool(torch.allclose(inv3(m) @ m, torch.eye(3), atol=1e-6)))
    True
    """
    r0, r1, r2 = cell[0], cell[1], cell[2]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.dot(r0, c0)
    return torch.stack([c0, c1, c2], dim=-1) / det


def det3(cell: torch.Tensor) -> torch.Tensor:
    """Determinant of a 3×3 matrix as the triple product ``r0·(r1×r2)``."""
    return torch.dot(cell[0], torch.linalg.cross(cell[1], cell[2]))


def gamma(x) -> torch.Tensor:
    r"""(Complete) Gamma function :math:`\Gamma(x)` for positive arguments,
    as ``exp(lgamma(x))`` (differentiable)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.float64)
    return torch.exp(torch.lgamma(x))


# -- E1 -------------------------------------------------------------------------

#: float64 E1: power-series terms below the seam, continued-fraction terms
#: above it (fixed counts: 3.3e-15 and 4.5e-16 relative at the seam, less
#: elsewhere, against a 40-digit reference)
_E1_SEAM = 2.0
_E1_SERIES_TERMS = 24
_E1_CF_TERMS = 50
# Ein(x) = Σ_{k≥1} (-1)^{k+1} x^k / (k·k!), so that E1 = Ein - γ - ln x
_E1_SERIES = tuple(
    (-1.0) ** (k + 1) / (k * math.factorial(k)) for k in range(1, _E1_SERIES_TERMS + 1)
)
_EULER_GAMMA = 0.5772156649015329


def _exp1_f64(x: torch.Tensor) -> torch.Tensor:
    """float64 E1 for x > 0: the series of Ein below the seam, the
    continued fraction ``e^{-x} / (x + 1 - 1²/(x + 3 - 2²/(x + 5 - …)))``
    (evaluated from the tail as ``u_k = 1 / (x + 2k + 1 - (k+1)² u_{k+1})``)
    above it; both over every element, then selected."""
    small = x <= _E1_SEAM
    xs = torch.where(small, x, torch.ones_like(x)).clamp_min(1e-300)
    xl = torch.where(small, torch.full_like(x, _E1_SEAM), x)
    s = torch.full_like(x, _E1_SERIES[-1])
    for c in _E1_SERIES[-2::-1]:
        s = s.mul_(xs).add_(c)
    series = s.mul_(xs).sub_(_EULER_GAMMA).sub_(torch.log(xs))
    u = torch.zeros_like(x)
    for k in range(_E1_CF_TERMS, 0, -1):
        u = torch.add(xl, u, alpha=-float((k + 1) ** 2)).add_(2 * k + 1).reciprocal_()
    frac = torch.exp(-xl) / torch.add(xl, u, alpha=-1.0).add_(1.0)
    return torch.where(small, series, frac)


def _exp1_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 E1 by the Abramowitz & Stegun rational forms, the JAX
    package's ``_exp1_f32``: 5.1.53 below 1 (abs err < 2e-7), 5.1.56 above
    (abs err < 2e-8 on x·eˣ·E1); +inf at x ≤ 0."""
    xs = torch.clamp(x, min=1e-30)
    a = (-0.57721566, 0.99999193, -0.24991055, 0.05519968, -0.00976004, 0.00107857)
    xl = torch.clamp(xs, max=1.0)
    p_small = torch.full_like(xl, a[5])
    for c in a[4::-1]:
        p_small = p_small * xl + c
    small = p_small - torch.log(xl)
    a1, a2, a3, a4 = 8.5733287401, 18.0590169730, 8.6347608925, 0.2677737343
    b1, b2, b3, b4 = 9.5733223454, 25.6329561486, 21.0996530827, 3.9584969228
    xb = torch.clamp(xs, min=1.0)
    num = ((((xb + a1) * xb + a2) * xb + a3) * xb) + a4
    den = ((((xb + b1) * xb + b2) * xb + b3) * xb) + b4
    big = torch.exp(-xb) / xb * num / den
    result = torch.where(xs <= 1.0, small, big)
    return torch.where(x > 0.0, result, torch.full_like(x, math.inf))


class _Exp1(torch.autograd.Function):
    """E1 with its derivative :math:`dE_1/dx = -e^{-x}/x` as the backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        with torch.no_grad():
            if x.dtype == torch.float32:
                return _exp1_f32(x)
            out = _exp1_f64(x.to(torch.float64)).to(x.dtype)
            # E1(0) = +inf; undefined below 0 (JAX's float64 exp1 gives NaN)
            out = torch.where(x == 0, torch.full_like(out, math.inf), out)
            return torch.where(x < 0, torch.full_like(out, math.nan), out)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        if x.dtype == torch.float32:
            xs = torch.clamp(x, min=1e-30)
            return grad * (-torch.exp(-xs) / xs)
        return grad * (-torch.exp(-x) / x)


def exp1(x: torch.Tensor) -> torch.Tensor:
    r"""Exponential integral :math:`E_1(x) = \int_x^\infty e^{-t}/t\,dt` for x > 0.

    Differentiable (:math:`dE_1/dx = -e^{-x}/x`).  float32 takes the A&S
    rational forms (~2e-7 absolute, as the JAX package's float32 path);
    float64 a fixed-length series and continued fraction, within 1e-14
    relative of ``jax.scipy.special.exp1`` over 1e-8..700.

    Example
    -------
    >>> import torch
    >>> print(f"{float(exp1(torch.tensor(1.0, dtype=torch.float64))):.12f}")
    0.219383934396
    """
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return _Exp1.apply(x)


#: the name of the upstream torch-pme's E1 autograd class; here the same
#: function as :func:`exp1`
CustomExp1 = exp1


def gammainc_over_powerlaw(exponent: int, z: torch.Tensor) -> torch.Tensor:
    r"""Closed forms of :math:`P(p/2, z)\,/\,z^{p/2}` (regularized LOWER
    incomplete gamma over the power law), for integer exponents ``p = 1..6``:
    the long-range real-space kernel of :math:`1/r^p` potentials.  Below
    ``z = 0.5`` the closed forms difference nearly equal terms, so the
    ascending series :math:`e^{-z}\sum_k z^k/\Gamma(a+k+1)` (15 terms) takes
    over there.

    Example
    -------
    >>> import torch
    >>> z = torch.tensor([0.03, 0.4, 2.1, 9.0], dtype=torch.float64)
    >>> ref = torch.special.gammainc(torch.tensor(1.5, dtype=torch.float64), z) / z**1.5
    >>> print(bool(torch.allclose(gammainc_over_powerlaw(3, z), ref, rtol=1e-12)))
    True
    """
    if not 1 <= exponent <= 6:
        raise ValueError(f"Unsupported exponent: {exponent}")
    a = exponent / 2
    small = z < 0.5
    # `where`, not min/max, so the boundary z == 0.5 keeps its whole
    # cotangent in the selected branch
    zc = torch.where(small, torch.full_like(z, 0.5), z)
    zs = torch.where(small, z, torch.full_like(z, 0.5))
    sz = torch.sqrt(zc)
    two_rpi = 2 / math.sqrt(math.pi)
    if exponent == 1:
        closed = torch.special.erf(sz) / sz
    elif exponent == 2:
        closed = -torch.expm1(-zc) / zc
    elif exponent == 3:
        closed = (torch.special.erf(sz) - two_rpi * sz * torch.exp(-zc)) / (zc * sz)
    elif exponent == 4:
        closed = (-torch.expm1(-zc) - zc * torch.exp(-zc)) / zc**2
    elif exponent == 5:
        closed = (
            torch.special.erf(sz) - two_rpi * sz * (1 + 2 * zc / 3) * torch.exp(-zc)
        ) / (zc**2 * sz)
    else:
        closed = (-torch.expm1(-zc) - (zc + zc**2 / 2) * torch.exp(-zc)) / zc**3
    series = torch.zeros_like(z)
    for k in range(14, -1, -1):  # Horner over Σ_k z^k / Γ(a+k+1)
        series = series * zs + 1.0 / math.gamma(a + k + 1)
    series = series * torch.exp(-zs)
    return torch.where(small, series, closed)


def gammaincc_over_powerlaw(exponent: int, z: torch.Tensor) -> torch.Tensor:
    r"""Closed forms of the upper-incomplete-gamma-over-power-law
    combination in the Fourier transform of :math:`1/r^p` potentials, for
    integer exponents ``p = 1..6`` (this table is what limits the supported
    exponents).

    :param exponent: integer exponent ``p`` of the power law.
    :param z: positive values at which to evaluate.
    """
    if exponent == 1:
        return torch.exp(-z) / z
    if exponent == 2:
        return torch.sqrt(math.pi / z) * torch.special.erfc(torch.sqrt(z))
    if exponent == 3:
        return exp1(z)
    if exponent == 4:
        return 2 * (torch.exp(-z) - torch.sqrt(math.pi * z) * torch.special.erfc(torch.sqrt(z)))
    if exponent == 5:
        return torch.exp(-z) - z * exp1(z)
    if exponent == 6:
        return (
            (2 - 4 * z) * torch.exp(-z)
            + 4 * torch.sqrt(math.pi * z**3) * torch.special.erfc(torch.sqrt(z))
        ) / 3
    raise ValueError(f"Unsupported exponent: {exponent}")
