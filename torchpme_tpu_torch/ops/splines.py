"""Natural cubic splines and their radial Fourier transforms.

Counterpart of :mod:`torchpme_tpu.ops.splines`.  Splines are ``nn.Module``s
whose knots are buffers (so ``.to(device)`` moves them); evaluation is
differentiable with respect to the evaluation points.  The knots are fixed
at construction: nothing here is trainable.  The cosine integral in the
tail of :func:`compute_spline_ft` comes from ``scipy.special.sici`` on the
host, in float64 (PyTorch has no ``sici``); the transform is computed once,
when a spline potential is built.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = [
    "CubicSpline",
    "CubicSplineReciprocal",
    "compute_second_derivatives",
    "compute_spline_ft",
    "solve_tridiagonal",
]


def solve_tridiagonal(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor):
    """Solve a tridiagonal system with the Thomas algorithm.

    :param a: sub-diagonal, entries ``a[1..n-1]`` are used.
    :param b: main diagonal, ``b[0..n-1]``.
    :param c: super-diagonal, entries ``c[0..n-2]`` are used.
    :param d: right-hand side.
    :return: the solution ``x``, ``len(d)`` entries.
    """
    n = d.shape[0]
    c_prime = [c[0] / b[0]]
    d_prime = [d[0] / b[0]]
    for i in range(1, n):
        denom = b[i] - a[i] * c_prime[-1]
        c_prime.append(c[i] / denom)
        d_prime.append((d[i] - a[i] * d_prime[-1]) / denom)
    x = [d_prime[-1]]
    for i in range(n - 2, -1, -1):
        x.append(d_prime[i] - c_prime[i] * x[-1])
    return torch.stack(x[::-1])


def compute_second_derivatives(x_points: torch.Tensor, y_points: torch.Tensor) -> torch.Tensor:
    """Second derivatives of the natural cubic spline through ``(x, y)``
    (zero curvature at both ends)."""
    x, y = torch.as_tensor(x_points), torch.as_tensor(y_points)
    h = x[1:] - x[:-1]
    dy = (y[1:] - y[:-1]) / h
    n = x.shape[0]
    a = torch.zeros_like(x)
    b = torch.ones_like(x)
    c = torch.zeros_like(x)
    d = torch.zeros_like(x)
    a[1 : n - 1] = h[:-1] / 6
    b[1 : n - 1] = (h[:-1] + h[1:]) / 3
    c[1 : n - 1] = h[1:] / 6
    d[1 : n - 1] = dy[1:] - dy[:-1]
    return solve_tridiagonal(a, b, c, d)


class CubicSpline(nn.Module):
    """Natural cubic spline of a real function of one variable.

    Example
    -------
    >>> import math, torch
    >>> x = torch.linspace(0.0, 2.0 * math.pi, 200, dtype=torch.float64)
    >>> spline = CubicSpline(x, torch.sin(x))
    >>> print(f"{float(spline(torch.tensor(math.pi / 2, dtype=torch.float64))):.5f}")
    1.00000
    """

    def __init__(self, x_points: torch.Tensor, y_points: torch.Tensor):
        super().__init__()
        x_points, y_points = torch.as_tensor(x_points), torch.as_tensor(y_points)
        self.register_buffer("x_points", x_points)
        self.register_buffer("y_points", y_points)
        self.register_buffer("d2y_points", compute_second_derivatives(x_points, y_points))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = self.x_points.to(x.device)
        yp = self.y_points.to(x.device)
        d2 = self.d2y_points.to(x.device)
        xx = x.to(xp.dtype)
        i = torch.searchsorted(xp, xx.detach().contiguous(), right=True) - 1
        i = torch.clamp(i, 0, xp.shape[0] - 2)
        x_lo, x_hi = xp[i], xp[i + 1]
        h = x_hi - x_lo
        t_hi = (x_hi - xx) / h
        t_lo = (xx - x_lo) / h
        h2over6 = h * h / 6
        out = t_hi * (yp[i] + (t_hi * t_hi - 1) * d2[i] * h2over6) + t_lo * (
            yp[i + 1] + (t_lo * t_lo - 1) * d2[i + 1] * h2over6
        )
        return out.to(x.dtype)


class CubicSplineReciprocal(nn.Module):
    """Cubic spline on a ``1/x`` axis, going smoothly to zero at infinity:
    the long-range branch splines :math:`y(1/x)` (zero-extended to
    ``x → ∞``), and a small direct spline bridges the first knot and zero."""

    def __init__(self, x_points: torch.Tensor, y_points: torch.Tensor, y_at_zero=None):
        super().__init__()
        x_points, y_points = torch.as_tensor(x_points), torch.as_tensor(y_points)
        zero_x = torch.zeros((1,), dtype=x_points.dtype, device=x_points.device)
        zero_y = torch.zeros((1,), dtype=y_points.dtype, device=y_points.device)
        self.rev_spline = CubicSpline(
            torch.cat([zero_x, 1.0 / x_points.flip(0)]), torch.cat([zero_y, y_points.flip(0)])
        )
        y0 = y_points[0] if y_at_zero is None else torch.as_tensor(
            y_at_zero, dtype=y_points.dtype, device=y_points.device)
        self.zero_spline = CubicSpline(
            torch.stack([zero_x[0], x_points[0], x_points[1]]),
            torch.stack([y0.reshape(()), y_points[0], y_points[1]]),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_lo = self.zero_spline.x_points[1].to(device=x.device, dtype=x.dtype)
        below = x < x_lo
        safe_x = torch.where(below, x_lo, x)
        return torch.where(below, self.zero_spline(x), self.rev_spline(1.0 / safe_x))


def compute_spline_ft(
    k_points: torch.Tensor,
    x_points: torch.Tensor,
    y_points: torch.Tensor,
    d2y_points: torch.Tensor,
) -> torch.Tensor:
    r"""Radial Fourier transform :math:`\hat f(k) = 4\pi\int dr\,
    \frac{\sin kr}{k}\, r f(r)` of the natural cubic spline through ``(x,
    y)`` with curvatures ``d2y``, plus an analytic :math:`1/x`-spline tail
    from the last knot to infinity.  The per-interval integral has a
    removable :math:`k^{-6}` pole: a Horner form in k, trig-identity
    increments and an analytic ``k → 0`` limit handle it.  The tail's
    cosine integral comes from scipy on the host (float64).
    """
    from scipy.special import sici

    dtype = x_points.dtype
    k = k_points.reshape(-1, 1).to(dtype)
    ri = x_points[None, :-1]
    yi = y_points[None, :-1]
    d2yi = d2y_points[None, :-1]
    dr = x_points[None, 1:] - x_points[None, :-1]
    dy = y_points[None, 1:] - y_points[None, :-1]
    dd2y = d2y_points[None, 1:] - d2y_points[None, :-1]

    cos_i = torch.cos(k * ri)
    sin_i = torch.sin(k * ri)
    half = k * dr / 2
    dcos = 2 * torch.sin(half) * torch.sin(k * (dr / 2 + ri))
    dsin = -2 * torch.sin(half) * torch.cos(k * (dr / 2 + ri))

    poly = 24 * dcos * dd2y + k * (
        6 * dsin * (3 * d2yi * dr + dd2y * (4 * dr + ri))
        - 24 * dd2y * dr * sin_i
        + k
        * (
            6 * cos_i * dr * (3 * d2yi * dr + dd2y * (2 * dr + ri))
            - 2 * dcos * (6 * dy + dr * ((6 * d2yi + 5 * dd2y) * dr + 3 * (d2yi + dd2y) * ri))
            + k
            * (
                dr
                * (12 * dy + 3 * d2yi * dr * (dr + 2 * ri) + dd2y * dr * (2 * dr + 3 * ri))
                * sin_i
                + dsin
                * (
                    -6 * dy * ri
                    - 3 * d2yi * dr**2 * (dr + ri)
                    - 2 * dd2y * dr**2 * (dr + ri)
                    - 6 * dr * (2 * dy + yi)
                )
                + k
                * (
                    6 * dcos * dr * (dr + ri) * (dy + yi)
                    + cos_i * (6 * dr * ri * yi - 6 * dr * (dr + ri) * (dy + yi))
                )
            )
        )
    )

    zero = torch.zeros((), dtype=dtype, device=x_points.device)
    tail_d2y = compute_second_derivatives(
        torch.stack([zero, 1.0 / x_points[-1], 1.0 / x_points[-2]]),
        torch.stack([zero, y_points[-1], y_points[-2]]),
    )
    r_n = x_points[-1]
    y_n = y_points[-1]
    d2y_n = tail_d2y[1]
    kr = (k * r_n).detach().cpu().numpy().astype(np.float64)
    cosint = torch.as_tensor(sici(kr)[1], device=k.device).to(dtype)
    tail_k2 = (
        -2
        * math.pi
        * (
            (d2y_n - 6 * r_n**2 * y_n) * torch.cos(k * r_n)
            + d2y_n * k * r_n * (k * r_n * cosint - torch.sin(k * r_n))
        )
    ) / (3.0 * r_n)

    interval_sum = math.pi * 2 / 3 * torch.sum(poly / dr, dim=1).reshape(-1, 1)
    limit_k0 = torch.sum(
        -(
            dr
            * math.pi
            * (
                3 * d2yi * dr**2 * (3 * dr**2 + 10 * dr * ri + 10 * ri**2)
                + dd2y * dr**2 * (5 * dr**2 + 16 * dr * ri + 15 * ri**2)
                - 30
                * (
                    6 * ri**2 * (dy + 2 * yi)
                    + 4 * dr * ri * (2 * dy + 3 * yi)
                    + dr**2 * (3 * dy + 4 * yi)
                )
            )
        )
        / 90,
        dim=1,
    )
    safe_k = torch.where(k == 0, torch.ones_like(k), k)
    out = torch.where(
        k == 0, limit_k0.reshape(-1, 1), interval_sum / safe_k**6 + tail_k2 / safe_k**2
    )
    return out.reshape(k_points.shape).to(k_points.dtype)
