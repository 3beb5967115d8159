"""Reciprocal-space filter, its application to a mesh, and the Parseval
quadratic form, on cuFFT; the P3M influence function, and the stateful
filter classes of power users.

Counterpart of :mod:`torchpme_tpu.ops.kspace`.  The JAX package can run the
transforms as DFT matmuls on the TPU (its 3D rFFT has a latency floor
there); here every transform is ``torch.fft.rfftn`` / ``irfftn``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .kvectors import _cell_and_ns, generate_kvectors_for_mesh

__all__ = [
    "KSpaceFilter",
    "KSpaceKernel",
    "P3MKSpaceFilter",
    "apply_kspace_filter",
    "compute_kspace_filter",
    "kspace_filter_quadratic",
    "p3m_influence_function",
]

# finite-difference coefficient table for the approximate differential
# operator ik, orders 1..6 (Appendix C of Deserno & Holm, JCP 109, 7678)
_DIFF_COEFFS = np.array(
    [
        [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [4 / 3, -1 / 3, 0.0, 0.0, 0.0, 0.0],
        [3 / 2, -3 / 5, 1 / 10, 0.0, 0.0, 0.0],
        [8 / 5, -4 / 5, 8 / 35, -1 / 35, 0.0, 0.0],
        [5 / 3, -20 / 21, 5 / 14, -5 / 63, 1 / 126, 0.0],
        [12 / 7, -15 / 14, 10 / 21, -1 / 7, 2 / 77, -1 / 465],
    ]
)


def apply_kspace_filter(
    mesh_values: torch.Tensor,
    kfilter: torch.Tensor,
    fft_norm: str = "ortho",
    ifft_norm: str = "ortho",
) -> torch.Tensor:
    r"""Apply a scalar reciprocal-space filter to a real-space mesh:
    :math:`f \to \hat f \to \hat f\,\phi \to \tilde f` with a 3D rFFT over
    the last three axes.  Mesh calculators use the ``backward``/``forward``
    norm pair, which puts no :math:`1/n` factor in either direction.

    :param mesh_values: ``(C, nx, ny, nz)`` real-space field.
    :param kfilter: ``(nx, ny, nz//2+1)`` filter on the rFFT grid.
    """
    if mesh_values.ndim != 4:
        raise ValueError(
            "`mesh_values` needs to be a 4 dimensional tensor, got "
            f"{mesh_values.ndim}"
        )
    dims = (1, 2, 3)
    mesh_hat = torch.fft.rfftn(mesh_values, norm=fft_norm, dim=dims)
    if mesh_hat.shape[-3:] != kfilter.shape[-3:]:
        raise ValueError("The real-space mesh is inconsistent with the k-space grid.")
    # explicit output size: for odd mesh sizes the inverse rFFT is ambiguous
    return torch.fft.irfftn(
        mesh_hat * kfilter, norm=ifft_norm, dim=dims, s=mesh_values.shape[-3:]
    )


def compute_kspace_filter(kernel_from_k_sq, cell: torch.Tensor, ns) -> torch.Tensor:
    """Evaluate a kernel function of :math:`k^2` on the rFFT grid of ``ns``."""
    kvectors = generate_kvectors_for_mesh(cell, ns)
    k_sq = torch.sum(kvectors**2, dim=-1)
    return kernel_from_k_sq(k_sq)


def _hermitian_fold_weights(nz: int) -> np.ndarray:
    """Half-z-spectrum fold weights: 2 except at k_z = 0 and (even nz) Nyquist."""
    w = np.full(nz // 2 + 1, 2.0)
    w[0] = 1.0
    if nz % 2 == 0:
        w[-1] = 1.0
    return w


def kspace_filter_quadratic(mesh_values: torch.Tensor, kfilter: torch.Tensor):
    r"""Quadratic form :math:`\sum_x \rho\,(K \circledast \rho)` via Parseval.

    With the un-normalized forward transform,
    :math:`\sum_x \rho\,\phi = \sum_k w_{k_z}\,\hat K(k)\,|\hat\rho(k)|^2`,
    summed over channels; :math:`w_{k_z}` are the Hermitian fold weights.

    :param mesh_values: ``(C, nx, ny, nz)`` real density.
    :param kfilter: ``(nx, ny, nz//2+1)`` filter on the rFFT grid.
    :return: the form as a float64 scalar.
    """
    if mesh_values.ndim != 4:
        raise ValueError(
            f"`mesh_values` needs 4 dimensions, got {mesh_values.ndim}"
        )
    nz = mesh_values.shape[-1]
    rho_hat = torch.fft.rfftn(mesh_values, dim=(1, 2, 3), norm="backward")
    if rho_hat.shape[-3:] != kfilter.shape[-3:]:
        raise ValueError("The real-space mesh is inconsistent with the k-space grid.")
    weights = torch.as_tensor(
        _hermitian_fold_weights(nz), dtype=kfilter.dtype, device=kfilter.device
    )
    power = rho_hat.real**2 + rho_hat.imag**2
    # a million terms whose sum cancels against the self energy downstream:
    # accumulate in float64 (the result is float64)
    return torch.sum(power * (weights * kfilter), dtype=torch.float64)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    r""":math:`\sin(\pi x)/(\pi x)` with derivatives that stay exact near 0.

    A triclinic k-grid has accidental near-zeros of ``x`` (a sum of
    reciprocal components that cancels to ~1e-17), where the quotient
    rule's derivative subtracts two ~1e16 terms and leaves noise in the P3M
    influence function's cell gradient.  Below ``|x| = 1e-4`` the Taylor
    series (value error :math:`(\pi x)^6/5040 \approx 2\cdot10^{-25}`)
    replaces the quotient in the value and in every derivative.
    """
    small = torch.abs(x) < 1e-4
    x_safe = torch.where(small, torch.ones_like(x), x)
    px_sq = (np.pi * x) ** 2
    series = 1.0 - px_sq / 6.0 * (1.0 - px_sq / 20.0)
    return torch.where(small, series, torch.sin(np.pi * x_safe) / (np.pi * x_safe))


def _check_influence_options(mode: int, differential_order: int) -> None:
    if mode not in (0, 1, 2, 3):
        raise ValueError(f"`mode` should be one of [0, 1, 2, 3], but got {mode}")
    if differential_order not in (1, 2, 3, 4, 5, 6):
        raise ValueError(
            "`differential_order` should be one between 1 and 6, "
            f"but got {differential_order}"
        )


def p3m_influence_function(
    cell: torch.Tensor,
    ns,
    interpolation_nodes: int,
    mode: int = 0,
    differential_order: int = 2,
) -> torch.Tensor:
    r"""Optimal P3M influence function on the rFFT grid, ``(nx, ny, nz//2+1)``.

    Eq. 30 of Ballenegger et al. (JCP 128, 034109 (2008)) for the potential
    (``mode=0``), energy (1), dipolar torque (2) and dipolar force (3), with
    the charge-assignment transfer function :math:`\prod_i
    \mathrm{sinc}(k_ih_i/2\pi)^{2n}` and a finite-difference differential
    operator of the given order (1–6).  Mode 0 reduces to :math:`1/U^2`.
    Differentiable with respect to ``cell``.  In float32 the product of
    3·2n sinc factors carries their rounding; the calculators evaluate it in
    float64 (:meth:`~torchpme_tpu_torch.PMECalculator._kspace_filter`).
    """
    _check_influence_options(mode, differential_order)
    ns = tuple(int(n) for n in ns)
    kvectors = generate_kvectors_for_mesh(cell, ns)
    cell_lengths = torch.linalg.norm(cell, dim=1)
    spacing = (
        cell_lengths / torch.tensor(ns, dtype=cell.dtype, device=cell.device)
    ).reshape(1, 1, 1, 3)
    kh = kvectors * spacing
    # squared transform of the charge-assignment function
    u_sq = torch.prod(_sinc(kh / (2 * np.pi)), dim=-1) ** (2 * interpolation_nodes)
    if mode == 0:
        masked = torch.where(u_sq == 0, torch.ones_like(u_sq), u_sq)
        return torch.where(u_sq == 0, torch.zeros_like(u_sq), 1.0 / masked)

    # finite-difference approximation of the differential operator ik (the
    # i cancels against the -i of the force kernel)
    coeffs = _DIFF_COEFFS[differential_order - 1]
    diff_op = torch.zeros_like(kh)
    for m in range(differential_order):
        diff_op = diff_op + (float(coeffs[m]) / (m + 1)) * torch.sin(kh * (m + 1))
    diff_op = diff_op / spacing
    d_pow = torch.linalg.norm(diff_op, dim=-1) ** (4 * mode)
    numerator = torch.sum(kvectors * diff_op, dim=-1) ** mode
    denominator = u_sq * d_pow
    masked = torch.where(denominator == 0, torch.ones_like(denominator), denominator)
    return torch.where(denominator == 0, torch.zeros_like(denominator), numerator / masked)


class KSpaceKernel:
    """Protocol of objects that give a reciprocal-space kernel: anything with
    a ``kernel_from_k_sq(k_sq)`` method."""

    def kernel_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"kernel_from_k_sq is not implemented for '{type(self).__name__}'"
        )


class KSpaceFilter:
    """A reciprocal-space filter cached for repeated application (power
    users, e.g. LODE features): :meth:`update` after a change of cell, mesh
    or kernel; :meth:`forward` filters a ``(C, nx, ny, nz)`` mesh and raises
    where the result holds NaN.  The calculators call
    :func:`compute_kspace_filter` and :func:`apply_kspace_filter` directly.
    The filter lives on ``device`` (default: that of a tensor ``cell``, else
    :func:`~torchpme_tpu_torch.default_device`); a host cell given to
    :meth:`update` goes there too.

    Example
    -------
    A unit kernel with the ``ortho`` norm pair is an exact round trip:

    >>> import torch
    >>> class UnitKernel:
    ...     def kernel_from_k_sq(self, k_sq):
    ...         return torch.ones_like(k_sq)
    >>> kf = KSpaceFilter(torch.eye(3, dtype=torch.float64), (4, 4, 4), UnitKernel())
    >>> field = torch.arange(64.0, dtype=torch.float64).reshape(1, 4, 4, 4)
    >>> print(torch.allclose(kf(field), field, atol=1e-12))
    True
    """

    _VALID_NORMS = ("ortho", "forward", "backward")

    def __init__(
        self, cell, ns_mesh, kernel, fft_norm: str = "ortho", ifft_norm: str = "ortho",
        device=None,
    ):
        if fft_norm not in self._VALID_NORMS:
            raise ValueError(f"Invalid option '{fft_norm}' for the `fft_norm` parameter.")
        if ifft_norm not in self._VALID_NORMS:
            raise ValueError(f"Invalid option '{ifft_norm}' for the `ifft_norm` parameter.")
        self._fft_norm = fft_norm
        self._ifft_norm = ifft_norm
        self.kernel = kernel
        self.device = resolve_device(device, cell)
        self.update(cell, ns_mesh)

    def _set_geometry(self, cell, ns_mesh) -> None:
        cell, ns_mesh = _cell_and_ns(cell, ns_mesh, self.device)
        if cell is not None:
            self.cell = cell
        if ns_mesh is not None:
            self.ns_mesh = ns_mesh

    def update(self, cell=None, ns_mesh=None) -> None:
        """Recompute the cached filter after a change of cell, mesh or kernel."""
        self._set_geometry(cell, ns_mesh)
        self._kfilter = compute_kspace_filter(
            self.kernel.kernel_from_k_sq, self.cell, self.ns_mesh
        )

    def forward(self, mesh_values: torch.Tensor) -> torch.Tensor:
        result = apply_kspace_filter(mesh_values, self._kfilter, self._fft_norm, self._ifft_norm)
        if bool(torch.isnan(result).any()):
            raise ValueError(
                "NaNs detected in the k-space filter result. These are probably "
                "caused by an unsuitable `mesh_spacing`, resulting in a "
                f"problematic grid of shape {list(mesh_values.shape)}. Try "
                "adjusting the grid with a different `mesh_spacing` value."
            )
        return result

    __call__ = forward


class P3MKSpaceFilter(KSpaceFilter):
    """:class:`KSpaceFilter` times the P3M optimal influence function
    (:func:`p3m_influence_function`)."""

    def __init__(
        self,
        cell,
        ns_mesh,
        interpolation_nodes: int,
        kernel,
        fft_norm: str = "ortho",
        ifft_norm: str = "ortho",
        mode: int = 0,
        differential_order: int = 2,
        device=None,
    ):
        _check_influence_options(mode, differential_order)
        self.interpolation_nodes = int(interpolation_nodes)
        self.mode = mode
        self.differential_order = differential_order
        super().__init__(cell, ns_mesh, kernel, fft_norm, ifft_norm, device)

    def update(self, cell=None, ns_mesh=None) -> None:
        """Recompute influence function × potential kernel."""
        self._set_geometry(cell, ns_mesh)
        influence = p3m_influence_function(
            self.cell, self.ns_mesh, self.interpolation_nodes, self.mode,
            self.differential_order,
        )
        self._kfilter = influence * compute_kspace_filter(
            self.kernel.kernel_from_k_sq, self.cell, self.ns_mesh
        )
