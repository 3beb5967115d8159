r"""Cell-list window energy for dipolar (3×3 tensor) pair kernels.

Counterpart of :mod:`torchpme_tpu.ops.rspace_cells_dipole`.  Extends the
cell-list engine of :mod:`~torchpme_tpu_torch.ops.rspace_cells` (27-cell
torus windows, half-window with the self cell ½-scaled) to point dipoles;
the three dipole components ride its charge-channel axis.  The tensor kernel
is never materialized: every dipolar pair kernel is
``K(r) = B(r)·I − C(r)·r⊗r``, so the pair energy contracts as

.. math:: \mu_i^T K(r_{ij}) \mu_j
          = B(d)\,(\mu_i\cdot\mu_j) − C(d)\,(\mu_i\cdot r)(\mu_j\cdot r).

With concrete potential parameters and no exclusion window, one pass returns
the energy together with its whole gradient
(:func:`dipole_window_value_and_grad`, kernel G in
``csrc/window_dipole.cu``, beside its plain version
:func:`_dw_value_and_grad`): since ``K`` is a gradient field,
``dB/dr = −C·r`` holds identically and the analytic pair forces need only the
potential's ``C′`` hook,

.. math:: \partial E/\partial p_i = \sum_j\bigl[-s_{ij}\,r_{ij}
          + C_{ij}(R^j_{ij}\mu_i + R^i_{ij}\mu_j)\bigr],\qquad
          s = \bigl(B'M - C'R^iR^j\bigr)/d.

A potential whose parameters require grad, or with an exclusion window,
takes the plain autograd path (:func:`_dw_math`): on CPU tensors by itself,
on a card only with ``plain=True`` (without it the window raises; there is
no kernel for it).

Kernel G is the op ``torch.ops.tpme.window_dipole`` (the potential goes in
as its smearing and prefactor), registered in C++ (``csrc/tpme_ops.cpp``:
its CUDA kernel builds the parameters and launches), with the plain version
as its CPU kernel and autograd registered here, so :mod:`torch.export` traces
through it; it has no vmap rule: under ``vmap`` it raises.

Staleness keeps the JAX package's contract: once an atom leaves its cell the
energy, and every gradient, is NaN.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import Tensor

from .. import kernels as _k
from .math import inv3
from .rspace_cells import (
    _D27,
    CellList,
    _prepare_bucketed,
    _prepare_extras_bucketed,
    _window_offsets,
)

__all__ = [
    "cell_list_rspace_dipole_energy",
    "cell_list_rspace_dipole_energy_rows",
    "dipole_window_value_and_grad",
]


def _scalar_hooks(potential):
    """(B, C) kernels and the C′ hook for the potential's mode."""
    if potential.smearing is None:
        return potential.scalar_kernels, potential.scalar_kernel_derivative
    return potential.sr_scalar_kernels, potential.sr_scalar_kernel_derivative


def _can_use_analytic_dipole(potential) -> bool:
    """The fused value-and-gradient pass covers neither the exclusion
    window's ``f(r)`` terms nor cotangents of the potential's parameters."""
    return potential.exclusion_radius is None and not potential.has_trainable_parameters()


def _offset_geometry(k, offset, pc_t, mu_g, mf_g, offs, cutoff_sq):
    """Window geometry of one neighbor offset: the neighbor cell's positions
    (shifted by the center-to-center vector), dipoles (½-scaled on the self
    cell, so every unordered pair counts once) and the pair mask (cutoff,
    occupancy, self pair excluded by identity)."""
    self_cell = offset == (0, 0, 0)
    shift = tuple(-o for o in offset)
    pj = torch.roll(pc_t, shift, dims=(0, 1, 2)) + offs[k][:, None]  # (x, y, z, 3, cap)
    muj = torch.roll(mu_g, shift, dims=(0, 1, 2)) * (0.5 if self_cell else 1.0)
    mj = torch.roll(mf_g, shift, dims=(0, 1, 2))
    d_sq = sum(
        (pc_t[..., c, :, None] - pj[..., c, None, :]) ** 2 for c in range(3)
    )  # (x, y, z, cap, cap)
    pair_ok = (d_sq > 0.0) & (d_sq < cutoff_sq) & (mj[..., None, :] > 0.5)
    if self_cell:
        cap = pc_t.shape[-1]
        pair_ok = pair_ok & ~torch.eye(cap, dtype=torch.bool, device=pc_t.device)
    return pj, muj, pair_ok, torch.where(pair_ok, d_sq, 1.0)


def _dot_products(mui, muj, pc_t, pj):
    """``(μi·μj, μi·r, μj·r)`` with ``r = p_j − p_i``, each ``(x, y, z, cap,
    cap)``, assembled from the i/j position blocks."""
    mumu = torch.einsum("...ic,...jc->...ij", mui, muj)
    ri = torch.einsum("...ic,...cj->...ij", mui, pj) - torch.einsum(
        "...ic,...ci->...i", mui, pc_t
    )[..., None]
    rj = torch.einsum("...jc,...cj->...j", muj, pj)[..., None, :] - torch.einsum(
        "...jc,...ci->...ij", muj, pc_t
    )
    return mumu, ri, rj


def _dw_math(potential, cutoff: float, pc_t, mu_g, mf_g, offs, mui_g=None):
    """Primal window energy, differentiated by autograd: the path of
    potentials with trainable parameters or an exclusion window.

    ``mui_g`` optionally provides separate i-side dipoles; the j side always
    reads the full ``mu_g`` grid.
    """
    scalars = _scalar_hooks(potential)[0]
    dtype = pc_t.dtype
    cutoff_sq = torch.tensor(cutoff, dtype=dtype, device=pc_t.device) ** 2
    mui = mu_g if mui_g is None else mui_g
    e = torch.zeros((), dtype=dtype, device=pc_t.device)
    for k, offset in enumerate(_window_offsets(pc_t.shape[-1])):
        pj, muj, pair_ok, d_sq_safe = _offset_geometry(
            k, offset, pc_t, mu_g, mf_g, offs, cutoff_sq
        )
        b, c = scalars(torch.sqrt(d_sq_safe))
        mumu, ri, rj = _dot_products(mui, muj, pc_t, pj)
        e = e + torch.sum(pair_ok.to(dtype) * (b * mumu - c * ri * rj))
    return e


def _dw_value_and_grad(potential, cutoff: float, pc_t, mu_g, mf_g, offs, mui_g=None):
    """Plain version of kernel G: the dipolar window energy and its whole
    analytic gradient in one pass.

    Per offset, with ``r = p_j − p_i``, ``M = μi·μj``, ``Ri = μi·r``,
    ``Rj = μj·r``, ``s = (B′M − C′RiRj)/d`` and ``B′ = −C·d``:

    * ``∂E/∂p_i = Σ_j −s·r + C(Rj μi + Ri μj)``, mirrored on the j side and
      rolled home (its per-offset total is the ``offs`` gradient);
    * ``∂E/∂μ_i = Σ_j B μj − C Rj r``, mirrored on the j side (the j-side
      cotangent carries the self cell's ½).

    float32 takes the potential's fused ``window_scalar_math_sq`` (one
    transcendental pass), float64 the exact scalars and the ``C′`` hook; the
    energy accumulates in float64, as kernel G does.

    :return: ``(e, (d_pc, d_mu, d_offs))``, or ``(e, (d_pc, d_mu, d_offs,
        d_mui))`` with the i- and j-side dipole cotangents kept apart when
        ``mui_g`` is given.
    """
    scalars, cderiv = _scalar_hooks(potential)
    dtype = pc_t.dtype
    cutoff_sq = torch.tensor(cutoff, dtype=dtype, device=pc_t.device) ** 2
    fused = dtype == torch.float32
    mui = mu_g if mui_g is None else mui_g

    e = torch.zeros((), dtype=torch.float64, device=pc_t.device)
    d_pc = torch.zeros_like(pc_t)
    d_mu = torch.zeros_like(mu_g)  # j side, rolled home
    d_mui = torch.zeros_like(mui)  # i side
    d_offs = torch.zeros_like(offs)
    mu_t = mui.transpose(-1, -2)  # (…, 3, cap)
    pc_rows = pc_t.transpose(-1, -2)  # (…, cap, 3)
    for k, offset in enumerate(_window_offsets(pc_t.shape[-1])):
        pj, muj, pair_ok, d_sq_safe = _offset_geometry(
            k, offset, pc_t, mu_g, mf_g, offs, cutoff_sq
        )
        okf = pair_ok.to(dtype)
        if fused:
            b, c, cp_over_d = potential.window_scalar_math_sq(d_sq_safe)
        else:
            d = torch.sqrt(d_sq_safe)
            b, c = scalars(d)
            cp_over_d = cderiv(d, b, c) / d
        mumu, ri, rj = _dot_products(mui, muj, pc_t, pj)
        bt, ct = okf * b, okf * c
        rirj = ri * rj
        e = e + torch.sum(bt * mumu - ct * rirj, dtype=torch.float64)

        s = -(ct * mumu) - (okf * cp_over_d) * rirj
        ct_rj, ct_ri = ct * rj, ct * ri
        row_rj = ct_rj.sum(-1)  # (…, cap_i)
        col_ri = ct_ri.sum(-2)  # (…, cap_j)
        cross_i = torch.einsum("...ij,...dj->...di", s, pj)
        cross_j = torch.einsum("...ij,...di->...dj", s, pc_t)

        d_pc = (
            d_pc
            + pc_t * s.sum(-1)[..., None, :]
            - cross_i
            + mu_t * row_rj[..., None, :]
            + torch.einsum("...ij,...jc->...ci", ct_ri, muj)
        )
        d_pj = (
            pj * s.sum(-2)[..., None, :]
            - cross_j
            - torch.einsum("...ij,...ic->...cj", ct_rj, mui)
            - muj.transpose(-1, -2) * col_ri[..., None, :]
        )  # (x, y, z, 3, cap)
        d_mui = (
            d_mui
            + torch.matmul(bt, muj)
            - torch.einsum("...ij,...cj->...ic", ct_rj, pj)
            + pc_rows * row_rj[..., None]
        )
        d_muj = (
            torch.einsum("...ij,...ic->...jc", bt, mui)
            - pj.transpose(-1, -2) * col_ri[..., None]
            + torch.einsum("...ij,...ci->...jc", ct_ri, pc_t)
        )
        w = 0.5 if offset == (0, 0, 0) else 1.0
        d_pc = d_pc + torch.roll(d_pj, offset, dims=(0, 1, 2))
        d_mu = d_mu + torch.roll(d_muj, offset, dims=(0, 1, 2)) * w
        d_offs[k] = d_pj.sum(dim=(0, 1, 2, 4))
    if mui_g is not None:
        return e.to(dtype), (d_pc, d_mu, d_offs, d_mui)
    return e.to(dtype), (d_pc, d_mu + d_mui, d_offs)


# -- kernel G ----------------------------------------------------------------------


def _window_dipole_warps(cap: int, split: bool, device_index: int) -> int:
    """Home cells (one warp each) that a block of kernel G takes at this
    capacity on the card: 4, 2 or 1, the most whose shared memory fits it,
    as the ``tpme::window_dipole`` op chooses them
    (``tpme::window_dipole_plan``).  Raises where even one does not fit."""
    warps, largest = _k.tpme_op("window_dipole_plan")(cap, split, device_index)
    if warps == 0:
        raise ValueError(
            f"the dipolar window kernel takes a cell capacity of at most {largest} "
            f"{'with' if split else 'without'} separate i-side dipoles, got {cap}; "
            f"plain=True runs the plain version"
        )
    return warps


def _check_window_dipole(potential, pc_t, mu_g, mf_g, offs, mui_g):
    """Validate kernel G's operands (and that it evaluates ``potential``)."""
    from ..potentials.dipole import PotentialDipole  # potentials import ops

    if not isinstance(potential, PotentialDipole):
        raise TypeError(
            f"the dipolar window kernel evaluates the point-dipole pair math; got "
            f"{type(potential).__name__}"
        )
    if not _can_use_analytic_dipole(potential):
        raise ValueError(
            "the dipolar window kernel needs concrete potential parameters and no "
            "exclusion window (it produces no parameter cotangents)"
        )
    _check_window_dipole_operands(pc_t, mu_g, mf_g, offs, mui_g)


def _check_window_dipole_operands(pc_t, mu_g, mf_g, offs, mui_g):
    if pc_t.ndim != 5 or pc_t.shape[3] != 3:
        raise ValueError(f"pc_t must be (nx, ny, nz, 3, cap), got {tuple(pc_t.shape)}")
    nx, ny, nz, _, cap = pc_t.shape
    _k.check_cuda_tensor(pc_t, "pc_t", (nx, ny, nz, 3, cap))
    _k.check_cuda_tensor(mu_g, "mu_g", (nx, ny, nz, cap, 3))
    _k.check_cuda_tensor(mf_g, "mf_g", (nx, ny, nz, cap))
    _k.check_cuda_tensor(offs, "offs", (_k.N_OFFSETS, 3))
    if mui_g is not None:
        _k.check_cuda_tensor(mui_g, "mui_g", (nx, ny, nz, cap, 3))


@functools.lru_cache(maxsize=64)
def _table_dipole(smearing, prefactor: float):
    """The dipolar potential of a ``tpme::window_dipole`` call's scalars."""
    from ..potentials.dipole import PotentialDipole  # potentials import ops

    return PotentialDipole(smearing=smearing, prefactor=prefactor)


def _dipole_table(potential) -> tuple:
    """``(smearing, prefactor)`` of ``potential`` as the op takes them
    (concrete values: the window's potentials have no trainable ones)."""
    smearing = potential.smearing
    return None if smearing is None else float(smearing), float(potential.prefactor)


@_k.plain_version("window_dipole")
def _window_dipole_plain(
    pc_t: Tensor, mu_g: Tensor, mf_g: Tensor, offs: Tensor, mui_g: Optional[Tensor],
    smearing: Optional[float], prefactor: float, cutoff: float,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Kernel G's plain version with the op's signature (the op's CPU
    kernel, :func:`_dw_value_and_grad`): ``(e, d_pc, d_mu, d_offs, d_mui)``
    of the dipolar window (``d_mui`` empty without separate i-side dipoles
    ``mui_g``)."""
    e, grads = _dw_value_and_grad(
        _table_dipole(smearing, prefactor), cutoff, pc_t, mu_g, mf_g, offs, mui_g
    )
    d_mui = grads[3] if mui_g is not None else mu_g.new_empty((0,))
    return e, *grads[:3], d_mui


@_k.register_fake("window_dipole")
def _(pc_t, mu_g, mf_g, offs, mui_g, smearing, prefactor, cutoff):
    d_mui = torch.empty_like(mu_g) if mui_g is not None else mu_g.new_empty((0,))
    return (pc_t.new_empty(()), torch.empty_like(pc_t), torch.empty_like(mu_g),
            torch.empty_like(offs), d_mui)


#: kernel G: the outputs of :func:`_window_dipole_plain`
window_dipole = _k.tpme_op("window_dipole")


def _window_dipole_setup(ctx, inputs, output):
    # the gradients ride as attributes of non-differentiable outputs:
    # torch.export refuses outputs saved with save_for_backward
    ctx.mark_non_differentiable(*output[1:])
    ctx.grads = output[1:]
    # only the energy takes a cotangent: no zeros are made for the others
    ctx.set_materialize_grads(False)
    ctx.split = inputs[4] is not None
    ctx.n_inputs = len(inputs)


def _window_dipole_vjp(ctx, e_bar, *_):
    """The energy is a scalar: every cotangent is ``ē ×`` a gradient the
    forward already holds."""
    d_pc, d_mu, d_offs, d_mui = ctx.grads
    ct_mui = e_bar * d_mui if ctx.split else None
    return (e_bar * d_pc, e_bar * d_mu, None, e_bar * d_offs, ct_mui,
            *(None,) * (ctx.n_inputs - 5))


_k.register_autograd("window_dipole", _window_dipole_vjp, _window_dipole_setup)
_k.refuse_vmap("window_dipole", "tpme::window_dipole (kernel G)")
#: the dipolar window's energy with kernel G's VJP, or with ``plain`` its
#: plain version on any device: ``_WindowDipole.apply(*op_args, plain)``
_WindowDipole = _k.op_function(
    "_WindowDipole", "window_dipole", _window_dipole_setup, _window_dipole_vjp
)


def dipole_window_value_and_grad(
    potential, cutoff: float, pc_t, mu_g, mf_g, offs, mui_g=None
):
    """Kernel G: dipolar window energy and ``(d_pc, d_mu, d_offs[, d_mui])``
    in one launch, through ``torch.ops.tpme.window_dipole``.

    CPU tensors take :func:`_dw_value_and_grad`; CUDA tensors launch the
    kernel (float32, :class:`~torchpme_tpu_torch.potentials.PotentialDipole`
    with concrete parameters and no exclusion window, a capacity whose one
    offset fits shared memory; ``mu_g`` and ``mui_g`` zero in empty slots, as
    :func:`~torchpme_tpu_torch.ops.rspace_cells._prepare_bucketed` makes
    them) or raise.
    """
    if pc_t.device.type == "cpu":
        return _dw_value_and_grad(potential, cutoff, pc_t, mu_g, mf_g, offs, mui_g)
    _check_window_dipole(potential, pc_t, mu_g, mf_g, offs, mui_g)
    with torch.no_grad():
        e, d_pc, d_mu, d_offs, d_mui = window_dipole(
            pc_t, mu_g, mf_g, offs, mui_g, *_dipole_table(potential), cutoff
        )
    return e, (d_pc, d_mu, d_offs, d_mui) if mui_g is not None else (d_pc, d_mu, d_offs)


def _dipole_window_energy(potential, pc_t, mu_g, mf_g, offs, cutoff, plain, mui_g=None):
    """Raw window energy (the entry points poison it when stale).

    A potential with an exclusion window or a parameter that requires grad
    has no analytic gradient (and no kernel): it takes the plain autograd
    :func:`_dw_math`, on the CPU or with ``plain=True``; on a card without
    ``plain=True`` it raises, as the JAX package's ``window_impl="pallas"``
    does for such a potential.
    """
    _k.refuse_batched("the dipolar cell-list window (kernel G)", pc_t, mu_g, mui_g)
    if _can_use_analytic_dipole(potential):
        return _WindowDipole.apply(
            pc_t, mu_g, mf_g, offs, mui_g, *_dipole_table(potential), cutoff, plain
        )[0]
    if pc_t.device.type != "cpu" and not plain:
        raise ValueError(
            "the dipolar window kernel needs concrete potential parameters and no "
            "exclusion window (it produces no parameter cotangents); pass "
            "plain=True to run the plain autograd window on this device"
        )
    return _dw_math(potential, cutoff, pc_t, mu_g, mf_g, offs, mui_g)


# -- spill side list -------------------------------------------------------------


def _extras_dipole_energy(potential, pc_t, mu_g, mf_g, pe, pe_abs, mue, clist, cell):
    r"""Total dipolar energy of the spill pairs, by plain autograd (the
    extras are a few % of the atoms by construction).

    Same structure as :func:`~torchpme_tpu_torch.ops.rspace_cells._extras_energy`
    (extra ↔ bucketed over the 27-cell window of each extra's home cell,
    extra ↔ extra by fractional minimum image) with the scalar pair value
    replaced by :math:`B\,(\mu_i\cdot\mu_j) − C\,(\mu_i\cdot r)(\mu_j\cdot
    r)`.  Each extra↔bucket ordered pair is the unordered pair counted once;
    extra↔extra pairs appear in both directions, hence the ½.
    """
    scalars = _scalar_hooks(potential)[0]
    dtype, device = pc_t.dtype, pc_t.device
    nx, ny, nz, _, cap = pc_t.shape
    n_cells = nx * ny * nz
    n_axis = torch.tensor([nx, ny, nz], dtype=dtype, device=device)
    cut2 = torch.tensor(clist.cutoff, dtype=dtype, device=device) ** 2
    e_pad = pe.shape[0]
    w27 = 27 * cap

    d27 = torch.tensor(_D27, device=device)  # (27, 3)
    nb3 = torch.remainder(
        clist.extra_cell.long()[:, None, :] + d27[None],
        torch.tensor([nx, ny, nz], device=device),
    )
    ids = (nb3[..., 0] * ny + nb3[..., 1]) * nz + nb3[..., 2]  # (E, 27)
    rows_p = pc_t.reshape(n_cells, 3, cap)[ids].transpose(1, 2).reshape(e_pad, 3, w27)
    rows_mu = mu_g.reshape(n_cells, cap, 3)[ids].reshape(e_pad, w27, 3)
    rows_m = mf_g.reshape(n_cells, cap)[ids].reshape(e_pad, w27)
    offv = torch.matmul(d27.to(dtype) / n_axis, cell)
    off_flat = offv.T.repeat_interleave(cap, dim=1)  # (3, 27·cap)
    # r = p_bucket − p_extra, (E, 27·cap) per component
    rv = [rows_p[:, c, :] + off_flat[c][None, :] - pe[:, c, None] for c in range(3)]
    d2 = rv[0] ** 2 + rv[1] ** 2 + rv[2] ** 2
    ok = (d2 < cut2) & (rows_m > 0.5) & clist.extra_mask[:, None]
    b, c_ = scalars(torch.sqrt(torch.where(ok, d2, 1.0)))
    mumu = sum(mue[:, c, None] * rows_mu[..., c] for c in range(3))
    ri = sum(mue[:, c, None] * rv[c] for c in range(3))
    rj = sum(rows_mu[..., c] * rv[c] for c in range(3))
    e_em = torch.sum(ok.to(dtype) * (b * mumu - c_ * ri * rj))

    # extra ↔ extra: fractional minimum image, (E, E) planes per axis
    f = torch.matmul(pe_abs, inv3(cell))  # (E, 3)
    g = []
    for c in range(3):
        df = f[:, c][:, None] - f[:, c][None, :]
        g.append(df - torch.round(df))
    rvec = [g[0] * cell[0, d] + g[1] * cell[1, d] + g[2] * cell[2, d] for d in range(3)]
    d2e = rvec[0] ** 2 + rvec[1] ** 2 + rvec[2] ** 2
    m_ee = clist.extra_mask[:, None] & clist.extra_mask[None, :]
    eye = torch.eye(e_pad, dtype=torch.bool, device=device)
    ok_ee = (d2e < cut2) & m_ee & ~eye
    b_ee, c_ee = scalars(torch.sqrt(torch.where(ok_ee, d2e, 1.0)))
    ri_ee = sum(mue[:, d, None] * rvec[d] for d in range(3))
    rj_ee = sum(mue[None, :, d] * rvec[d] for d in range(3))
    e_ee = 0.5 * torch.sum(
        ok_ee.to(dtype) * (b_ee * (mue @ mue.T) - c_ee * ri_ee * rj_ee)
    )
    return e_em + e_ee


# -- entry points ------------------------------------------------------------------


def cell_list_rspace_dipole_energy_rows(
    potential,
    dipoles: torch.Tensor,
    pos_rows: torch.Tensor,
    cell: torch.Tensor,
    clist: CellList,
    plain: bool = False,
) -> torch.Tensor:
    r"""Real-space dipolar energy from positions in bucket-row order
    (``(n_cells·cap [+ E_pad], 3)``, the
    :meth:`~torchpme_tpu_torch.md.MDFastPathDipole.bucket` layout).

    Each unordered pair within the cutoff is counted exactly once; the
    potential's ``smearing`` decides the short-range vs direct scalars.
    Differentiable with respect to ``dipoles`` (atom order, ``(N, 3)``),
    ``pos_rows`` and ``cell``.  NaN (value and gradients) when the bucketing
    is stale.

    :param plain: run the window's plain version on any device (the
        reference path of the comparisons); by default CPU tensors take it
        and CUDA tensors kernel G.  The JAX package's
        ``window_impl="xla"|"pallas"`` string is this flag.
    """
    n_cells, cap = clist.slot_mask.shape
    nb = n_cells * cap
    dtype = pos_rows.dtype
    mu = dipoles.to(dtype)
    pc_t, mu_g, mf_g, offs, valid = _prepare_bucketed(
        mu.index_select(0, clist.atom_index.reshape(-1).long()).reshape(n_cells, cap, 3),
        pos_rows[:nb].reshape(n_cells, cap, 3),
        cell,
        clist,
    )
    e0 = _dipole_window_energy(potential, pc_t, mu_g, mf_g, offs, clist.cutoff, plain)
    if clist.extra_index is not None:
        pe, pe_abs, mue, valid_e = _prepare_extras_bucketed(
            mu.index_select(0, clist.extra_index.long()),
            pos_rows[nb:].reshape(-1, 3),
            cell,
            clist,
        )
        e0 = e0 + _extras_dipole_energy(
            potential, pc_t, mu_g, mf_g, pe, pe_abs, mue, clist, cell
        )
        valid = valid & valid_e
    # NaN-poison through a multiply so gradients are poisoned too
    return e0 * torch.where(valid, 1.0, float("nan")).to(e0.dtype)


def cell_list_rspace_dipole_energy(
    potential,
    dipoles: torch.Tensor,
    positions: torch.Tensor,
    cell: torch.Tensor,
    clist: CellList,
    plain: bool = False,
) -> torch.Tensor:
    r"""Real-space dipolar energy from atom-order ``positions``: one gather
    into bucket rows, then :func:`cell_list_rspace_dipole_energy_rows` (same
    value and gradients up to the row permutation).  Matches
    ``sum(CalculatorDipole._compute_rspace(...) * dipoles)`` on the same
    pair set."""
    rows = positions.index_select(0, clist.atom_index.reshape(-1).long())
    if clist.extra_index is not None:
        rows = torch.cat([rows, positions.index_select(0, clist.extra_index.long())], dim=0)
    return cell_list_rspace_dipole_energy_rows(
        potential, dipoles, rows, cell, clist, plain=plain
    )
