r"""Tile spread, gather and weight gradient: kernels D, E, F and their plain
versions.

Counterpart of :mod:`torchpme_tpu.ops.pallas.mesh_pallas`.  All three work on
the arrays of a :class:`~torchpme_tpu_torch.ops.mesh_tiled.TiledInterpolation`
(``lx``, ``ly``, ``sz`` ``(T, K)`` int32, ``weights`` ``(T, K, 3, n)``) and on
per-slot values in the ``(T, C, K)`` layout:

* **D** (:func:`mesh_spread`): per-slot charges → the periodic
  ``(C, nx, ny, nz)`` mesh; its dipole form (:func:`mesh_spread_dipole`)
  spreads per-slot effective dipoles ``ν (T, 3, K)`` as the gradient density
  ``Σ_a ν_a ∂_a[W_x W_y W_z]`` from the weights and their derivatives in one
  pass per slot;
* **E** (:func:`mesh_gather`): mesh → per-slot values, the exact transpose;
* **F** (:func:`mesh_wgrad`): the weight cotangent of the shared trilinear
  form :math:`S(w; q, F) = \sum_{c,k} q_{kc} \sum_{xyz} w_x w_y w_z F_{xyz,c}`,
  which backs the backward of both D (``F`` = mesh cotangent) and E (``q`` =
  output cotangent).  :func:`mesh_gather_wgrad` gives E and F from one pass
  over the mesh windows (one launch, counted for both).

E and F have a dipole form too, each slot read once:
:func:`mesh_gather_dipole` gives the three gradient-stencil values
``Σ ∂_a[W_x W_y W_z] F`` per slot ``(T, 3, K)``, and :func:`mesh_wgrad_dipole`
the cotangents of the weights and of their derivatives of
:math:`S = \sum_k \sum_a \nu_{ka} \sum_{xyz} \partial_a[W_x W_y W_z] F`;
:func:`mesh_gather_wgrad_dipole` gives both from one launch.

The TPU kernels emit per-tile fields ``(T, E², C·nz)`` that a fold assembles
into the mesh, because TPU scatters serialize.  The CUDA kernels
(``csrc/mesh.cu``) add into, and read from, the periodic mesh directly, so
the functions here go from slots to mesh and back; the plain versions have
the same signatures and do the TPU package's arithmetic: dense per-tile
weight factors, one batched matmul per tile, and the parity-class fold (or
the window extraction); the dipole forms' plain versions are the charge
form's over every slot three times (copy ``a`` with the axis-``a``
derivative, the JAX package's three stencils).  A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises (float32 only).

The wrappers are the ops ``torch.ops.tpme.mesh_spread``, ..., registered in
C++ (``csrc/tpme_ops.cpp``: their CUDA kernels check the operands, build the
parameters, the z chunk of E and F among them, and launch), with the plain
versions as their CPU kernels and the autograd and vmap rules registered
here.  Each takes one system or a batch with leading axes: under
``torch.func.vmap`` (the JAX package's kernels get it from ``pallas_call``'s
batching rule) the whole batch goes through one launch of each kernel, and
the plain versions take the same leading axes on the CPU.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import Tensor

from .. import kernels as _k
from .mesh_tiled import (
    TILE,
    TiledInterpolation,
    _dense_factors,
    _dipole_triple,
    _extract_tiles_from_mesh,
    _fold_tiles_to_mesh,
)

__all__ = [
    "gather_dipole_fields",
    "gather_tiles",
    "mesh_gather",
    "mesh_gather_dipole",
    "mesh_gather_dipole_plain",
    "mesh_gather_plain",
    "mesh_gather_wgrad",
    "mesh_gather_wgrad_dipole",
    "mesh_gather_wgrad_dipole_plain",
    "mesh_spread",
    "mesh_spread_dipole",
    "mesh_spread_dipole_plain",
    "mesh_spread_plain",
    "mesh_wgrad",
    "mesh_wgrad_dipole",
    "mesh_wgrad_dipole_plain",
    "mesh_wgrad_plain",
    "spread_dipoles",
    "spread_tiles",
]


# -- plain versions -------------------------------------------------------------
# Each takes the bucketing arrays of one system, ``lx (T, K)``, or of a batch
# with any leading axes, ``lx (..., T, K)``, with every other operand carrying
# the same leading axes: the tiles of all systems go through one batched
# matmul, and the fold (or the window extraction) keeps the systems apart.


def _flat(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Merge ``lead`` leading batch axes into the tile axis."""
    return x.reshape(-1, *x.shape[lead + 1 :])


def _charge_z(wz: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``(T, K, nz·C)`` charge-weighted z factors from ``wz (T, K, nz)`` and
    ``q (T, C, K)`` (z-major, channel-minor)."""
    return (wz[..., None] * q.transpose(1, 2)[:, :, None, :]).flatten(2)


def _xy_factors(lx, ly, sz, weights, ns, nodes: int):
    """Dense ``wxy (T', K, E²)`` and ``wz (T', K, nz)`` of the tiles of all
    systems (``T' = T·B``)."""
    lead = lx.dim() - 2
    e, k = TILE + nodes - 1, lx.shape[-1]
    wx, wy, wz = _dense_factors(
        _flat(lx, lead), _flat(ly, lead), _flat(sz, lead), _flat(weights, lead), ns, nodes
    )
    return (wx[:, :, :, None] * wy[:, :, None, :]).reshape(-1, k, e * e), wz


def mesh_spread_plain(lx, ly, sz, weights, q_slots, ns, nodes: int) -> torch.Tensor:
    """Plain version of kernel D: ``(..., T, C, K)`` per-slot charges →
    ``(..., C, nx, ny, nz)`` mesh."""
    lead, (t, _) = lx.shape[:-2], lx.shape[-2:]
    e, nz, n_ch = TILE + nodes - 1, ns[2], q_slots.shape[-2]
    wxy, wz = _xy_factors(lx, ly, sz, weights, ns, nodes)
    q = _flat(q_slots, len(lead))
    tiles = torch.bmm(wxy.transpose(1, 2), _charge_z(wz, q))  # (T', E², nz·C)
    return _fold_tiles_to_mesh(tiles.reshape(*lead, t, e, e, nz, n_ch), ns, e).contiguous()


def mesh_spread_dipole_plain(
    lx, ly, sz, weights, dweights, nu_slots, ns, nodes: int
) -> torch.Tensor:
    """Plain version of kernel D's dipole form: ``(..., T, 3, K)`` per-slot
    effective dipoles → ``(..., 1, nx, ny, nz)`` gradient density, the charge
    form over every slot three times (copy ``a`` with the axis-``a``
    derivative)."""
    *lead, t, _, k = nu_slots.shape
    return mesh_spread_plain(
        *_dipole_triple(lx, ly, sz, weights, dweights), nu_slots.reshape(*lead, t, 1, 3 * k),
        ns, nodes,
    )


def mesh_gather_plain(lx, ly, sz, weights, mesh, ns, nodes: int) -> torch.Tensor:
    """Plain version of kernel E: ``(..., C, nx, ny, nz)`` mesh → ``(..., T,
    C, K)`` per-slot values."""
    lead, (t, k) = lx.shape[:-2], lx.shape[-2:]
    e, nz, n_ch = TILE + nodes - 1, ns[2], mesh.shape[-4]
    wxy, wz = _xy_factors(lx, ly, sz, weights, ns, nodes)
    tiles = _extract_tiles_from_mesh(mesh, ns, nodes).reshape(-1, e * e, nz * n_ch)
    partial = torch.bmm(wxy, tiles).reshape(-1, k, nz, n_ch)  # xy contracted
    return torch.einsum("tkz,tkzc->tck", wz, partial).reshape(*lead, t, n_ch, k).contiguous()


def _select_nodes(values: torch.Tensor, start: torch.Tensor, nodes: int, wrap: int | None):
    """``(T, K, n)``: entry ``start + o`` of each slot's ``(T, K, L)`` line
    (mod ``wrap`` when given; 0 beyond the line otherwise)."""
    length = values.shape[-1]
    target = start.long()[..., None] + torch.arange(nodes, device=start.device)
    if wrap is not None:
        return torch.gather(values, 2, torch.remainder(target, wrap))
    inside = target < length
    picked = torch.gather(values, 2, torch.clamp(target, max=length - 1))
    return torch.where(inside, picked, 0.0)


def mesh_wgrad_plain(lx, ly, sz, weights, q_slots, mesh, ns, nodes: int) -> torch.Tensor:
    r"""Plain version of kernel F: :math:`\partial S/\partial w`, ``(..., T, K,
    3, n)``, for ``q (..., T, C, K)`` and the ``(..., C, nx, ny, nz)`` field."""
    lead, (t, k) = lx.shape[:-2], lx.shape[-2:]
    e, nz, n_ch = TILE + nodes - 1, ns[2], mesh.shape[-4]
    wx, wy, wz = _dense_factors(*(_flat(a, len(lead)) for a in (lx, ly, sz, weights)), ns, nodes)
    q = _flat(q_slots, len(lead))
    tiles = _extract_tiles_from_mesh(mesh, ns, nodes).reshape(-1, e * e, nz * n_ch)
    # Fz[xy, k] = Σ_zc F[xy, zc] wz[k, z] q[c, k]
    fz = torch.bmm(tiles, _charge_z(wz, q).transpose(1, 2)).reshape(-1, e, e, k)
    a_x = (fz * wy.transpose(1, 2)[:, None, :, :]).sum(2)  # (T', E, K), y contracted
    b_y = (fz * wx.transpose(1, 2)[:, :, None, :]).sum(1)  # (T', E, K), x contracted
    # H[k, z] = Σ_c q[c, k] Σ_xy wxy[k, xy] F[xy, z, c]
    wxy = (wx[:, :, :, None] * wy[:, :, None, :]).reshape(-1, k, e * e)
    h = torch.bmm(wxy, tiles).reshape(-1, k, nz, n_ch)
    hq = torch.einsum("tkzc,tck->tkz", h, q)
    flat = (_flat(lx, len(lead)), _flat(ly, len(lead)), _flat(sz, len(lead)))
    return torch.stack(
        [
            _select_nodes(a_x.transpose(1, 2), flat[0], nodes, None),
            _select_nodes(b_y.transpose(1, 2), flat[1], nodes, None),
            _select_nodes(hq, flat[2], nodes, nz),
        ],
        dim=2,
    ).reshape(*lead, t, k, 3, nodes)


def _untriple(ct_w3: torch.Tensor, capacity: int):
    """Cotangents of ``(weights, dweights)`` from those of the tripled slots'
    weights ``(..., T, 3K, 3, n)``: copy ``a`` carries the derivative on axis
    ``a`` and the weights on the other two."""
    *lead, t, _, _, n = ct_w3.shape
    parts = ct_w3.reshape(*lead, t, 3, capacity, 3, n)  # (..., T, copy, K, axis, n)
    ct_dw = torch.stack([parts[..., a, :, a, :] for a in range(3)], dim=-2)
    ct_w = torch.stack(
        [sum(parts[..., b, :, a, :] for b in range(3) if b != a) for a in range(3)], dim=-2
    )
    return ct_w, ct_dw


def mesh_gather_dipole_plain(lx, ly, sz, weights, dweights, mesh, ns, nodes: int):
    """Plain version of kernel E's dipole form: ``(..., 1, nx, ny, nz)`` mesh
    → ``(..., T, 3, K)`` per-slot gradient-stencil values, the charge form
    over every slot three times."""
    *lead, t, k = lx.shape
    vals = mesh_gather_plain(*_dipole_triple(lx, ly, sz, weights, dweights), mesh, ns, nodes)
    return vals.reshape(*lead, t, 3, k)


def mesh_wgrad_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes: int):
    """Plain version of kernel F's dipole form: the cotangents ``(ct_w,
    ct_dw)``, each ``(..., T, K, 3, n)``, of the weights and their derivatives
    for per-slot ``ν (..., T, 3, K)`` and the ``(..., 1, nx, ny, nz)`` field,
    the charge form over every slot three times with the copies' cotangents
    folded back."""
    *lead, t, _, k = nu_slots.shape
    ct_w3 = mesh_wgrad_plain(
        *_dipole_triple(lx, ly, sz, weights, dweights), nu_slots.reshape(*lead, t, 1, 3 * k),
        mesh, ns, nodes,
    )
    return _untriple(ct_w3, k)


def mesh_gather_wgrad_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes: int):
    """Plain version of :func:`mesh_gather_wgrad_dipole`: ``(values, ct_w,
    ct_dw)``."""
    args = (lx, ly, sz, weights, dweights)
    return (
        mesh_gather_dipole_plain(*args, mesh, ns, nodes),
        *mesh_wgrad_dipole_plain(*args, nu_slots, mesh, ns, nodes),
    )


# -- kernels D, E, F: the ops ------------------------------------------------------
# Each of D, E, F, E + F (charge and dipole forms) is a ``tpme::`` op whose
# CUDA kernel launches the kernel (float32 only; it launches or raises) and
# whose CPU kernel is the plain version (``kernels.call(..., plain=True)`` on
# any device).  Every op takes the ``(T, K)`` arrays of one system or the
# ``(..., T, K)`` arrays of a batch, which its vmap rule builds: the batch
# dimension moves to the front (an unbatched operand is expanded to it) and
# the op runs once, so a ``torch.func.vmap`` over systems launches each
# kernel once.  The fakes give the shapes (``torch.export``, where no library
# gives its Meta kernels), the autograd the VJPs of the differentiable ones:
# the spread's is the gather and the weight gradient, the gather's the
# spread and the weight gradient, as in the JAX package.


@_k.plain_version("mesh_spread")
def _mesh_spread_cpu(lx, ly, sz, weights, q_slots, ns, nodes):
    return mesh_spread_plain(lx, ly, sz, weights, q_slots, tuple(ns), nodes)


@_k.plain_version("mesh_spread_dipole")
def _mesh_spread_dipole_cpu(lx, ly, sz, weights, dweights, nu_slots, ns, nodes):
    return mesh_spread_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, tuple(ns), nodes)


@_k.plain_version("mesh_gather")
def _mesh_gather_cpu(lx, ly, sz, weights, mesh, ns, nodes):
    return mesh_gather_plain(lx, ly, sz, weights, mesh, tuple(ns), nodes)


@_k.plain_version("mesh_wgrad")
def _mesh_wgrad_cpu(lx, ly, sz, weights, q_slots, mesh, ns, nodes):
    return mesh_wgrad_plain(lx, ly, sz, weights, q_slots, mesh, tuple(ns), nodes)


@_k.plain_version("mesh_gather_wgrad")
def _mesh_gather_wgrad_cpu(lx, ly, sz, weights, q_slots, mesh, ns, nodes):
    ns = tuple(ns)
    return (mesh_gather_plain(lx, ly, sz, weights, mesh, ns, nodes),
            mesh_wgrad_plain(lx, ly, sz, weights, q_slots, mesh, ns, nodes))


@_k.plain_version("mesh_gather_dipole")
def _mesh_gather_dipole_cpu(lx, ly, sz, weights, dweights, mesh, ns, nodes):
    return mesh_gather_dipole_plain(lx, ly, sz, weights, dweights, mesh, tuple(ns), nodes)


@_k.plain_version("mesh_wgrad_dipole")
def _mesh_wgrad_dipole_cpu(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes):
    return mesh_wgrad_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, mesh, tuple(ns),
                                   nodes)


@_k.plain_version("mesh_gather_wgrad_dipole")
def _mesh_gather_wgrad_dipole_cpu(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes):
    return mesh_gather_wgrad_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, mesh,
                                          tuple(ns), nodes)


#: kernel D: ``(T, C, K)`` per-slot charges → ``(C, nx, ny, nz)`` mesh
mesh_spread = _k.tpme_op("mesh_spread")
#: kernel D's dipole form: ``(T, 3, K)`` per-slot effective dipoles → ``(1,
#: nx, ny, nz)`` gradient density, each slot read once
mesh_spread_dipole = _k.tpme_op("mesh_spread_dipole")
#: kernel E: ``(C, nx, ny, nz)`` mesh → ``(T, C, K)`` per-slot values
mesh_gather = _k.tpme_op("mesh_gather")
#: kernel F: the weight cotangent ``(T, K, 3, n)`` of the trilinear form for
#: ``q (T, C, K)`` and the ``(C, nx, ny, nz)`` field
mesh_wgrad = _k.tpme_op("mesh_wgrad")
#: kernels E and F from one pass over the mesh windows: ``(values (T, C, K),
#: weight cotangent (T, K, 3, n))``; one launch, counted once for each
mesh_gather_wgrad = _k.tpme_op("mesh_gather_wgrad")
#: kernel E's dipole form: ``(1, nx, ny, nz)`` mesh → ``(T, 3, K)`` per-slot
#: values ``Σ ∂_a[W_x W_y W_z] F``, each slot read once
mesh_gather_dipole = _k.tpme_op("mesh_gather_dipole")
#: kernel F's dipole form: the cotangents ``(ct_w, ct_dw)``, each ``(T, K, 3,
#: n)``, of the weights and their derivatives for ``ν (T, 3, K)`` and the
#: ``(1, nx, ny, nz)`` field, each slot read once
mesh_wgrad_dipole = _k.tpme_op("mesh_wgrad_dipole")
#: the dipole forms of kernels E and F from one launch: ``(values (T, 3, K),
#: ct_w, ct_dw)``
mesh_gather_wgrad_dipole = _k.tpme_op("mesh_gather_wgrad_dipole")


def _vmap_rule(name: str, n_out: int):
    """Register op ``name``'s vmap rule: one call on the batch-leading
    operands."""
    op = _k.tpme_op(name)

    def rule(info, in_dims, *args):
        moved = []
        for arg, dim in zip(args, in_dims):
            if isinstance(arg, torch.Tensor):
                arg = (arg.movedim(dim, 0) if dim is not None
                       else arg.expand(info.batch_size, *arg.shape)).contiguous()
            moved.append(arg)
        return op(*moved), (0,) * n_out if n_out > 1 else 0

    torch.library.register_vmap(f"tpme::{name}", rule)


# fake kernels: shapes and dtypes only; a batch keeps its leading axes


def _mesh_like(weights, lx, n_ch, ns):
    return weights.new_empty((*lx.shape[:-2], n_ch, *ns))


def _slots_like(weights, lx, n_vals):
    *lead, t, k = lx.shape
    return weights.new_empty((*lead, t, n_vals, k))


_FAKES = {
    "mesh_spread": lambda lx, ly, sz, weights, q_slots, ns, nodes:
        _mesh_like(weights, lx, q_slots.shape[-2], ns),
    "mesh_spread_dipole": lambda lx, ly, sz, weights, dweights, nu_slots, ns, nodes:
        _mesh_like(weights, lx, 1, ns),
    "mesh_gather": lambda lx, ly, sz, weights, mesh, ns, nodes:
        _slots_like(weights, lx, mesh.shape[-4]),
    "mesh_wgrad": lambda lx, ly, sz, weights, q_slots, mesh, ns, nodes:
        torch.empty_like(weights),
    "mesh_gather_wgrad": lambda lx, ly, sz, weights, q_slots, mesh, ns, nodes:
        (_slots_like(weights, lx, mesh.shape[-4]), torch.empty_like(weights)),
    "mesh_gather_dipole": lambda lx, ly, sz, weights, dweights, mesh, ns, nodes:
        _slots_like(weights, lx, 3),
    "mesh_wgrad_dipole": lambda lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes:
        (torch.empty_like(weights), torch.empty_like(weights)),
    "mesh_gather_wgrad_dipole": lambda lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes:
        (_slots_like(weights, lx, 3), torch.empty_like(weights), torch.empty_like(weights)),
}
for _name, _fake in _FAKES.items():
    _k.register_fake(_name)(_fake)

for _name, _n_out in (("mesh_spread", 1), ("mesh_spread_dipole", 1), ("mesh_gather", 1),
                      ("mesh_wgrad", 1), ("mesh_gather_wgrad", 2), ("mesh_gather_dipole", 1),
                      ("mesh_wgrad_dipole", 2), ("mesh_gather_wgrad_dipole", 3)):
    _vmap_rule(_name, _n_out)


# -- VJPs ---------------------------------------------------------------------------
# The integer arrays get no cotangent; the VJP structure is that of the JAX
# package: spread's backward is gather + wgrad, gather's is spread + wgrad.
# Each backward takes its op's saved tensors and static arguments, the flags
# of the inputs that want a cotangent (in the op's argument order), and
# whether the plain versions run (an entry point's ``plain``).


def _spread_bwd(saved, static, needs, ct_mesh, plain):
    """``(ct_w, ct_q)`` of the charge-form spread: kernels E and F (one
    launch when both are wanted)."""
    lx, ly, sz, weights, q_slots = saved
    ns, nodes = static
    args = (lx, ly, sz, weights)
    want_w, want_q = needs
    ct_mesh = ct_mesh.contiguous()
    ct_w = ct_q = None
    if want_w and want_q:
        ct_q, ct_w = _k.call("mesh_gather_wgrad", *args, q_slots, ct_mesh, ns, nodes, plain=plain)
    elif want_q:
        ct_q = _k.call("mesh_gather", *args, ct_mesh, ns, nodes, plain=plain)
    elif want_w:
        ct_w = _k.call("mesh_wgrad", *args, q_slots, ct_mesh, ns, nodes, plain=plain)
    return ct_w, ct_q


def _spread_dipole_bwd(saved, static, needs, ct_mesh, plain):
    """``(ct_w, ct_dw, ct_nu)`` of the dipole-form spread: the dipole forms
    of kernels E and F (one launch when both are wanted), each slot read
    once."""
    lx, ly, sz, weights, dweights, nu_slots = saved
    ns, nodes = static
    args = (lx, ly, sz, weights, dweights)
    want_w, want_dw, want_nu = needs
    ct_mesh = ct_mesh.contiguous()
    ct_nu = ct_w = ct_dw = None
    if (want_w or want_dw) and want_nu:
        ct_nu, ct_w, ct_dw = _k.call("mesh_gather_wgrad_dipole", *args, nu_slots, ct_mesh,
                                     ns, nodes, plain=plain)
    elif want_nu:
        ct_nu = _k.call("mesh_gather_dipole", *args, ct_mesh, ns, nodes, plain=plain)
    elif want_w or want_dw:
        ct_w, ct_dw = _k.call("mesh_wgrad_dipole", *args, nu_slots, ct_mesh, ns, nodes,
                              plain=plain)
    return (ct_w if want_w else None), (ct_dw if want_dw else None), ct_nu


def _gather_bwd(saved, static, needs, ct_out, plain):
    """``(ct_w, ct_mesh)`` of the charge-form gather: kernel D spreads the
    cotangent, kernel F gives the weights'."""
    lx, ly, sz, weights, mesh = saved
    ns, nodes = static
    args = (lx, ly, sz, weights)
    want_w, want_mesh = needs
    ct_out = ct_out.contiguous()
    ct_w = ct_mesh = None
    if want_mesh:
        ct_mesh = _k.call("mesh_spread", *args, ct_out, ns, nodes, plain=plain)
    if want_w:
        ct_w = _k.call("mesh_wgrad", *args, ct_out, mesh, ns, nodes, plain=plain)
    return ct_w, ct_mesh


def _gather_dipole_bwd(saved, static, needs, ct_out, plain):
    """``(ct_w, ct_dw, ct_mesh)`` of the dipole-form gather: kernel D's
    dipole form spreads the cotangent, kernel F's gives the weights' and the
    derivatives'."""
    lx, ly, sz, weights, dweights, mesh = saved
    ns, nodes = static
    args = (lx, ly, sz, weights, dweights)
    want_w, want_dw, want_mesh = needs
    ct_out = ct_out.contiguous()
    ct_w = ct_dw = ct_mesh = None
    if want_mesh:
        ct_mesh = _k.call("mesh_spread_dipole", *args, ct_out, ns, nodes, plain=plain)
    if want_w or want_dw:
        ct_w, ct_dw = _k.call("mesh_wgrad_dipole", *args, ct_out, mesh, ns, nodes, plain=plain)
    return (ct_w if want_w else None), (ct_dw if want_dw else None), ct_mesh


def _autograd(name: str, backward, n_saved: int, diff: tuple[int, ...]):
    """Register op ``name``'s autograd: the first ``n_saved`` inputs are
    saved, the two after them are ``(ns, nodes)``; ``diff`` are the positions
    of the inputs that take a cotangent."""

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_saved])
        ns, nodes = inputs[n_saved:]
        ctx.static = (tuple(ns), nodes)

    def bwd(ctx, ct):
        grads = backward(ctx.saved_tensors, ctx.static,
                         [ctx.needs_input_grad[i] for i in diff], ct, ctx.plain)
        out = [None] * (n_saved + 2)
        for i, g in zip(diff, grads):
            out[i] = g
        return tuple(out)

    _k.register_autograd(name, bwd, setup_context)
    return setup_context, bwd


_SPREAD = _autograd("mesh_spread", _spread_bwd, 5, (3, 4))
_SPREAD_DIPOLE = _autograd("mesh_spread_dipole", _spread_dipole_bwd, 6, (3, 4, 5))
_GATHER = _autograd("mesh_gather", _gather_bwd, 5, (3, 4))
_GATHER_DIPOLE = _autograd("mesh_gather_dipole", _gather_dipole_bwd, 6, (3, 4, 5))


# -- differentiable entry points ----------------------------------------------------
# torch.func.grad (and vmap over it) refuses the autograd that custom ops
# register, so the entry points wrap each differentiable op in an
# autograd.Function of the ``setup_context`` form that runs the op and its
# registered VJP (``kernels.op_function``); its vmap rule is generated, so
# under vmap the op's own vmap rule makes the one batched launch, forward and
# backward.

_TileSpread = _k.op_function("_TileSpread", "mesh_spread", *_SPREAD)
_TileDipoleSpread = _k.op_function("_TileDipoleSpread", "mesh_spread_dipole", *_SPREAD_DIPOLE)
_TileGather = _k.op_function("_TileGather", "mesh_gather", *_GATHER)
_TileDipoleGather = _k.op_function("_TileDipoleGather", "mesh_gather_dipole", *_GATHER_DIPOLE)


def _arrays(interp: TiledInterpolation):
    return interp.local_x, interp.local_y, interp.start_z, interp.weights.contiguous()


def spread_tiles(
    interp: TiledInterpolation, q_slots: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Per-slot charges ``(T, C, K)`` → mesh ``(C, nx, ny, nz)`` (kernel D).

    Differentiable with respect to the charges and the stencil weights (and
    therefore, through the bucketing's refresh, the positions).
    """
    return _TileSpread.apply(*_arrays(interp), q_slots.contiguous(), interp.ns, interp.nodes,
                             plain)


def gather_tiles(
    interp: TiledInterpolation, mesh: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Mesh ``(C, nx, ny, nz)`` → per-slot values ``(T, C, K)`` (kernel E)."""
    return _TileGather.apply(*_arrays(interp), mesh.contiguous(), interp.ns, interp.nodes,
                             plain)


def spread_dipoles(
    interp: TiledInterpolation, nu_slots: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Per-slot effective dipoles ``(T, 3, K)`` → gradient density ``(1, nx,
    ny, nz)`` through kernel D's dipole form.  Differentiable with respect to
    ``nu_slots``, the weights and their derivatives (the dipole forms of
    kernels E and F)."""
    return _TileDipoleSpread.apply(
        *_arrays(interp), interp.dweights.contiguous(), nu_slots.contiguous(), interp.ns,
        interp.nodes, plain,
    )


def gather_dipole_fields(
    interp: TiledInterpolation, mesh: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Mesh ``(1, nx, ny, nz)`` → per-slot gradient fields ``(T, 3, K)``
    (kernel E's dipole form; the backward spreads with kernel D's dipole form
    and runs kernel F's)."""
    return _TileDipoleGather.apply(
        *_arrays(interp), interp.dweights.contiguous(), mesh.contiguous(), interp.ns,
        interp.nodes, plain,
    )
