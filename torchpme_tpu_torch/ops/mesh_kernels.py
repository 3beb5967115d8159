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
"""

from __future__ import annotations

import ctypes

import torch

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


def gather_z_chunk(nodes: int, n_ch: int) -> int:
    """Z cells a block of kernels E and F stages: 32, halved while the
    staged windows of all channels take more than 36 KB of shared memory
    (on an H100 the best of 16, 32 and 64 z cells at one and at three
    channels, ``chip_smoke.py --profile``: ``gather_design_sweep``).  0
    selects one thread a slot reading the mesh in device memory, which the
    kernel also takes where the staged block does not fit shared memory."""
    extent, zc = TILE + nodes - 1, 32
    while zc > 4 and n_ch * extent * extent * ((zc + nodes + 2) // 4) * 16 > 36 * 1024:
        zc //= 2
    return zc


# -- plain versions -------------------------------------------------------------


def _charge_z(wz: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``(T, K, nz·C)`` charge-weighted z factors from ``wz (T, K, nz)`` and
    ``q (T, C, K)`` (z-major, channel-minor)."""
    return (wz[..., None] * q.transpose(1, 2)[:, :, None, :]).flatten(2)


def mesh_spread_plain(lx, ly, sz, weights, q_slots, ns, nodes: int) -> torch.Tensor:
    """Plain version of kernel D: ``(T, C, K)`` per-slot charges →
    ``(C, nx, ny, nz)`` mesh."""
    t, k = lx.shape
    e, nz, n_ch = TILE + nodes - 1, ns[2], q_slots.shape[1]
    wx, wy, wz = _dense_factors(lx, ly, sz, weights, ns, nodes)
    wxy = (wx[:, :, :, None] * wy[:, :, None, :]).reshape(t, k, e * e)
    tiles = torch.bmm(wxy.transpose(1, 2), _charge_z(wz, q_slots))  # (T, E², nz·C)
    return _fold_tiles_to_mesh(tiles.reshape(t, e, e, nz, n_ch), ns, e)


def mesh_spread_dipole_plain(
    lx, ly, sz, weights, dweights, nu_slots, ns, nodes: int
) -> torch.Tensor:
    """Plain version of kernel D's dipole form: ``(T, 3, K)`` per-slot
    effective dipoles → ``(1, nx, ny, nz)`` gradient density, the charge form
    over every slot three times (copy ``a`` with the axis-``a`` derivative)."""
    t, _, k = nu_slots.shape
    return mesh_spread_plain(
        *_dipole_triple(lx, ly, sz, weights, dweights), nu_slots.reshape(t, 1, 3 * k), ns,
        nodes,
    )


def mesh_gather_plain(lx, ly, sz, weights, mesh, ns, nodes: int) -> torch.Tensor:
    """Plain version of kernel E: ``(C, nx, ny, nz)`` mesh → ``(T, C, K)``
    per-slot values."""
    t, k = lx.shape
    e, nz, n_ch = TILE + nodes - 1, ns[2], mesh.shape[0]
    wx, wy, wz = _dense_factors(lx, ly, sz, weights, ns, nodes)
    wxy = (wx[:, :, :, None] * wy[:, :, None, :]).reshape(t, k, e * e)
    tiles = _extract_tiles_from_mesh(mesh, ns, nodes).reshape(t, e * e, nz * n_ch)
    partial = torch.bmm(wxy, tiles).reshape(t, k, nz, n_ch)  # xy contracted
    return torch.einsum("tkz,tkzc->tck", wz, partial)


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
    r"""Plain version of kernel F: :math:`\partial S/\partial w`, ``(T, K, 3, n)``,
    for ``q (T, C, K)`` and the ``(C, nx, ny, nz)`` field."""
    t, k = lx.shape
    e, nz, n_ch = TILE + nodes - 1, ns[2], mesh.shape[0]
    wx, wy, wz = _dense_factors(lx, ly, sz, weights, ns, nodes)
    tiles = _extract_tiles_from_mesh(mesh, ns, nodes).reshape(t, e * e, nz * n_ch)
    # Fz[xy, k] = Σ_zc F[xy, zc] wz[k, z] q[c, k]
    fz = torch.bmm(tiles, _charge_z(wz, q_slots).transpose(1, 2)).reshape(t, e, e, k)
    a_x = (fz * wy.transpose(1, 2)[:, None, :, :]).sum(2)  # (T, E, K), y contracted
    b_y = (fz * wx.transpose(1, 2)[:, :, None, :]).sum(1)  # (T, E, K), x contracted
    # H[k, z] = Σ_c q[c, k] Σ_xy wxy[k, xy] F[xy, z, c]
    wxy = (wx[:, :, :, None] * wy[:, :, None, :]).reshape(t, k, e * e)
    h = torch.bmm(wxy, tiles).reshape(t, k, nz, n_ch)
    hq = torch.einsum("tkzc,tck->tkz", h, q_slots)
    return torch.stack(
        [
            _select_nodes(a_x.transpose(1, 2), lx, nodes, None),
            _select_nodes(b_y.transpose(1, 2), ly, nodes, None),
            _select_nodes(hq, sz, nodes, nz),
        ],
        dim=2,
    )


def _untriple(ct_w3: torch.Tensor, capacity: int):
    """Cotangents of ``(weights, dweights)`` from those of the tripled slots'
    weights ``(T, 3K, 3, n)``: copy ``a`` carries the derivative on axis
    ``a`` and the weights on the other two."""
    parts = ct_w3.reshape(ct_w3.shape[0], 3, capacity, 3, -1)  # (T, copy, K, axis, n)
    ct_dw = torch.stack([parts[:, a, :, a] for a in range(3)], dim=2)
    ct_w = torch.stack(
        [sum(parts[:, b, :, a] for b in range(3) if b != a) for a in range(3)], dim=2
    )
    return ct_w, ct_dw


def mesh_gather_dipole_plain(lx, ly, sz, weights, dweights, mesh, ns, nodes: int):
    """Plain version of kernel E's dipole form: ``(1, nx, ny, nz)`` mesh →
    ``(T, 3, K)`` per-slot gradient-stencil values, the charge form over
    every slot three times."""
    t, k = lx.shape
    vals = mesh_gather_plain(*_dipole_triple(lx, ly, sz, weights, dweights), mesh, ns, nodes)
    return vals.reshape(t, 3, k)


def mesh_wgrad_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes: int):
    """Plain version of kernel F's dipole form: the cotangents ``(ct_w,
    ct_dw)``, each ``(T, K, 3, n)``, of the weights and their derivatives for
    per-slot ``ν (T, 3, K)`` and the ``(1, nx, ny, nz)`` field, the charge
    form over every slot three times with the copies' cotangents folded
    back."""
    t, _, k = nu_slots.shape
    ct_w3 = mesh_wgrad_plain(
        *_dipole_triple(lx, ly, sz, weights, dweights), nu_slots.reshape(t, 1, 3 * k), mesh,
        ns, nodes,
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


# -- kernels D, E, F --------------------------------------------------------------


def _check(lx, ly, sz, weights, ns, nodes: int, dipole: bool = False) -> tuple[int, int]:
    """Validate the bucketing arrays for the kernels; returns ``(T, K)``.
    The charge forms take 1 to 7 nodes (the P3M and Lagrange tables), the
    dipole forms 3 to 7 (the dipolar mesh is Lagrange-only)."""
    lo = 3 if dipole else 1
    if not lo <= nodes <= 7:
        form = "dipole forms of the mesh kernels are" if dipole else "mesh kernels are"
        raise ValueError(f"the {form} built for {lo} to 7 nodes, got {nodes}")
    nx, ny, _ = ns
    if nx % TILE or ny % TILE:
        raise ValueError(f"mesh {tuple(ns)} is not a whole number of {TILE}x{TILE} tiles")
    t, k = lx.shape
    if t != (nx // TILE) * (ny // TILE):
        raise ValueError(f"{t} tiles do not cover the {tuple(ns)} mesh")
    for name, arr in (("local_x", lx), ("local_y", ly), ("start_z", sz)):
        _k.check_cuda_tensor(arr, name, (t, k), torch.int32)
    _k.check_cuda_tensor(weights, "weights", (t, k, 3, nodes))
    return t, k


def _params(ns, nodes: int, t: int, k: int, n_ch: int) -> _k.MeshParams:
    p = _k.MeshParams()
    p.nx, p.ny, p.nz = ns
    p.nodes, p.extent, p.ty_count = nodes, TILE + nodes - 1, ns[1] // TILE
    p.n_tiles, p.cap, p.n_ch = t, k, n_ch
    p.z_chunk = gather_z_chunk(nodes, n_ch)
    return p


def _launch_spread(lx, ly, sz, weights, dweights, values, ns, nodes: int) -> torch.Tensor:
    """Kernel D over checked operands: ``values (T, C, K)`` charges, or with
    ``dweights`` the dipole form's ``ν (T, 3, K)`` (one output channel)."""
    t, k = lx.shape
    n_ch = 1 if dweights is not None else values.shape[1]
    dev = weights.device
    # the kernel adds into the mesh
    mesh = torch.zeros((n_ch, *ns), dtype=torch.float32, device=dev)
    p = _params(ns, nodes, t, k, n_ch)
    status = _k.load_library().lib.tpme_mesh_spread(
        lx.data_ptr(), ly.data_ptr(), sz.data_ptr(), weights.data_ptr(),
        None if dweights is None else dweights.data_ptr(), values.data_ptr(),
        mesh.data_ptr(), ctypes.byref(p), _k.stream_handle(dev),
    )
    _k.check_status(status, "mesh_spread")
    _k.MESH_SPREAD.launches += 1
    return mesh


def mesh_spread(lx, ly, sz, weights, q_slots, ns, nodes: int) -> torch.Tensor:
    """Kernel D: ``(T, C, K)`` per-slot charges → ``(C, nx, ny, nz)`` mesh.

    CPU tensors take :func:`mesh_spread_plain`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_spread_plain(lx, ly, sz, weights, q_slots, ns, nodes)
    t, k = _check(lx, ly, sz, weights, ns, nodes)
    _k.check_cuda_tensor(q_slots, "q_slots", (t, q_slots.shape[1], k))
    return _launch_spread(lx, ly, sz, weights, None, q_slots, ns, nodes)


def mesh_spread_dipole(lx, ly, sz, weights, dweights, nu_slots, ns, nodes: int) -> torch.Tensor:
    """Kernel D's dipole form: ``(T, 3, K)`` per-slot effective dipoles →
    ``(1, nx, ny, nz)`` gradient density, each slot read once.

    CPU tensors take :func:`mesh_spread_dipole_plain`; CUDA tensors launch
    the kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_spread_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, ns, nodes)
    t, k = _check(lx, ly, sz, weights, ns, nodes, dipole=True)
    _k.check_cuda_tensor(dweights, "dweights", (t, k, 3, nodes))
    _k.check_cuda_tensor(nu_slots, "nu_slots", (t, 3, k))
    return _launch_spread(lx, ly, sz, weights, dweights, nu_slots, ns, nodes)


def _launch_gather_wgrad(lx, ly, sz, weights, dweights, q_slots, mesh, ns, nodes, gather, wgrad):
    """Kernels E and/or F in one launch: the charge form, or with
    ``dweights`` the dipole form (``q_slots`` is then ``ν (T, 3, K)``).
    Returns ``(values, ct_w, ct_dw)``, ``None`` where not asked for."""
    dipole = dweights is not None
    t, k = _check(lx, ly, sz, weights, ns, nodes, dipole=dipole)
    n_ch = 1 if dipole else mesh.shape[0]
    _k.check_cuda_tensor(mesh, "mesh", (n_ch, *ns))
    if dipole:
        _k.check_cuda_tensor(dweights, "dweights", (t, k, 3, nodes))
    n_vals = 3 if dipole else n_ch
    dev = weights.device
    vals = wg = dwg = None
    if wgrad:
        _k.check_cuda_tensor(q_slots, "nu_slots" if dipole else "q_slots", (t, n_vals, k))
        wg = torch.empty((t, k, 3, nodes), dtype=torch.float32, device=dev)
        if dipole:
            dwg = torch.empty_like(wg)
    if gather:
        vals = torch.empty((t, n_vals, k), dtype=torch.float32, device=dev)
    p = _params(ns, nodes, t, k, n_ch)

    def ptr(x):
        return None if x is None else x.data_ptr()

    status = _k.load_library().lib.tpme_mesh_gather_wgrad(
        lx.data_ptr(), ly.data_ptr(), sz.data_ptr(), weights.data_ptr(), ptr(dweights),
        q_slots.data_ptr() if wgrad else None, mesh.data_ptr(), ptr(vals), ptr(wg), ptr(dwg),
        ctypes.byref(p), _k.stream_handle(dev),
    )
    _k.check_status(status, "mesh_gather_wgrad")
    if gather:
        _k.MESH_GATHER.launches += 1
    if wgrad:
        _k.MESH_WGRAD.launches += 1
    return vals, wg, dwg


def mesh_gather(lx, ly, sz, weights, mesh, ns, nodes: int) -> torch.Tensor:
    """Kernel E: ``(C, nx, ny, nz)`` mesh → ``(T, C, K)`` per-slot values.

    CPU tensors take :func:`mesh_gather_plain`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_gather_plain(lx, ly, sz, weights, mesh, ns, nodes)
    return _launch_gather_wgrad(lx, ly, sz, weights, None, None, mesh, ns, nodes, True, False)[0]


def mesh_wgrad(lx, ly, sz, weights, q_slots, mesh, ns, nodes: int) -> torch.Tensor:
    """Kernel F: the weight cotangent ``(T, K, 3, n)`` of the trilinear form
    for ``q (T, C, K)`` and the ``(C, nx, ny, nz)`` field.

    CPU tensors take :func:`mesh_wgrad_plain`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_wgrad_plain(lx, ly, sz, weights, q_slots, mesh, ns, nodes)
    return _launch_gather_wgrad(
        lx, ly, sz, weights, None, q_slots, mesh, ns, nodes, False, True
    )[1]


def mesh_gather_wgrad(lx, ly, sz, weights, q_slots, mesh, ns, nodes: int):
    """Kernels E and F from one pass over the mesh windows: ``(values
    (T, C, K), weight cotangent (T, K, 3, n))``.  On CUDA tensors this is one
    launch, counted once for each of the two kernels."""
    if weights.device.type == "cpu":
        return (
            mesh_gather_plain(lx, ly, sz, weights, mesh, ns, nodes),
            mesh_wgrad_plain(lx, ly, sz, weights, q_slots, mesh, ns, nodes),
        )
    return _launch_gather_wgrad(
        lx, ly, sz, weights, None, q_slots, mesh, ns, nodes, True, True
    )[:2]


def mesh_gather_dipole(lx, ly, sz, weights, dweights, mesh, ns, nodes: int) -> torch.Tensor:
    """Kernel E's dipole form: ``(1, nx, ny, nz)`` mesh → ``(T, 3, K)``
    per-slot values ``Σ ∂_a[W_x W_y W_z] F``, each slot read once.

    CPU tensors take :func:`mesh_gather_dipole_plain`; CUDA tensors launch
    the kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_gather_dipole_plain(lx, ly, sz, weights, dweights, mesh, ns, nodes)
    return _launch_gather_wgrad(
        lx, ly, sz, weights, dweights, None, mesh, ns, nodes, True, False
    )[0]


def mesh_wgrad_dipole(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes: int):
    """Kernel F's dipole form: the cotangents ``(ct_w, ct_dw)``, each ``(T,
    K, 3, n)``, of the weights and their derivatives for ``ν (T, 3, K)`` and
    the ``(1, nx, ny, nz)`` field, each slot read once.

    CPU tensors take :func:`mesh_wgrad_dipole_plain`; CUDA tensors launch
    the kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_wgrad_dipole_plain(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes)
    return _launch_gather_wgrad(
        lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes, False, True
    )[1:]


def mesh_gather_wgrad_dipole(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes: int):
    """The dipole forms of kernels E and F from one pass over the mesh
    windows: ``(values (T, 3, K), ct_w, ct_dw)``.  On CUDA tensors this is
    one launch, counted once for each of the two kernels."""
    if weights.device.type == "cpu":
        return mesh_gather_wgrad_dipole_plain(
            lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes
        )
    return _launch_gather_wgrad(
        lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes, True, True
    )


# -- differentiable entry points --------------------------------------------------
# The integer arrays get no cotangent; the VJP structure is that of the JAX
# package: spread's backward is gather + wgrad, gather's is spread + wgrad.


def _spread_vjp(args, q_slots, ct_mesh, ns, nodes, plain, want_w, want_q):
    """``(ct_q, ct_w)`` of the charge-form spread over ``args = (lx, ly, sz,
    weights)``: kernels E and F (one launch when both are wanted)."""
    ct_w = ct_q = None
    if plain:
        if want_q:
            ct_q = mesh_gather_plain(*args, ct_mesh, ns, nodes)
        if want_w:
            ct_w = mesh_wgrad_plain(*args, q_slots, ct_mesh, ns, nodes)
    elif want_w and want_q:
        ct_q, ct_w = mesh_gather_wgrad(*args, q_slots, ct_mesh, ns, nodes)
    elif want_q:
        ct_q = mesh_gather(*args, ct_mesh, ns, nodes)
    elif want_w:
        ct_w = mesh_wgrad(*args, q_slots, ct_mesh, ns, nodes)
    return ct_q, ct_w


class _TileSpread(torch.autograd.Function):
    """``(weights, q_slots) → mesh`` over kernel D (or, with ``plain``, the
    plain versions on any device)."""

    @staticmethod
    def forward(ctx, weights, q_slots, lx, ly, sz, ns, nodes, plain):
        ctx.save_for_backward(weights, q_slots, lx, ly, sz)
        ctx.static = (ns, nodes, plain)
        spread = mesh_spread_plain if plain else mesh_spread
        return spread(lx, ly, sz, weights, q_slots, ns, nodes)

    @staticmethod
    def backward(ctx, ct_mesh):
        weights, q_slots, lx, ly, sz = ctx.saved_tensors
        ns, nodes, plain = ctx.static
        want_w, want_q = ctx.needs_input_grad[:2]
        ct_q, ct_w = _spread_vjp(
            (lx, ly, sz, weights), q_slots, ct_mesh.contiguous(), ns, nodes, plain, want_w, want_q
        )
        return ct_w, ct_q, None, None, None, None, None, None


def _dipole_spread_vjp(args, nu_slots, ct_mesh, ns, nodes, plain, want_w, want_nu):
    """``(ct_nu, ct_w, ct_dw)`` of the dipole-form spread over ``args = (lx,
    ly, sz, weights, dweights)``: the dipole forms of kernels E and F (one
    launch when both are wanted), each slot read once."""
    ct_nu = ct_w = ct_dw = None
    if plain:
        if want_nu:
            ct_nu = mesh_gather_dipole_plain(*args, ct_mesh, ns, nodes)
        if want_w:
            ct_w, ct_dw = mesh_wgrad_dipole_plain(*args, nu_slots, ct_mesh, ns, nodes)
    elif want_w and want_nu:
        ct_nu, ct_w, ct_dw = mesh_gather_wgrad_dipole(*args, nu_slots, ct_mesh, ns, nodes)
    elif want_nu:
        ct_nu = mesh_gather_dipole(*args, ct_mesh, ns, nodes)
    elif want_w:
        ct_w, ct_dw = mesh_wgrad_dipole(*args, nu_slots, ct_mesh, ns, nodes)
    return ct_nu, ct_w, ct_dw


class _TileDipoleSpread(torch.autograd.Function):
    """``(weights, dweights, ν (T, 3, K)) → (1, nx, ny, nz)`` over kernel D's
    dipole form (or, with ``plain``, its plain version on any device).  The
    backward runs the dipole forms of kernels E and F."""

    @staticmethod
    def forward(ctx, weights, dweights, nu_slots, lx, ly, sz, ns, nodes, plain):
        ctx.save_for_backward(weights, dweights, nu_slots, lx, ly, sz)
        ctx.static = (ns, nodes, plain)
        spread = mesh_spread_dipole_plain if plain else mesh_spread_dipole
        return spread(lx, ly, sz, weights, dweights, nu_slots, ns, nodes)

    @staticmethod
    def backward(ctx, ct_mesh):
        weights, dweights, nu_slots, lx, ly, sz = ctx.saved_tensors
        ns, nodes, plain = ctx.static
        want_w, want_dw, want_nu = ctx.needs_input_grad[:3]
        ct_nu, ct_w, ct_dw = _dipole_spread_vjp(
            (lx, ly, sz, weights, dweights), nu_slots, ct_mesh.contiguous(), ns, nodes, plain,
            want_w or want_dw, want_nu,
        )
        return (ct_w if want_w else None, ct_dw if want_dw else None, ct_nu,
                None, None, None, None, None, None)


class _TileGather(torch.autograd.Function):
    """``(weights, mesh) → per-slot values`` over kernel E (or, with
    ``plain``, the plain versions on any device)."""

    @staticmethod
    def forward(ctx, weights, mesh, lx, ly, sz, ns, nodes, plain):
        mesh = mesh.contiguous()
        ctx.save_for_backward(weights, mesh, lx, ly, sz)
        ctx.static = (ns, nodes, plain)
        gather = mesh_gather_plain if plain else mesh_gather
        return gather(lx, ly, sz, weights, mesh, ns, nodes)

    @staticmethod
    def backward(ctx, ct_out):
        weights, mesh, lx, ly, sz = ctx.saved_tensors
        ns, nodes, plain = ctx.static
        ct_out = ct_out.contiguous()
        want_w, want_mesh = ctx.needs_input_grad[:2]
        args = (lx, ly, sz, weights)
        ct_w = ct_mesh = None
        if want_mesh:
            spread = mesh_spread_plain if plain else mesh_spread
            ct_mesh = spread(*args, ct_out, ns, nodes)
        if want_w:
            wgrad = mesh_wgrad_plain if plain else mesh_wgrad
            ct_w = wgrad(*args, ct_out, mesh, ns, nodes)
        return ct_w, ct_mesh, None, None, None, None, None, None


def spread_tiles(
    interp: TiledInterpolation, q_slots: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Per-slot charges ``(T, C, K)`` → mesh ``(C, nx, ny, nz)``.

    Differentiable with respect to the charges and the stencil weights (and
    therefore, through the bucketing's refresh, the positions).
    """
    return _TileSpread.apply(
        interp.weights.contiguous(), q_slots.contiguous(), interp.local_x, interp.local_y, interp.start_z,
        interp.ns, interp.nodes, plain,
    )


def gather_tiles(
    interp: TiledInterpolation, mesh: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Mesh ``(C, nx, ny, nz)`` → per-slot values ``(T, C, K)``."""
    return _TileGather.apply(
        interp.weights.contiguous(), mesh, interp.local_x, interp.local_y, interp.start_z,
        interp.ns, interp.nodes, plain,
    )


class _TileDipoleGather(torch.autograd.Function):
    """``(weights, dweights, mesh (1, nx, ny, nz)) → (T, 3, K)`` per-slot
    gradient fields over kernel E's dipole form (or, with ``plain``, the
    plain versions on any device).  The backward spreads the cotangent with
    kernel D's dipole form and runs kernel F's."""

    @staticmethod
    def forward(ctx, weights, dweights, mesh, lx, ly, sz, ns, nodes, plain):
        mesh = mesh.contiguous()
        ctx.save_for_backward(weights, dweights, mesh, lx, ly, sz)
        ctx.static = (ns, nodes, plain)
        gather = mesh_gather_dipole_plain if plain else mesh_gather_dipole
        return gather(lx, ly, sz, weights, dweights, mesh, ns, nodes)

    @staticmethod
    def backward(ctx, ct_out):
        weights, dweights, mesh, lx, ly, sz = ctx.saved_tensors
        ns, nodes, plain = ctx.static
        want_w, want_dw, want_mesh = ctx.needs_input_grad[:3]
        ct_out = ct_out.contiguous()
        args = (lx, ly, sz, weights, dweights)
        ct_w = ct_dw = ct_mesh = None
        if want_mesh:
            spread = mesh_spread_dipole_plain if plain else mesh_spread_dipole
            ct_mesh = spread(*args, ct_out, ns, nodes)
        if want_w or want_dw:
            wgrad = mesh_wgrad_dipole_plain if plain else mesh_wgrad_dipole
            ct_w, ct_dw = wgrad(*args, ct_out, mesh, ns, nodes)
        return (ct_w if want_w else None, ct_dw if want_dw else None, ct_mesh,
                None, None, None, None, None, None)


def spread_dipoles(
    interp: TiledInterpolation, nu_slots: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Per-slot effective dipoles ``(T, 3, K)`` → gradient density ``(1, nx,
    ny, nz)`` through kernel D's dipole form.  Differentiable with respect to
    ``nu_slots``, the weights and their derivatives (the dipole forms of
    kernels E and F)."""
    return _TileDipoleSpread.apply(
        interp.weights.contiguous(), interp.dweights.contiguous(), nu_slots.contiguous(),
        interp.local_x, interp.local_y, interp.start_z, interp.ns, interp.nodes, plain,
    )


def gather_dipole_fields(
    interp: TiledInterpolation, mesh: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Mesh ``(1, nx, ny, nz)`` → per-slot gradient fields ``(T, 3, K)``
    (kernel E's dipole form; the backward spreads with kernel D's dipole form
    and runs kernel F's)."""
    return _TileDipoleGather.apply(
        interp.weights.contiguous(), interp.dweights.contiguous(), mesh,
        interp.local_x, interp.local_y, interp.start_z, interp.ns, interp.nodes, plain,
    )
