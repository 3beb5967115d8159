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

The TPU kernels emit per-tile fields ``(T, E², C·nz)`` that a fold assembles
into the mesh, because TPU scatters serialize.  The CUDA kernels
(``csrc/mesh.cu``) add into, and read from, the periodic mesh directly, so
the functions here go from slots to mesh and back; the plain versions have
the same signatures and do the TPU package's arithmetic: dense per-tile
weight factors, one batched matmul per tile, and the parity-class fold (or
the window extraction); the dipole form's plain version is the charge form's
over every slot three times (:func:`~torchpme_tpu_torch.ops.mesh_tiled.dipole_slots`).
A wrapper takes the plain version only for a tensor that lies on the CPU; for
a CUDA tensor it launches the kernel or raises (float32 only).
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
    "mesh_gather_plain",
    "mesh_gather_wgrad",
    "mesh_spread",
    "mesh_spread_dipole",
    "mesh_spread_dipole_plain",
    "mesh_spread_plain",
    "mesh_wgrad",
    "mesh_wgrad_plain",
    "spread_dipoles",
    "spread_tiles",
]


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


# -- kernels D, E, F --------------------------------------------------------------


def _check(lx, ly, sz, weights, ns, nodes: int) -> tuple[int, int]:
    """Validate the bucketing arrays for the kernels; returns ``(T, K)``."""
    if not 3 <= nodes <= 7:
        raise ValueError(f"the mesh kernels are built for 3 to 7 nodes, got {nodes}")
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
    t, k = _check(lx, ly, sz, weights, ns, nodes)
    _k.check_cuda_tensor(dweights, "dweights", (t, k, 3, nodes))
    _k.check_cuda_tensor(nu_slots, "nu_slots", (t, 3, k))
    return _launch_spread(lx, ly, sz, weights, dweights, nu_slots, ns, nodes)


def _launch_gather_wgrad(lx, ly, sz, weights, q_slots, mesh, ns, nodes, gather, wgrad):
    t, k = _check(lx, ly, sz, weights, ns, nodes)
    n_ch = mesh.shape[0]
    _k.check_cuda_tensor(mesh, "mesh", (n_ch, *ns))
    dev = weights.device
    vals = wg = None
    if wgrad:
        _k.check_cuda_tensor(q_slots, "q_slots", (t, n_ch, k))
        wg = torch.empty((t, k, 3, nodes), dtype=torch.float32, device=dev)
    if gather:
        vals = torch.empty((t, n_ch, k), dtype=torch.float32, device=dev)
    p = _params(ns, nodes, t, k, n_ch)
    status = _k.load_library().lib.tpme_mesh_gather_wgrad(
        lx.data_ptr(), ly.data_ptr(), sz.data_ptr(), weights.data_ptr(),
        q_slots.data_ptr() if wgrad else None, mesh.data_ptr(),
        vals.data_ptr() if gather else None, wg.data_ptr() if wgrad else None,
        ctypes.byref(p), _k.stream_handle(dev),
    )
    _k.check_status(status, "mesh_gather_wgrad")
    if gather:
        _k.MESH_GATHER.launches += 1
    if wgrad:
        _k.MESH_WGRAD.launches += 1
    return vals, wg


def mesh_gather(lx, ly, sz, weights, mesh, ns, nodes: int) -> torch.Tensor:
    """Kernel E: ``(C, nx, ny, nz)`` mesh → ``(T, C, K)`` per-slot values.

    CPU tensors take :func:`mesh_gather_plain`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_gather_plain(lx, ly, sz, weights, mesh, ns, nodes)
    return _launch_gather_wgrad(lx, ly, sz, weights, None, mesh, ns, nodes, True, False)[0]


def mesh_wgrad(lx, ly, sz, weights, q_slots, mesh, ns, nodes: int) -> torch.Tensor:
    """Kernel F: the weight cotangent ``(T, K, 3, n)`` of the trilinear form
    for ``q (T, C, K)`` and the ``(C, nx, ny, nz)`` field.

    CPU tensors take :func:`mesh_wgrad_plain`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_wgrad_plain(lx, ly, sz, weights, q_slots, mesh, ns, nodes)
    return _launch_gather_wgrad(lx, ly, sz, weights, q_slots, mesh, ns, nodes, False, True)[1]


def mesh_gather_wgrad(lx, ly, sz, weights, q_slots, mesh, ns, nodes: int):
    """Kernels E and F from one pass over the mesh windows: ``(values
    (T, C, K), weight cotangent (T, K, 3, n))``.  On CUDA tensors this is one
    launch, counted once for each of the two kernels."""
    if weights.device.type == "cpu":
        return (
            mesh_gather_plain(lx, ly, sz, weights, mesh, ns, nodes),
            mesh_wgrad_plain(lx, ly, sz, weights, q_slots, mesh, ns, nodes),
        )
    return _launch_gather_wgrad(lx, ly, sz, weights, q_slots, mesh, ns, nodes, True, True)


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


class _TileDipoleSpread(torch.autograd.Function):
    """``(weights, dweights, ν (T, 3, K)) → (1, nx, ny, nz)`` over kernel D's
    dipole form (or, with ``plain``, its plain version on any device).  The
    backward runs kernels E and F over the tripled slots (``tripled``: the
    caller's, else built there)."""

    @staticmethod
    def forward(ctx, weights, dweights, nu_slots, lx, ly, sz, ns, nodes, plain, tripled):
        ctx.save_for_backward(weights, dweights, nu_slots, lx, ly, sz, *(tripled or (None,) * 4))
        ctx.static = (ns, nodes, plain)
        spread = mesh_spread_dipole_plain if plain else mesh_spread_dipole
        return spread(lx, ly, sz, weights, dweights, nu_slots, ns, nodes)

    @staticmethod
    def backward(ctx, ct_mesh):
        weights, dweights, nu_slots, lx, ly, sz, *tripled = ctx.saved_tensors
        ns, nodes, plain = ctx.static
        want_w, want_dw, want_nu = ctx.needs_input_grad[:3]
        t, _, k = nu_slots.shape
        args = tripled if tripled[0] is not None else _dipole_triple(lx, ly, sz, weights, dweights)
        ct_q, ct_w3 = _spread_vjp(
            args, nu_slots.reshape(t, 1, 3 * k), ct_mesh.contiguous(), ns, nodes, plain,
            want_w or want_dw, want_nu,
        )
        ct_w = ct_dw = None
        if ct_w3 is not None:
            ct_w, ct_dw = _untriple(ct_w3, k)
        ct_nu = None if ct_q is None else ct_q.reshape(t, 3, k)
        return (ct_w if want_w else None, ct_dw if want_dw else None, ct_nu,
                None, None, None, None, None, None, None)


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
    gradient fields over kernel E on the tripled slots (or, with ``plain``,
    the plain versions on any device).  The backward spreads the cotangent
    with kernel D's dipole form and runs kernel F over the tripled slots."""

    @staticmethod
    def forward(ctx, weights, dweights, mesh, lx, ly, sz, ns, nodes, plain, tripled):
        mesh = mesh.contiguous()
        args = tripled or _dipole_triple(lx, ly, sz, weights, dweights)
        ctx.save_for_backward(weights, dweights, mesh, lx, ly, sz, *args)
        ctx.static = (ns, nodes, plain)
        gather = mesh_gather_plain if plain else mesh_gather
        t, k = lx.shape
        return gather(*args, mesh, ns, nodes).reshape(t, 3, k)

    @staticmethod
    def backward(ctx, ct_out):
        weights, dweights, mesh, lx, ly, sz, *args = ctx.saved_tensors
        ns, nodes, plain = ctx.static
        want_w, want_dw, want_mesh = ctx.needs_input_grad[:3]
        ct_out = ct_out.contiguous()
        t, _, k = ct_out.shape
        ct_w = ct_dw = ct_mesh = None
        if want_mesh:
            spread = mesh_spread_dipole_plain if plain else mesh_spread_dipole
            ct_mesh = spread(lx, ly, sz, weights, dweights, ct_out, ns, nodes)
        if want_w or want_dw:
            wgrad = mesh_wgrad_plain if plain else mesh_wgrad
            ct_w, ct_dw = _untriple(
                wgrad(*args, ct_out.reshape(t, 1, 3 * k), mesh, ns, nodes), k
            )
        return (ct_w if want_w else None, ct_dw if want_dw else None, ct_mesh,
                None, None, None, None, None, None, None)


def _tripled_arrays(slots: TiledInterpolation | None):
    """The charge-form arguments of a caller's ``dipole_slots`` bucketing,
    as values (the dipole functions carry the weights' gradients themselves)."""
    if slots is None:
        return None
    return (slots.local_x, slots.local_y, slots.start_z, slots.weights.detach().contiguous())


def spread_dipoles(
    interp: TiledInterpolation, nu_slots: torch.Tensor, plain: bool = False,
    slots: TiledInterpolation | None = None,
) -> torch.Tensor:
    """Per-slot effective dipoles ``(T, 3, K)`` → gradient density ``(1, nx,
    ny, nz)`` through kernel D's dipole form.  Differentiable with respect to
    ``nu_slots``, the weights and their derivatives (kernels E and F over the
    tripled slots ``slots``, built where the backward needs them)."""
    return _TileDipoleSpread.apply(
        interp.weights.contiguous(), interp.dweights.contiguous(), nu_slots.contiguous(),
        interp.local_x, interp.local_y, interp.start_z, interp.ns, interp.nodes, plain,
        _tripled_arrays(slots),
    )


def gather_dipole_fields(
    interp: TiledInterpolation, mesh: torch.Tensor, plain: bool = False,
    slots: TiledInterpolation | None = None,
) -> torch.Tensor:
    """Mesh ``(1, nx, ny, nz)`` → per-slot gradient fields ``(T, 3, K)``
    (kernel E over the tripled slots; the backward spreads with kernel D's
    dipole form)."""
    return _TileDipoleGather.apply(
        interp.weights.contiguous(), interp.dweights.contiguous(), mesh,
        interp.local_x, interp.local_y, interp.start_z, interp.ns, interp.nodes, plain,
        _tripled_arrays(slots),
    )
