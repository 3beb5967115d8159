r"""Tile spread, gather and weight gradient: kernels D, E, F and their plain
versions.

Counterpart of :mod:`torchpme_tpu.ops.pallas.mesh_pallas`.  All three work on
the arrays of a :class:`~torchpme_tpu_torch.ops.mesh_tiled.TiledInterpolation`
(``lx``, ``ly``, ``sz`` ``(T, K)`` int32, ``weights`` ``(T, K, 3, n)``) and on
per-slot values in the ``(T, C, K)`` layout:

* **D** (:func:`mesh_spread`): per-slot charges → the periodic
  ``(C, nx, ny, nz)`` mesh;
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
the window extraction).  A wrapper takes the plain version only for a tensor
that lies on the CPU; for a CUDA tensor it launches the kernel or raises
(float32 only).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as _k
from .mesh_tiled import (
    TILE,
    TiledInterpolation,
    _dense_factors,
    _extract_tiles_from_mesh,
    _fold_tiles_to_mesh,
)

__all__ = [
    "gather_tiles",
    "mesh_gather",
    "mesh_gather_plain",
    "mesh_gather_wgrad",
    "mesh_spread",
    "mesh_spread_plain",
    "mesh_wgrad",
    "mesh_wgrad_plain",
    "spread_tiles",
]

# shared memory of one block of kernel D: the whole z line of a tile where it
# fits this budget, else z is split into chunks (one block each)
SPREAD_SMEM_BUDGET = 96 * 1024


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


def _params(ns, nodes: int, t: int, k: int, n_ch: int, z_chunk: int = 0) -> _k.MeshParams:
    p = _k.MeshParams()
    p.nx, p.ny, p.nz = ns
    p.nodes, p.extent, p.ty_count = nodes, TILE + nodes - 1, ns[1] // TILE
    p.n_tiles, p.cap, p.n_ch = t, k, n_ch
    p.z_chunk = z_chunk
    p.n_chunks = -(-ns[2] // z_chunk) if z_chunk else 0
    return p


def mesh_spread(lx, ly, sz, weights, q_slots, ns, nodes: int) -> torch.Tensor:
    """Kernel D: ``(T, C, K)`` per-slot charges → ``(C, nx, ny, nz)`` mesh.

    CPU tensors take :func:`mesh_spread_plain`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    if weights.device.type == "cpu":
        return mesh_spread_plain(lx, ly, sz, weights, q_slots, ns, nodes)
    t, k = _check(lx, ly, sz, weights, ns, nodes)
    n_ch = q_slots.shape[1]
    _k.check_cuda_tensor(q_slots, "q_slots", (t, n_ch, k))
    lib = _k.load_library().lib
    extent, nz = TILE + nodes - 1, ns[2]
    budget = min(SPREAD_SMEM_BUDGET, lib.tpme_max_smem_optin(weights.device.index))
    z_chunk = min(nz, budget // (extent * extent * 4))
    if z_chunk < 1:
        raise ValueError(f"no shared memory for a {extent}x{extent} tile field")
    mesh = torch.zeros((n_ch, *ns), dtype=torch.float32, device=weights.device)
    p = _params(ns, nodes, t, k, n_ch, z_chunk)
    status = lib.tpme_mesh_spread(
        lx.data_ptr(), ly.data_ptr(), sz.data_ptr(), weights.data_ptr(),
        q_slots.data_ptr(), mesh.data_ptr(), ctypes.byref(p),
        _k.stream_handle(weights.device),
    )
    _k.check_status(status, "mesh_spread")
    _k.MESH_SPREAD.launches += 1
    return mesh


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
        ct_mesh = ct_mesh.contiguous()
        want_w, want_q = ctx.needs_input_grad[:2]
        args = (lx, ly, sz, weights)
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
        return ct_w, ct_q, None, None, None, None, None, None


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
