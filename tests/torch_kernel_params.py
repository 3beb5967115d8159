"""The kernels' parameter structs as the port built them in Python before its
host layer moved to C++ (``torchpme_tpu_torch/csrc/tpme_ops.cpp``): ctypes
mirrors of the structs of ``csrc/*.cu`` and their builders, from the plain
versions' own constants (``ops/math.py``, ``ops/mesh.py``'s weight tables).
The tests hold the C++ builders to them byte for byte
(``tests/test_torch_ops_cpp.py``), and read the z-chunk rules and the
constants here.
"""

import ctypes
import math

import numpy as np
import torch

from torchpme_tpu_torch.ops.math import (
    coulomb_alpha,
    coulomb_c_gauss,
    power_law_alpha_sq,
    power_law_c_gauss,
)
from torchpme_tpu_torch.ops.mesh_tiled import TILE
from torchpme_tpu_torch.ops.rspace_cells import _window_offsets
from torchpme_tpu_torch.ops.spread_fused import _tables

MAX_NODES = 8
N_OFFSETS = 14
MAX_MEMBERS = 4


class SpreadParams(ctypes.Structure):
    """Mirror of ``struct SpreadParams`` in ``csrc/spread.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("nodes", ctypes.c_int),
        ("extent", ctypes.c_int),
        ("lpad", ctypes.c_int),
        ("ty_count", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("kp", ctypes.c_int),
        ("n_ch", ctypes.c_int),
        ("z_cells", ctypes.c_int),
        ("z_chunk", ctypes.c_int),
        ("bwd_z_chunk", ctypes.c_int),
        ("coeff", ctypes.c_float * (MAX_NODES * MAX_NODES)),
        ("deriv", ctypes.c_float * (MAX_NODES * MAX_NODES)),
    ]


class WindowMember(ctypes.Structure):
    """Mirror of ``struct WindowMember`` in ``csrc/window.cu``."""

    _fields_ = [
        ("p", ctypes.c_int),
        ("alpha", ctypes.c_float),
        ("alpha_sq", ctypes.c_float),
        ("prefactor", ctypes.c_float),
        ("c_gauss", ctypes.c_float),
    ]


class WindowParams(ctypes.Structure):
    """Mirror of ``struct WindowParams`` in ``csrc/window.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("n_ch", ctypes.c_int),
        ("self_k", ctypes.c_int),
        ("group", ctypes.c_int),
        ("direct", ctypes.c_int),
        ("kind", ctypes.c_int),
        ("n_members", ctypes.c_int),
        ("cutoff_sq", ctypes.c_float),
        ("members", WindowMember * MAX_MEMBERS),
        ("offsets", ctypes.c_int * (3 * N_OFFSETS)),
    ]


class WindowDipoleParams(ctypes.Structure):
    """Mirror of ``struct WindowDipoleParams`` in ``csrc/window_dipole.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("self_k", ctypes.c_int),
        ("direct", ctypes.c_int),
        ("warps", ctypes.c_int),
        ("cutoff_sq", ctypes.c_float),
        ("alpha", ctypes.c_float),
        ("sqrt_alpha", ctypes.c_float),
        ("prefactor", ctypes.c_float),
        ("c_gauss", ctypes.c_float),
        ("offsets", ctypes.c_int * (3 * N_OFFSETS)),
    ]


class MeshParams(ctypes.Structure):
    """Mirror of ``struct MeshParams`` in ``csrc/mesh.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("nodes", ctypes.c_int),
        ("extent", ctypes.c_int),
        ("ty_count", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("n_ch", ctypes.c_int),
        ("z_chunk", ctypes.c_int),
        ("n_sys", ctypes.c_int),
        ("slot_stride", ctypes.c_longlong),
        ("val_stride", ctypes.c_longlong),
        ("mesh_stride", ctypes.c_longlong),
    ]


# -- the z-chunk rules ------------------------------------------------------------


def z_chunk(nz: int) -> int:
    """Mesh z cells that one block of kernel A owns: ``nz`` split into
    ``max(2, ceil(nz / 128))`` chunks (the last may be short)."""
    n_chunks = max(2, -(-nz // 128))
    return -(-nz // n_chunks)


def bwd_z_chunk(nodes: int, extent: int, n_ch: int) -> int:
    """Mesh z cells that one block of kernel B stages: 64 where the windows
    of all channels, ``(extent, extent, zc + nodes − 1)`` rounded to whole
    16-byte vectors, take at most 64 KB of shared memory, 32 otherwise."""
    row = (64 + nodes - 1 + 3) // 4 * 4
    return 64 if n_ch * extent * extent * row * 4 <= 64 * 1024 else 32


def gather_z_chunk(nodes: int, n_ch: int) -> int:
    """Z cells a block of kernels E and F stages: 32, halved while the
    staged windows of all channels take more than 36 KB of shared memory."""
    extent, zc = TILE + nodes - 1, 32
    while zc > 4 and n_ch * extent * extent * ((zc + nodes + 2) // 4) * 16 > 36 * 1024:
        zc //= 2
    return zc


# -- the builders -------------------------------------------------------------------


def spread_params(geometry, method: str, n_ch: int) -> SpreadParams:
    """Kernels A and B: ``geometry`` as ``SpreadGeometry.as_args`` gives it."""
    nx, ny, nz, nodes, extent, lpad, n_tiles, slots, z_cells = geometry
    coeffs, deriv = _tables(method, nodes)
    p = SpreadParams()
    p.nx, p.ny, p.nz = nx, ny, nz
    p.nodes, p.extent, p.lpad = nodes, extent, lpad
    p.ty_count, p.n_tiles, p.kp, p.n_ch = ny // TILE, n_tiles, slots, n_ch
    p.z_cells, p.z_chunk = z_cells, z_chunk(nz)
    p.bwd_z_chunk = bwd_z_chunk(nodes, extent, n_ch)
    for o in range(nodes):
        for m in range(coeffs.shape[1]):
            p.coeff[o * MAX_NODES + m] = float(coeffs[o, m])
        for m in range(deriv.shape[1]):
            p.deriv[o * MAX_NODES + m] = float(deriv[o, m])
    return p


def window_params(table, cutoff: float, grid, n_ch: int) -> WindowParams:
    """Kernel C for a pair-term ``table`` (``ops.rspace_cells.window_table``)
    on the ``(nx, ny, nz, cap)`` grid (``group`` left 0: the card picks it)."""
    weights, kinds, exponents, smearings, prefactors, direct = table
    nx, ny, nz, cap = grid
    p = WindowParams()
    p.nx, p.ny, p.nz, p.cap, p.n_ch = nx, ny, nz, cap, n_ch
    p.direct = int(direct)
    p.kind = 2 if weights is not None else (0 if exponents[0] == 1 else 1)
    p.n_members = len(kinds)
    offsets = _window_offsets(cap)
    p.self_k = offsets.index((0, 0, 0))
    p.cutoff_sq = float(np.float32(cutoff) ** 2)
    for slot, (kind, exponent, smearing, prefactor) in enumerate(
        zip(kinds, exponents, smearings, prefactors)
    ):
        m = p.members[slot]
        m.p, m.prefactor = exponent, prefactor
        if direct:
            continue
        if kind == 0:  # CoulombPotential
            alpha = coulomb_alpha(smearing)
            m.alpha, m.alpha_sq = alpha, alpha * alpha
            m.c_gauss = coulomb_c_gauss(prefactor, smearing)
        else:  # InversePowerLawPotential
            alpha_sq = power_law_alpha_sq(smearing)
            m.alpha, m.alpha_sq = alpha_sq**0.5, alpha_sq
            m.c_gauss = power_law_c_gauss(prefactor, exponent, smearing)
    for k, o in enumerate(offsets):
        p.offsets[3 * k : 3 * k + 3] = o
    return p


def window_dipole_params(smearing, prefactor: float, cutoff: float, grid) -> WindowDipoleParams:
    """Kernel G from the potential's smearing (``None``: direct) and
    prefactor on the ``(nx, ny, nz, cap)`` grid (``warps`` left 0)."""
    nx, ny, nz, cap = grid
    p = WindowDipoleParams()
    p.nx, p.ny, p.nz, p.cap = nx, ny, nz, cap
    offsets = _window_offsets(cap)
    p.self_k = offsets.index((0, 0, 0))
    p.direct = int(smearing is None)
    p.cutoff_sq = float(torch.tensor(cutoff, dtype=torch.float32) ** 2)
    p.prefactor = float(prefactor)
    if smearing is not None:
        alpha = 1.0 / (2.0 * float(smearing) ** 2)
        p.alpha = alpha
        p.sqrt_alpha = alpha**0.5
        p.c_gauss = 2.0 * (alpha / math.pi) ** 0.5
    for k, o in enumerate(offsets):
        p.offsets[3 * k : 3 * k + 3] = o
    return p


def mesh_params(ns, nodes: int, n_sys: int, t: int, k: int, n_ch: int, n_vals: int) -> MeshParams:
    """Kernels D, E and F."""
    p = MeshParams()
    p.nx, p.ny, p.nz = ns
    p.nodes, p.extent, p.ty_count = nodes, TILE + nodes - 1, ns[1] // TILE
    p.n_tiles, p.cap, p.n_ch = t, k, n_ch
    p.z_chunk = gather_z_chunk(nodes, n_ch)
    p.n_sys = n_sys
    p.slot_stride, p.val_stride = t * k, t * n_vals * k
    p.mesh_stride = n_ch * ns[0] * ns[1] * ns[2]
    return p
