"""Mesh-tile geometry and the parity-class fold of tile fields.

Counterpart of the parts of :mod:`torchpme_tpu.ops.mesh_tiled` that the
aligned MD step uses.  On the TPU the tile fields exist because scatters
serialize there; the CUDA spread kernel (``csrc/spread.cu``) adds its tile
field straight into the periodic mesh with atomics.  The fold below is the
plain twin of that last step.
"""

from __future__ import annotations

import torch

__all__ = ["TILE", "supports_tiling"]

TILE = 8  # xy tile edge in mesh cells


def supports_tiling(ns, interpolation_nodes: int) -> bool:
    """Tiling needs even tile grids and stencils that fit a 2-tile window."""
    nx, ny, _ = (int(n) for n in ns)
    return (
        interpolation_nodes <= TILE + 1
        and nx % (2 * TILE) == 0
        and ny % (2 * TILE) == 0
        and nx >= 2 * TILE
        and ny >= 2 * TILE
    )


def _fold_tiles_to_mesh(tile_fields: torch.Tensor, ns, extent: int) -> torch.Tensor:
    """Assemble per-tile local fields ``(T, E, E, nz, C)`` into
    ``(C, nx, ny, nz)``; local cell ``e`` of tile ``(tx, ty)`` lands on mesh
    cell ``tx·TILE + e`` (mod ``nx``).

    Tiles of equal (x, y) parity are disjoint, so each parity class folds
    with a pad + transpose + reshape; the four classes and the x/y wraps
    combine with shifted adds.
    """
    nx, ny, nz = ns
    tx_count, ty_count = nx // TILE, ny // TILE
    n_ch = tile_fields.shape[-1]
    window = 2 * TILE
    pad = window - extent
    tiles = torch.nn.functional.pad(
        tile_fields.reshape(tx_count, ty_count, extent, extent, nz, n_ch),
        (0, 0, 0, 0, 0, pad, 0, pad),
    )
    padded = tile_fields.new_zeros((nx + window, ny + window, nz, n_ch))
    for px in range(2):
        for py in range(2):
            cls = tiles[px::2, py::2]  # (tx/2, ty/2, W, W, nz, C), disjoint
            ntx, nty = cls.shape[0], cls.shape[1]
            block = cls.permute(0, 2, 1, 3, 4, 5).reshape(
                ntx * window, nty * window, nz, n_ch
            )
            x0, y0 = px * TILE, py * TILE
            padded[x0 : x0 + ntx * window, y0 : y0 + nty * window] += block
    mesh = padded[:nx, :ny].clone()
    mesh[:window, :] += padded[nx:, :ny]
    mesh[:, :window] += padded[:nx, ny:]
    mesh[:window, :window] += padded[nx:, ny:]
    return mesh.permute(3, 0, 1, 2)
