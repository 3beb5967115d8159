"""Closed-form 3×3 cell algebra (counterpart of :mod:`torchpme_tpu.ops.math`).

Every cell matrix in this library is 3×3, so the inverse and determinant
are branch-free cofactor expressions: exact elementary arithmetic, fully
differentiable through autograd, and no LAPACK / cuSOLVER call on the step.
"""

from __future__ import annotations

import torch

__all__ = ["det3", "inv3"]


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
