"""Weighted linear combination of potentials, with trainable weights.

Counterpart of :mod:`torchpme_tpu.potentials.combined`.  The members sit in
an ``nn.ModuleList``; the weights are an ``nn.Parameter`` when
``learnable_weights`` is set (the default) and a buffer otherwise, so autograd
carries the energy's gradient to them through every calculator: the window
(kernel C returns each member's energy, which is ``dE/dw``), the mesh filter
(the weights reach float64 filters by a cast inside the graph), the self and
the background terms.
"""

from __future__ import annotations

import torch
from torch import nn

from .potential import Potential

__all__ = ["CombinedPotential"]


class CombinedPotential(Potential):
    """Linear combination ``sum_i w_i · V_i`` of compatible potentials.

    :param potentials: the member potentials; either all direct
        (``smearing=None``) or all range-separated.
    :param initial_weights: combination weights, default all ones (float64).
    :param learnable_weights: the weights are an ``nn.Parameter`` (else a
        buffer that autograd does not reach).
    :param smearing: must be set iff the members are range-separated (the
        calculators read it to pick their SR/LR split).
    :param exclusion_radius / exclusion_degree: see :class:`Potential`.

    Example
    -------
    >>> import torch
    >>> from torchpme_tpu_torch.potentials import CoulombPotential, InversePowerLawPotential
    >>> combined = CombinedPotential(
    ...     [CoulombPotential(smearing=1.0),
    ...      InversePowerLawPotential(exponent=2, smearing=1.0)],
    ...     initial_weights=torch.tensor([2.0, 1.0]),
    ...     smearing=1.0,
    ... )
    >>> value = combined.from_dist(torch.tensor(2.0))  # 2/r + 1/r²
    >>> print(f"{float(value.detach()):.4f}", value.requires_grad)  # the weights train
    1.2500 True
    """

    def __init__(
        self,
        potentials: list[Potential],
        initial_weights: torch.Tensor | None = None,
        learnable_weights: bool = True,
        smearing: float | None = None,
        exclusion_radius: float | None = None,
        exclusion_degree: int = 1,
    ):
        super().__init__(smearing, exclusion_radius, exclusion_degree, 1.0)
        smearings = [pot.smearing for pot in potentials]
        if not all(s is not None for s in smearings) and any(
            s is not None for s in smearings
        ):
            raise ValueError(
                "Cannot combine direct (`smearing=None`) and range-separated "
                "(`smearing=float`) potentials."
            )
        if smearings and all(s is not None for s in smearings) and smearing is None:
            raise ValueError(
                "You should specify a `smearing` when combining range-separated "
                "(`smearing=float`) potentials."
            )
        if not any(s is not None for s in smearings) and smearing is not None:
            raise ValueError(
                "Cannot specify `smearing` when combining direct "
                "(`smearing=None`) potentials."
            )
        if initial_weights is not None:
            weights = torch.as_tensor(initial_weights)
            if weights.shape[0] != len(potentials):
                raise ValueError(
                    "The number of initial weights must match the number of "
                    "potentials being combined"
                )
            if not weights.is_floating_point():
                weights = weights.to(torch.float64)
        else:
            weights = torch.ones(len(potentials), dtype=torch.float64)
        self.potentials = nn.ModuleList(potentials)
        self.learnable_weights = bool(learnable_weights)
        weights = weights.detach().clone()
        if self.learnable_weights:
            self.weights = nn.Parameter(weights)
        else:
            self.register_buffer("weights", weights)

    def _combine(self, values) -> torch.Tensor:
        """``Σ_i w_i values_i``; the weights meet each value in its dtype and
        on its device, inside the graph."""
        values = [torch.as_tensor(v, dtype=self.weights.dtype) if not isinstance(v, torch.Tensor)
                  else v for v in values]
        stacked = torch.stack(torch.broadcast_tensors(*values), dim=-1)
        return torch.matmul(stacked, self.weights.to(stacked))

    def from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        return self._combine([p.from_dist(dist) for p in self.potentials])

    def sr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        return self._combine([p.sr_from_dist(dist) for p in self.potentials])

    def lr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        return self._combine([p.lr_from_dist(dist) for p in self.potentials])

    def lr_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        return self._combine([p.lr_from_k_sq(k_sq) for p in self.potentials])

    def _members_have(self, hook: str) -> bool:
        """Every member has ``hook`` and no exclusion window (a member's
        hooks describe its smooth SR part, not its windowed one)."""
        return all(
            getattr(p, hook, None) is not None and getattr(p, "exclusion_radius", None) is None
            for p in self.potentials
        )

    @property
    def sr_derivative(self):
        """Combined :math:`dV_{SR}/dr` when every member has the hook and no
        exclusion window, else ``None``.  Members recompute their own SR
        values (the argument is the combined value, which cannot be split
        back).  (The JAX package also composes it over members with an
        exclusion window, whose hooks ignore the window.)"""
        if not self._members_have("sr_derivative"):
            return None

        def deriv(dist: torch.Tensor, sr_values: torch.Tensor) -> torch.Tensor:
            del sr_values
            return self._combine(
                [p.sr_derivative(dist, p.sr_from_dist(dist)) for p in self.potentials]
            )

        return deriv

    @property
    def sr_window_math(self):
        """Composed float32 ``(V, V'/d)``-of-d² hook when every member has
        one and no exclusion window, else ``None``; each member pays its own
        Gaussian."""
        if not self._members_have("sr_window_math"):
            return None

        def window_math(dist_sq: torch.Tensor):
            parts = [p.sr_window_math(dist_sq) for p in self.potentials]
            return (self._combine([v for v, _ in parts]), self._combine([w for _, w in parts]))

        return window_math

    def self_contribution(self) -> torch.Tensor:
        return self._combine([p.self_contribution() for p in self.potentials])

    def background_correction(self) -> torch.Tensor:
        return self._combine([p.background_correction() for p in self.potentials])
