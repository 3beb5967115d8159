"""Differentiable collectives of the multi-device tier, on ``torch.distributed``.

The JAX package runs its sharded functions under ``shard_map`` and lets
autodiff transpose ``lax.psum``, ``lax.ppermute`` and ``lax.all_to_all``.
Here every rank runs the same function on the same replicated arguments
(SPMD, one process a rank), and four :class:`torch.autograd.Function`\\ s
carry the communication, each transposing as JAX's primitive does:

* :func:`psum` — a partial whose total every rank holds: ``all_reduce``
  forward, the **identity** backward (every rank already holds the total's
  cotangent; ``torch.distributed.nn.functional.all_reduce`` would reduce it
  again and give D× gradients);
* :func:`replicate` — an input every rank holds whole that enters a
  rank-local computation (charges, the cell, atom-order positions, a
  trainable potential parameter): the identity forward, an ``all_reduce`` of
  the cotangent backward (JAX's ``lax.pcast(..., to="varying")``);
* :func:`ring_hop` — ``ppermute`` to the neighbour ``shift`` ranks on; the
  backward hops the other way;
* :func:`all_to_all` — the tiled layout swap; the backward is the inverse
  swap.  Complex tensors travel as ``torch.view_as_real``.

At world size 1 every hop is to the rank itself (a copy), and the reductions
and the swap still go through the group.  Under a gloo group, CUDA tensors
are staged through host memory explicitly, and the staged bytes are counted
apart (:func:`collective_counts`); NCCL takes them in place.  Gloo's swap is
one send and one receive a peer (some gloo builds have no all-to-all).

Each call records its kind, its bytes and its largest element count in a
counter that tests and the chip script read (:func:`collective_counts`,
:func:`reset_collective_counts`): the counterpart of the HLO text that the
JAX package's tests inspect.

The functions take ``axis``: a :class:`torch.distributed.device_mesh.DeviceMesh`
with a dimension named ``"atoms"`` (the JAX package's ``device_mesh`` and
``axis``), a process group, or ``None`` for the default group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = [
    "Axis",
    "all_to_all",
    "axis_of",
    "collective_counts",
    "psum",
    "reduce_flag",
    "replicate",
    "reset_collective_counts",
    "ring_hop",
]

#: per kind (``all_reduce``, ``ring_hop``, ``all_to_all``): calls, bytes
#: sent by this rank, the largest element count of one call, and the bytes
#: staged through host memory (a gloo group with CUDA tensors)
_COUNTS: dict[str, dict[str, int]] = {}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def collective_counts() -> dict[str, dict[str, int]]:
    """``{kind: {"calls", "bytes", "max_elements", "staged_bytes"}}`` since
    the last reset, forward and backward passes both."""
    return {kind: dict(c) for kind, c in _COUNTS.items()}


def _record(kind: str, t: torch.Tensor, staged: bool) -> None:
    c = _COUNTS.setdefault(
        kind, {"calls": 0, "bytes": 0, "max_elements": 0, "staged_bytes": 0}
    )
    nbytes = t.numel() * t.element_size()
    c["calls"] += 1
    c["bytes"] += nbytes
    c["max_elements"] = max(c["max_elements"], t.numel())
    if staged:
        c["staged_bytes"] += nbytes


@dataclass(frozen=True)
class Axis:
    """The rank axis of a sharded call: its group, size and this rank."""

    group: object
    size: int
    rank: int
    backend: str

    def staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through host memory (gloo carries CPU tensors)."""
        return self.backend == "gloo" and t.device.type != "cpu"

    def global_rank(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)


def axis_of(axis=None, name: str = "atoms") -> Axis:
    """The :class:`Axis` of a ``DeviceMesh`` (its dimension ``name``), a
    process group, or the default group (``None``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "the sharded functions need torch.distributed: call "
            "init_process_group (gloo on the CPU, nccl on a card) on every rank first"
        )
    if isinstance(axis, DeviceMesh):
        if axis.ndim != 1 or axis.mesh_dim_names != (name,):
            raise ValueError(
                f"the device mesh must have one dimension named {name!r}, got "
                f"{axis.mesh_dim_names}"
            )
        group = axis.get_group(name)
    else:
        group = dist.group.WORLD if axis is None else axis
    return Axis(group, dist.get_world_size(group), dist.get_rank(group),
                str(dist.get_backend(group)))


def _stage(ax: Axis, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if ax.staged(t) else t


def _all_reduce(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    out = t.contiguous().clone()
    _record("all_reduce", out, ax.staged(out))
    buf = _stage(ax, out)
    dist.all_reduce(buf, group=ax.group)
    if buf is not out:
        out.copy_(buf)
    return out


def _hop(t: torch.Tensor, shift: int, ax: Axis) -> torch.Tensor:
    """``t`` of the rank ``shift`` places back (this rank's goes ``shift`` on)."""
    send = t.contiguous()
    _record("ring_hop", send, ax.staged(send))
    if ax.size == 1 or shift % ax.size == 0:
        return send.clone()
    send_b = _stage(ax, send)
    recv_b = torch.empty_like(send_b)
    dst = ax.global_rank((ax.rank + shift) % ax.size)
    src = ax.global_rank((ax.rank - shift) % ax.size)
    reqs = [dist.isend(send_b, dst, group=ax.group), dist.irecv(recv_b, src, group=ax.group)]
    for req in reqs:
        req.wait()
    return recv_b.to(t.device) if recv_b.device != t.device else recv_b


def _swap(t: torch.Tensor, split_dim: int, concat_dim: int, ax: Axis) -> torch.Tensor:
    """Tiled all-to-all: block ``r`` of ``split_dim`` goes to rank ``r``; the
    received blocks are concatenated along ``concat_dim`` in rank order."""
    if t.is_complex():
        out = _swap(torch.view_as_real(t), split_dim, concat_dim, ax)
        return torch.view_as_complex(out.contiguous())
    if t.shape[split_dim] % ax.size:
        raise ValueError(
            f"all_to_all: dimension {split_dim} of {tuple(t.shape)} does not split "
            f"over {ax.size} ranks"
        )
    staged = ax.staged(t)
    _record("all_to_all", t, staged)
    blocks = [_stage(ax, b.contiguous()) for b in t.chunk(ax.size, dim=split_dim)]
    recv = [torch.empty_like(blocks[0]) for _ in range(ax.size)]
    if ax.backend == "gloo":
        # gloo builds without all_to_all exist (torch 2.11's): one send and
        # one receive a peer, this rank's own block kept
        reqs = []
        for r in range(ax.size):
            if r == ax.rank:
                recv[r] = blocks[r]
                continue
            peer = ax.global_rank(r)
            reqs += [dist.isend(blocks[r], peer, group=ax.group),
                     dist.irecv(recv[r], peer, group=ax.group)]
        for req in reqs:
            req.wait()
    else:
        dist.all_to_all(recv, blocks, group=ax.group)
    return torch.cat(recv, dim=concat_dim).to(t.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        return _all_reduce(t, ax)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *ts):
        ctx.ax = ax
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *cts):
        # every rank reduces the same inputs (those that need a gradient),
        # in the same order, whether or not its own cotangent is zero
        needs = ctx.needs_input_grad[1:]
        return (None, *(_all_reduce(ct, ctx.ax) if need else None
                        for ct, need in zip(cts, needs)))


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shift, ax):
        ctx.shift, ctx.ax = shift, ax
        return _hop(t, shift, ax)

    @staticmethod
    def backward(ctx, ct):
        return _hop(ct, -ctx.shift, ctx.ax), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, concat_dim, ax):
        ctx.dims, ctx.ax = (split_dim, concat_dim), ax
        return _swap(t, split_dim, concat_dim, ax)

    @staticmethod
    def backward(ctx, ct):
        split_dim, concat_dim = ctx.dims
        return _swap(ct, concat_dim, split_dim, ctx.ax), None, None, None


def psum(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Sum of ``t`` over the ranks (``lax.psum``); identity backward."""
    return _Psum.apply(t, ax)


def replicate(ax: Axis, *ts: torch.Tensor):
    """Mark replicated inputs as entering rank-local work: the identity, and
    the cotangents summed over the ranks backward.  Returns a tuple."""
    return _Replicate.apply(ax, *ts)


def ring_hop(t: torch.Tensor, shift: int, ax: Axis) -> torch.Tensor:
    """``lax.ppermute`` by ``shift`` ranks on the ring: this rank's ``t``
    goes to rank ``r + shift`` and the result is rank ``r − shift``'s."""
    return _RingHop.apply(t, int(shift), ax)


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, ax: Axis) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: the inverse swap backward."""
    return _AllToAll.apply(t, split_dim, concat_dim, ax)


def reduce_flag(valid: torch.Tensor, ax: Axis) -> torch.Tensor:
    """1 where every rank's 0-d bool ``valid`` holds, NaN otherwise (in the
    ``dtype`` the caller casts to): a stale bucketing on any rank poisons
    every rank's result and gradients."""
    with torch.no_grad():
        flag = torch.where(valid, 1.0, float("nan")).to(torch.float64).reshape(1)
        return psum(flag, ax)[0] / ax.size
