"""A pool of gloo ranks for the port's multi-device tests (torch only, no JAX).

:class:`RankPool` spawns ``world`` processes once (a module-scoped fixture
holds it), each a rank of a gloo group on ``tcp://localhost``; every test
case runs in all of them at once: the test sends the case's name and its
numpy inputs, each rank runs the port's sharded function on them and sends
back numpy results.  The case functions live here, so the ranks never import
the test modules (which import JAX).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import traceback

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankPool:
    """``world`` gloo ranks that run :data:`CASES` on request."""

    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        port = _free_port()
        self.procs = [
            ctx.Process(target=_serve, args=(r, world, port, self.tasks[r], self.results),
                        daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()
        self._next, self._names, self._done = 0, {}, {}

    def submit(self, case: str, **inputs) -> int:
        """Queue ``case`` on every rank (they run their queues in order);
        returns the ticket that :meth:`collect` takes."""
        ticket = self._next
        self._next += 1
        self._names[ticket] = case
        for q in self.tasks:
            q.put((ticket, case, inputs))
        return ticket

    def collect(self, ticket: int) -> list:
        """The ranks' results of a submitted case, in rank order."""
        while len(self._done.setdefault(ticket, {})) < self.world:
            t, rank, ok, value = self.results.get(timeout=600)
            if not ok:
                # the other ranks may wait in a collective for it: stop them
                self.close()
                raise RuntimeError(f"rank {rank} failed in {self._names[t]}:\n{value}")
            self._done.setdefault(t, {})[rank] = (ok, value)
        out = []
        for rank, (ok, value) in sorted(self._done.pop(ticket).items()):
            if not ok:
                raise RuntimeError(f"rank {rank} failed in {self._names[ticket]}:\n{value}")
            out.append(value)
        return out

    def run(self, case: str, **inputs) -> list:
        """Run ``case`` on every rank; the ranks' results in rank order."""
        return self.collect(self.submit(case, **inputs))

    def close(self) -> None:
        """Stop the ranks (cases still queued are dropped)."""
        for p in self.procs:
            p.kill()
        for p in self.procs:
            p.join(timeout=30)


def _serve(rank, world, port, tasks, results):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank
    )
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            ticket, case, inputs = task
            try:
                results.put((ticket, rank, True, CASES[case](**inputs)))
            except Exception:  # reported to the test, which fails
                results.put((ticket, rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# -- helpers of the cases -------------------------------------------------------


def _t(x, requires_grad=False):
    import torch

    t = torch.as_tensor(np.asarray(x))
    return t.requires_grad_() if requires_grad else t


def _np(t):
    return None if t is None else t.detach().numpy().copy()


def _calc(spec: dict):
    """A port calculator from ``{"kind", ...}``."""
    import torch

    import torchpme_tpu_torch as tpt

    kind = spec["kind"]
    if kind in ("dipole_ewald", "dipole_direct", "dipole_pme"):
        smearing = spec.get("smearing")
        if spec.get("trainable"):
            smearing = torch.tensor(smearing, dtype=torch.float64, requires_grad=True)
        pot = tpt.PotentialDipole(smearing=smearing)
        if kind == "dipole_pme":
            return tpt.PMECalculatorDipole(pot, interpolation_nodes=spec["nodes"])
        if kind == "dipole_ewald":
            return tpt.CalculatorDipole(pot, lr_wavelength=spec["lr_wavelength"])
        return tpt.CalculatorDipole(pot)
    pot = tpt.CoulombPotential(smearing=spec["smearing"])
    if kind == "ewald":
        return tpt.EwaldCalculator(pot, lr_wavelength=spec["lr_wavelength"])
    cls = tpt.P3MCalculator if kind == "p3m" else tpt.PMECalculator
    kw = {"mesh_spacing": spec["mesh_spacing"]} if "mesh_spacing" in spec else {}
    return cls(pot, interpolation_nodes=spec["nodes"], **kw)


def _counts():
    from torchpme_tpu_torch.parallel import collective_counts

    return collective_counts()


def _reset():
    from torchpme_tpu_torch.parallel import reset_collective_counts

    reset_collective_counts()


def _grads(e, leaves):
    import torch

    return [_np(g) for g in torch.autograd.grad(e, leaves)]


# -- the cases: each runs on every rank and returns numpy -------------------------------


def case_collectives():
    """The transposes: psum's backward is the identity, replicate's sums the
    cotangents over the ranks (the JAX package's psum / pcast)."""
    import torch
    import torch.distributed as dist

    from torchpme_tpu_torch.parallel import _collectives as c

    ax = c.axis_of(None)
    x = torch.arange(4, dtype=torch.float64, requires_grad=True)
    w = torch.arange(1, 5, dtype=torch.float64) * (ax.rank + 1)
    # E = Σ_r w_r · x (x replicated): dE/dx = Σ_r w_r on every rank
    (xv,) = c.replicate(ax, x)
    e = c.psum(torch.sum(w * xv).reshape(1), ax)[0]
    (g_rep,) = torch.autograd.grad(e, x)
    # a partial of this rank's own leaf: dE/dy_r = w_r (not D·w_r)
    y = torch.ones(4, dtype=torch.float64, requires_grad=True)
    e2 = c.psum(torch.sum(w * y).reshape(1), ax)[0]
    (g_psum,) = torch.autograd.grad(e2, y)
    # a ring hop there and back, and the all-to-all and its inverse
    z = torch.arange(8, dtype=torch.float64).reshape(2, 4) + 100 * ax.rank
    hop = c.ring_hop(z, 1, ax)
    zc = torch.arange(4 * ax.size, dtype=torch.float64).reshape(1, ax.size, 4) + 10 * ax.rank
    zc = torch.complex(zc, -zc).requires_grad_()
    swapped = c.all_to_all(zc, 1, 2, ax)
    (g_swap,) = torch.autograd.grad(torch.sum(swapped.real * torch.arange(
        swapped.shape[-1], dtype=torch.float64)), zc)
    dist.barrier()
    return dict(e=float(e.detach()), g_rep=_np(g_rep), g_psum=_np(g_psum), hop=_np(hop),
                swapped=_np(swapped), g_swap=_np(g_swap), w=_np(w))


def case_ewald(spec, charges, cell, positions, idx, dist, ns_kvectors):
    from torchpme_tpu_torch.parallel import sharded_ewald_potentials

    out = sharded_ewald_potentials(
        _calc(spec), None, _t(charges), _t(cell), _t(positions), _t(idx), _t(dist),
        tuple(ns_kvectors),
    )
    return dict(pot=_np(out))


def case_mesh(spec, charges, cell, positions, idx, dist, ns_mesh, drift=None, grad=False):
    """Per-atom mesh potentials; with ``grad`` also d(Σ pot·q)/d(q, pos);
    with ``drift`` (positions) a bucketing of ``positions`` applied to
    them."""
    import torch

    from torchpme_tpu_torch.parallel import compute_slab_bucketing, sharded_mesh_potentials

    calc = _calc(spec)
    q, pos = _t(charges, grad), _t(positions, grad)
    bucket = compute_slab_bucketing(pos.detach(), _t(cell), ns_mesh, torch.distributed
                                    .get_world_size(), calc.interpolation_nodes)
    if drift is not None:
        pos = _t(drift)
    _reset()
    out = sharded_mesh_potentials(calc, None, q, _t(cell), pos, _t(idx), _t(dist),
                                  tuple(ns_mesh), slab_bucketing=bucket)
    res = dict(pot=_np(out), counts=_counts())
    if grad:
        res["g_q"], res["g_pos"] = _grads(torch.sum(out * q), [q, pos])
    return res


def _md_state(spec, positions, cell, cutoff, ns_mesh, rows=False, aligned=False,
              dtype="float64"):
    import torch

    from torchpme_tpu_torch.parallel import compute_sharded_md_state

    return compute_sharded_md_state(
        _calc(spec), _t(positions).to(getattr(torch, dtype)), _t(cell), cutoff, ns_mesh,
        torch.distributed.get_world_size(), rows=rows, aligned=aligned, device="cpu",
    )


def case_md(spec, charges, cell, positions, cutoff, ns_mesh, drift=None):
    """The atom-order step: energy and its gradients (q, cell, positions)."""
    from torchpme_tpu_torch.parallel import sharded_md_energy

    state = _md_state(spec, positions, cell, cutoff, ns_mesh)
    leaves = [_t(charges, True), _t(cell, True), _t(positions if drift is None else drift, True)]
    _reset()
    e = sharded_md_energy(_calc(spec), None, *leaves, state)
    grads = _grads(e, leaves)
    return dict(e=float(e.detach()), g_q=grads[0], g_cell=grads[1], g_pos=grads[2], counts=_counts())


def case_md_rows(spec, charges, cell, positions, cutoff, ns_mesh, aligned=False,
                 dtype="float64", drift_row=False, plain_state=False):
    """The rows step on this rank's block: energy, gradients (q, cell, the
    block) and the row-of-atom map (to gather the blocks in tests); with
    ``plain_state`` the errors of the entry's checks instead."""
    import torch
    import torch.distributed as dist

    from torchpme_tpu_torch.parallel import sharded_md_energy_rows

    dt = getattr(torch, dtype)
    state = _md_state(spec, positions, cell, cutoff, ns_mesh, rows=True, aligned=aligned,
                      dtype=dtype)
    rank = dist.get_rank()
    if plain_state:
        # the errors of the checks, in the order the JAX package's test asks
        plain = _md_state(spec, positions, cell, cutoff, ns_mesh)
        errors = []
        for call in (
            lambda: sharded_md_energy_rows(_calc(spec), None, _t(charges), _t(cell),
                                           state.rank_rows(state.bucket(_t(positions)), rank),
                                           plain),
            lambda: plain.bucket(_t(positions)),
            lambda: sharded_md_energy_rows(_calc(spec), None, _t(charges), _t(cell),
                                           state.rank_rows(state.bucket(_t(positions)),
                                                           rank)[:-8], state),
            lambda: sharded_md_energy_rows(_calc(spec), None, _t(charges), _t(cell),
                                           state.rank_rows(state.bucket(_t(positions)),
                                                           rank).double(), state),
        ):
            try:
                call()
                errors.append(None)
            except ValueError as err:
                errors.append(str(err))
        return dict(errors=errors)
    rows_all = state.bucket(_t(positions).to(dt))
    if drift_row:
        # half a box along x for the first atom: its cell goes stale
        rows_all = rows_all.clone()
        rows_all[int(state.row_of_atom[0]), 0] += float(cell[0][0]) / 2
    block = state.rank_rows(rows_all, rank).clone().requires_grad_()
    q, c = _t(charges, True), _t(cell, True)
    q_d, c_d = q.to(dt), c.to(dt)
    _reset()
    e = sharded_md_energy_rows(_calc(spec), None, q_d, c_d, block, state)
    g_q, g_c, g_rows = _grads(e, [q, c, block])
    counts = _counts()
    return dict(e=float(e.detach()), g_q=g_q, g_cell=g_c, g_rows=g_rows, counts=counts,
                row_of_atom=_np(state.row_of_atom), n_rows=state.n_rows, gathers=_GATHERS[0])


_GATHERS = [0]


def _count_slot_gathers():
    """Count the sharded steps' slot gathers (``sharded_md._gather_slots``)."""
    from torchpme_tpu_torch.parallel import sharded_md

    if getattr(sharded_md._gather_slots, "_counted", False):
        return
    inner = sharded_md._gather_slots

    def counted(*args, **kwargs):
        _GATHERS[0] += 1
        return inner(*args, **kwargs)

    counted._counted = True
    sharded_md._gather_slots = counted


def case_md_rows_gathers(**kwargs):
    """``case_md_rows`` with the slot gathers counted."""
    _count_slot_gathers()
    _GATHERS[0] = 0
    return case_md_rows(**kwargs)


def case_dipole_rows(spec, dipoles, cell, positions, cutoff, ns_mesh=None, drift_row=False,
                     errors=False):
    """The dipolar rows step on this rank's block (all gradients, or the
    smearing gradient of a trainable potential)."""
    import torch
    import torch.distributed as dist

    from torchpme_tpu_torch.parallel import (
        compute_sharded_md_dipole_state,
        sharded_md_dipole_energy_rows,
    )

    calc = _calc(spec)
    state = compute_sharded_md_dipole_state(
        calc, _t(positions), _t(cell), cutoff, dist.get_world_size(),
        ns_mesh=None if ns_mesh is None else tuple(ns_mesh), device="cpu",
    )
    rank = dist.get_rank()
    rows_all = state.bucket(_t(positions))
    if drift_row:
        rows_all = rows_all.clone()
        rows_all[int(state.row_of_atom[0]), 0] += float(cell[0][0]) / 2
    block = state.rank_rows(rows_all, rank).clone().requires_grad_()
    if errors:
        out = []
        for call in (
            lambda: sharded_md_dipole_energy_rows(calc, None, _t(dipoles), _t(cell),
                                                  block[:-8], state),
            lambda: sharded_md_dipole_energy_rows(calc, None, _t(dipoles)[:-1], _t(cell),
                                                  block, state),
        ):
            try:
                call()
                out.append(None)
            except ValueError as err:
                out.append(str(err))
        return dict(errors=out)
    mu, c = _t(dipoles, True), _t(cell, True)
    _reset()
    e = sharded_md_dipole_energy_rows(calc, None, mu, c, block, state)
    if spec.get("trainable"):
        (g_s,) = torch.autograd.grad(e, calc.potential.smearing)
        return dict(e=float(e.detach()), g_smearing=float(g_s), counts=_counts())
    g_mu, g_c, g_rows = _grads(e, [mu, c, block])
    return dict(e=float(e.detach()), g_mu=g_mu, g_cell=g_c, g_rows=g_rows, counts=_counts(),
                row_of_atom=_np(state.row_of_atom), n_rows=state.n_rows,
                ns_kvectors=state.ns_kvectors, cap=state.cl_slot_mask.shape[-1],
                tm=state.tm_slot_rows is not None)


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
