"""Kernels A, B, C and G as ``tpme::`` ops, on the CPU (defined here from
the schemas of ``csrc/tpme_ops.h``, their CPU kernels the plain versions):
``torch.library.opcheck`` of each op's registrations, the refusal of their
vmap registrations, the op's registered
autograd against the entry point's ``setup_context`` Function, the
window ops' schema tables against the potentials they stand for, and the
ops in a traced program."""

import numpy as np
import pytest
import torch

import torchpme_tpu_torch as tpt
from torchpme_tpu_torch import kernels
from torchpme_tpu_torch.ops import rspace_cells as rc
from torchpme_tpu_torch.ops import rspace_cells_dipole as rcd
from torchpme_tpu_torch.ops import spread_fused as sf

torch.set_num_threads(1)

NS = (32, 32, 32)
CUTOFF = 3.0
OPS = ("spread_fwd", "spread_bwd", "window", "window_dipole")


@pytest.fixture(scope="module")
def inputs():
    """The operands of each op from a small aligned MD state (200 atoms, a
    12.8 Å box of 4 × 4 × 4 cells, the 32³ mesh), float64."""
    rng = np.random.default_rng(5)
    positions = torch.tensor(rng.uniform(0, 12.8, (200, 3)))
    charges = torch.tensor(rng.normal(size=(200, 1)))
    dipoles = torch.tensor(rng.normal(size=(200, 3)))
    cell = torch.eye(3, dtype=torch.float64) * 12.8
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=5)
    fp = tpt.MDFastPath.create(calc, positions, cell, CUTOFF, NS, mesh_impl="aligned")
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = sf.aligned_geometry(5, fp.aligned_pad)
    geom = sf.SpreadGeometry(NS, 5, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap, nz_c)
    nb = geom.n_tiles * geom.slots_per_tile
    rows = fp.bucket(positions)
    rel = (rows @ torch.linalg.inv(cell) * torch.tensor(NS, dtype=torch.float64))[:nb]
    q_rows = torch.zeros((fp.n_rows, 1), dtype=torch.float64)
    q_rows = q_rows.index_copy(0, fp.row_of_atom.long(), charges)[:nb]
    ct_rho = torch.tensor(rng.normal(size=(1, *NS)))
    idx = fp.clist.atom_index.long()
    n_cells = idx.shape[0]
    window_in = rc._prepare_bucketed(charges[idx], rows[:nb].reshape(n_cells, cap, 3), cell,
                                     fp.clist, window=True)[:4]
    dipole_in = rc._prepare_bucketed(dipoles[idx], rows[:nb].reshape(n_cells, cap, 3), cell,
                                     fp.clist)[:4]
    table = rc.window_table(calc.potential)
    geometry, method = geom.as_args()
    return {
        "spread_fwd": (rel.contiguous(), q_rows.contiguous(), geometry, method),
        "spread_bwd": (rel.contiguous(), q_rows.contiguous(), ct_rho, geometry, method),
        "window": (*window_in, cell, *table, CUTOFF),
        "window_dipole": (*dipole_in, None, 1.0, 1.0, CUTOFF),
        "geom": geom,
    }


def _op(name):
    return getattr(torch.ops.tpme, name)


@pytest.mark.parametrize("name", OPS)
def test_opcheck(inputs, name):
    """Schema, fake, autograd registration and AOT dispatch of each op (B,
    the VJP of A, is differentiated no further)."""
    diff = name != "spread_bwd"
    args = [a.clone().requires_grad_(diff and a.is_floating_point())
            if isinstance(a, torch.Tensor) else a for a in inputs[name]]
    if name == "window":  # the mask and the offsets take no gradient
        args[2], args[3] = args[2].detach(), args[3].detach()
    torch.library.opcheck(_op(name), tuple(args))


@pytest.mark.parametrize("name", OPS)
def test_vmap_registration_refuses_a_batch(inputs, name):
    """Kernels A, B, C and G have no vmap rule: their ops raise the
    refusal of ``kernels.refuse_batched`` by any entry point."""
    args = inputs[name]
    batched = torch.stack([args[0], args[0]])

    def call(first):
        return _op(name)(first, *args[1:])

    with pytest.raises(NotImplementedError, match="no vmap rule"):
        torch.func.vmap(call)(batched)


def _grads(fn, leaves):
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    ct = torch.linspace(-1, 1, out.numel(), dtype=out.dtype).reshape(out.shape)
    return torch.autograd.grad((out * ct).sum(), leaves)


@pytest.mark.parametrize("name", ["spread_fwd", "window", "window_dipole"])
def test_registered_autograd_equals_the_entry_points_function(inputs, name):
    """The op's ``register_autograd`` (a direct call) and the entry points'
    ``setup_context`` Function (which ``torch.func.grad`` differentiates)
    run one VJP: equal cotangents."""
    args = list(inputs[name])
    diff = {"spread_fwd": (0, 1), "window": (0, 1, 4), "window_dipole": (0, 1, 3)}[name]
    entry = {"spread_fwd": sf._Spread, "window": rc._Window,
             "window_dipole": rcd._WindowDipole}[name]

    def run(fn):
        leaves = [args[i].clone().requires_grad_() for i in diff]

        def call(*xs):
            full = list(args)
            for i, x in zip(diff, xs):
                full[i] = x
            return fn(*full)

        return _grads(call, leaves)

    for a, b in zip(run(_op(name)), run(entry.apply)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_spread_op_is_the_wrapper(inputs):
    """``fused_spread``/``fused_spread_bwd`` go through the ops: on the CPU
    their bodies are the plain versions, bit for bit."""
    rel, q, ct_rho, *_ = inputs["spread_bwd"]
    geom = inputs["geom"]
    np.testing.assert_array_equal(sf.fused_spread(rel, q, geom).numpy(),
                                  sf.spread_plain(rel, q, geom).numpy())
    for a, b in zip(sf.fused_spread_bwd(rel, q, ct_rho, geom),
                    sf.spread_plain_bwd(rel, q, ct_rho, geom)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["coulomb", "ipl3_direct", "combined"])
def test_window_table_stands_for_its_potential(inputs, name, dtype):
    """The ``tpme::window`` op's plain body, from the pair-term table, gives
    the energy and gradients of the potential's own plain window, and the
    terms' energies of a ``CombinedPotential`` are its dE/dw."""
    pot = {
        "coulomb": tpt.CoulombPotential(smearing=1.0),
        "ipl3_direct": tpt.InversePowerLawPotential(exponent=3),
        "combined": tpt.CombinedPotential(
            [tpt.CoulombPotential(smearing=1.0),
             tpt.InversePowerLawPotential(exponent=6, smearing=1.0)],
            initial_weights=torch.tensor([1.0, -0.5], dtype=torch.float64), smearing=1.0),
    }[name]
    pc_t, q_g, mf_g, offs, cell = (t.to(dtype) for t in inputs["window"][:5])
    with torch.no_grad():
        e, *grads, members = torch.ops.tpme.window(pc_t, q_g, mf_g, offs, cell,
                                                   *rc.window_table(pot), CUTOFF)
    ref = rc._we_value_and_grad(pot, CUTOFF, pc_t, q_g, mf_g, offs, with_params=True)
    tol = 1e-12 if dtype == torch.float64 else 0.0
    assert abs(float(e) - float(ref[0])) <= tol * abs(float(ref[0]))
    for a, b in zip(grads, ref[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=tol * float(b.abs().max()))
    if name == "combined":
        np.testing.assert_allclose(members.numpy(), ref[2][0].numpy(), rtol=1e-12 if tol else 0)
    assert kernels.PLAIN_VERSIONS.keys() >= set(OPS)


@pytest.mark.parametrize("name", ["spread_fwd", "window", "window_dipole"])
def test_entry_point_exports_the_op_itself(inputs, name):
    """``deploy``'s trace of an entry point's ``setup_context`` Function,
    kept for a card (no plain versions put in), holds the op itself as one
    ``tpme::`` node, and the program reproduces the eager call."""
    from torchpme_tpu_torch import deploy

    args = list(inputs[name])
    entry = {"spread_fwd": sf._Spread, "window": rc._Window,
             "window_dipole": rcd._WindowDipole}[name]

    def call(first):
        out = entry.apply(first, *args[1:])
        return out[0] if isinstance(out, tuple) else out

    program = deploy._trace(deploy._Step(call, None), (args[0],), plain=False)
    targets = [str(n.target) for n in program.graph.nodes if deploy._is_tpme(n)]
    assert targets == [f"tpme.{name}.default"]
    np.testing.assert_array_equal(program.module()(args[0]).detach().numpy(),
                                  call(args[0]).detach().numpy())


def test_window_op_with_split_charges(inputs):
    """The ``tpme::window`` op with separate i-side charges (kernel C's split
    variant on a card): ``opcheck`` of the new operand, and its registered
    autograd against the entry point's ``setup_context`` Function."""
    args = list(inputs["window"])
    qi = (args[1] * torch.linspace(0.0, 1.5, args[1].shape[0], dtype=args[1].dtype)
          [:, None, None, None, None]).contiguous()
    leaves = [args[0], args[1], args[4], qi]
    full = [a.clone().requires_grad_() if i in (0, 1, 4) else a for i, a in enumerate(args)]
    torch.library.opcheck(_op("window"), (*full, qi.clone().requires_grad_()))

    def run(fn):
        xs = [t.clone().requires_grad_() for t in leaves]
        call = list(args)
        call[0], call[1], call[4] = xs[0], xs[1], xs[2]
        out = fn(*call, xs[3])
        return torch.autograd.grad(out[0], xs)

    for a, b in zip(run(_op("window")), run(rc._Window.apply)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
