"""Kernel C's split variant on the CPU (its plain version): separate i-side
charges ``qi_g`` through ``ops/rspace_cells.py`` ≡ the JAX package's
``_window_energy_split`` (value and the i- and j-side charge cotangents
apart), ``qi_g = q_g`` ≡ the unsplit window bit for bit, and the repaired
``compute_cell_list(x_multiple=)`` ≡ the JAX package's arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import clist_arrays, port_clist, random_box, rel, rows_of

import torchpme_tpu as tpme
from torchpme_tpu.ops import rspace_cells as jax_rc
from torchpme_tpu_torch import CoulombPotential, InversePowerLawPotential
from torchpme_tpu_torch.ops import rspace_cells as port_rc

torch.set_num_threads(1)

SMEARING, CUTOFF = 1.0, 3.0


@pytest.fixture(scope="module", params=["cubic", "triclinic"])
def grids(request):
    """Window inputs of a random box, with i-side charges zeroed on the last
    x plane (the halo plane of a slab) and, on the triclinic box, scaled
    elsewhere so every role shows."""
    pos, q, cell = random_box(260, 14.0, seed=8)
    if request.param == "triclinic":
        cell = cell + np.asarray([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [0.5, -1.0, 0.0]])
    clist_j = jax_rc.compute_cell_list(pos, cell, CUTOFF, spill=False)
    clist = port_clist(clist_j)
    n_cells, cap = clist.slot_mask.shape
    rows = torch.tensor(rows_of(clist_j, pos)[: n_cells * cap]).reshape(n_cells, cap, 3)
    pc_t, q_g, mf_g, offs, _ = port_rc._prepare_bucketed(
        torch.tensor(q)[clist.atom_index.long()], rows, torch.tensor(cell), clist
    )
    scale = torch.ones(pc_t.shape[0], dtype=torch.float64)
    scale[-1] = 0.0
    if request.param == "triclinic":
        scale[:-1] = torch.linspace(0.5, 1.5, pc_t.shape[0] - 1, dtype=torch.float64)
    qi_g = q_g * scale[:, None, None, None, None]
    return pc_t, q_g, mf_g, offs, qi_g


def _jax_split(pc_t, q_g, mf_g, offs, qi_g):
    pot = tpme.CoulombPotential(smearing=SMEARING)
    chunks = jax_rc._half_window_chunks(pc_t.shape[-1])
    spec = jax_rc._window_spec(CUTOFF, chunks, pot)
    args = [jnp.asarray(t.numpy()) for t in (pc_t, q_g, mf_g, offs, qi_g)]

    def energy(pc, q, offs_, qi):
        return jax_rc._window_energy_split(spec, pot, pc, q, args[2], offs_, qi)

    e, grads = jax.jit(jax.value_and_grad(energy, argnums=(0, 1, 2, 3)))(
        args[0], args[1], args[3], args[4]
    )
    return float(e), [np.asarray(g) for g in grads]


def test_split_window_matches_jax(grids):
    pc_t, q_g, mf_g, offs, qi_g = grids
    e_j, (g_pc, g_q, g_offs, g_qi) = _jax_split(*grids)
    e, (d_pc, d_q, d_offs, d_image, d_qi) = port_rc._we_value_and_grad(
        CoulombPotential(smearing=SMEARING), CUTOFF, pc_t, q_g, mf_g, offs, qi_g=qi_g
    )
    assert abs(float(e) - e_j) <= 1e-12 * abs(e_j)
    assert rel(d_pc.numpy(), g_pc) <= 1e-12
    # the i- and j-side cotangents apart, each against JAX's own
    assert rel(d_qi.numpy(), g_qi) <= 1e-12
    assert rel(d_q.numpy(), g_q) <= 1e-12
    # every offset but the self cell's, whose vector is zero: the port's row
    # there is 0 (kernel C's split variant writes 0)
    self_k = port_rc._window_offsets(pc_t.shape[-1]).index((0, 0, 0))
    keep = [k for k in range(offs.shape[0]) if k != self_k]
    assert rel(d_offs.numpy()[keep], g_offs[keep]) <= 1e-12
    assert float(d_offs[self_k].abs().max()) == 0.0
    assert d_image.shape == (3, 3)


@pytest.mark.parametrize("pot", ["coulomb", "ipl3_direct"])
def test_split_with_equal_charges_is_the_unsplit_window(grids, pot):
    """``qi_g = q_g``: the energy, d_pc and d_q + d_qi of the unsplit window,
    through the op's plain body (float64 and float32)."""
    potential = {"coulomb": CoulombPotential(smearing=SMEARING),
                 "ipl3_direct": InversePowerLawPotential(exponent=3)}[pot]
    for dtype in (torch.float64, torch.float32):
        pc_t, q_g, mf_g, offs, _ = (t.to(dtype) for t in grids)
        e0, g0 = port_rc.window_value_and_grad(potential, CUTOFF, pc_t, q_g, mf_g, offs)
        e1, g1 = port_rc.window_value_and_grad(
            potential, CUTOFF, pc_t, q_g, mf_g, offs, qi_g=q_g.clone()
        )
        assert torch.equal(e0, e1)
        assert torch.equal(g0[0], g1[0])
        assert torch.equal(g0[3], g1[3])
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        assert rel((g1[1] + g1[4]).numpy(), g0[1].numpy()) <= tol


def test_split_gradients_flow_through_autograd(grids):
    """``_window_energy`` with ``qi_g``: autograd gives the plain version's
    d_pc, d_q, d_qi (kernel C's op route and the plain route for a potential
    outside its table)."""
    pc_t, q_g, mf_g, offs, qi_g = grids
    pot = CoulombPotential(smearing=SMEARING)
    _, ref = port_rc._we_value_and_grad(pot, CUTOFF, pc_t, q_g, mf_g, offs, qi_g=qi_g)
    leaves = [t.clone().requires_grad_() for t in (pc_t, q_g, qi_g)]
    cell = torch.zeros((3, 3), dtype=torch.float64, requires_grad=True)
    e = port_rc._window_energy(pot, leaves[0], leaves[1], mf_g, offs, cell, CUTOFF, False,
                               qi_g=leaves[2])
    grads = torch.autograd.grad(e, [*leaves, cell])
    for got, want in zip(grads, (ref[0], ref[1], ref[4], ref[3])):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("multiple", [1, 2, 3, 4])
def test_cell_list_x_multiple_matches_jax(triclinic, multiple):
    pos, _, cell = random_box(300, 13.0, seed=4)
    if triclinic:
        cell = cell + np.asarray([[0.0, 0.0, 0.0], [0.8, 0.0, 0.0], [0.0, -0.5, 0.0]])
    ref = jax_rc.compute_cell_list(pos, cell, 2.0, spill=False, x_multiple=multiple)
    got = port_rc.compute_cell_list(pos, cell, 2.0, spill=False, x_multiple=multiple,
                                    device="cpu")
    assert got.n_axis == ref.n_axis and got.n_axis[0] % multiple == 0
    got_arrays = clist_arrays(got)
    for name, a in clist_arrays(ref).items():
        b = got_arrays[name]
        if a is None:
            assert b is None
            continue
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


def test_cell_list_x_multiple_refuses_too_few_planes():
    pos, _, cell = random_box(100, 10.0, seed=4)
    with pytest.raises(ValueError, match="cell planes"):
        jax_rc.compute_cell_list(pos, cell, 3.0, x_multiple=4)
    with pytest.raises(ValueError, match="cell planes"):
        port_rc.compute_cell_list(pos, cell, 3.0, x_multiple=4, device="cpu")
