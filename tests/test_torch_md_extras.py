"""The port's MD step over the potential family, and the extras tile table.

* The extras tile table (``MDFastPath.create(extras_impl="tiled")``) mirrors
  ``tests/test_md_extras.py``: the aligned step with its spill rows spread
  through the table ≡ the JAX package's (float32, its Pallas kernels in
  interpret mode), the scatter and tiled routes agree, a stale extra
  NaN-poisons the step, the options are validated, and ``"auto"`` is the
  scatter at any number of spills (the H100 measurement moved JAX's ≥ 512
  rule).
* MD steps over a learnable Combined (Coulomb + 1/r³ + 1/r⁶: the float64
  E₁ of the 1/r³ filter, the finite k → 0 limit of 1/r⁶): aligned, fused and
  tiled mode (extras table and scatter) ≡ the JAX package's energy over the
  same pairs and mesh (its per-atom call, which its own MD step equals) in
  float64 to 1e-10 (energy, forces, cell gradient, dE/dw).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_md_state, lattice_box, port_from_jax, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu_torch.convert import md_from_state, md_state

torch.set_num_threads(1)


# -- the extras tile table (tests/test_md_extras.py) --------------------------------

SPILL_NS = (16, 16, 16)
SPILL_CUTOFF = 0.9


def _spilled_system():
    """tests/test_md_extras.py's clustered float32 box (spills at capacity 8)."""
    rng = np.random.default_rng(3)
    n, box = 48, 4.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    pos[:14] = rng.uniform(0.1, 0.9, (14, 3)).astype(np.float32)
    q = rng.normal(size=(n, 1)).astype(np.float32)
    q -= q.mean()
    return pos, q, np.eye(3, dtype=np.float32) * box


def _spill_calcs():
    return (tpme.PMECalculator(tpme.CoulombPotential(smearing=0.35), interpolation_nodes=4),
            tpt.PMECalculator(tpt.CoulombPotential(smearing=0.35), interpolation_nodes=4))


def _port_spill_fp(calc, pos, cell, extras_impl, dtype=torch.float32):
    return tpt.MDFastPath.create(
        calc, torch.tensor(pos, dtype=dtype), torch.tensor(cell, dtype=dtype), SPILL_CUTOFF,
        SPILL_NS, mesh_impl="aligned", cell_capacity=8, extras_impl=extras_impl, balance=False,
        _spill=True,
    )


def _port_step(fp, pos, q, cell, dtype, plain=False):
    """(energy, atom-order forces, cell gradient[, dE/dw]) of the port's step."""
    c = torch.tensor(cell, dtype=dtype, requires_grad=True)
    rows = fp.bucket(torch.tensor(pos, dtype=dtype)).requires_grad_()
    e = fp.energy(torch.tensor(q, dtype=dtype), c, rows, plain=plain)
    wants = [rows, c] + ([fp.calc.potential.weights] if _learnable(fp.calc.potential) else [])
    grads = torch.autograd.grad(e, wants)
    return (float(e.detach()), -fp.unbucket(grads[0]).numpy(), grads[1].numpy(),
            *(g.numpy() for g in grads[2:]))


def _learnable(pot) -> bool:
    return isinstance(getattr(pot, "weights", None), torch.nn.Parameter)


@pytest.fixture(scope="module")
def spilled_jax_tiled():
    """The JAX package's aligned step with the extras table, float32."""
    pos, q, cell = _spilled_system()
    calc_j, _ = _spill_calcs()
    fp_j = tpme.MDFastPath.create(
        calc_j, jnp.asarray(pos), jnp.asarray(cell), SPILL_CUTOFF, SPILL_NS, mesh_impl="aligned",
        cell_capacity=8, extras_impl="tiled", balance=False, _spill=True,
    )
    rows = fp_j.bucket(jnp.asarray(pos))
    e, (g_cell, g_rows) = jax.jit(jax.value_and_grad(fp_j.energy, argnums=(1, 2)))(
        jnp.asarray(q), jnp.asarray(cell), rows)
    return fp_j, (float(e), -np.asarray(fp_j.unbucket(g_rows)), np.asarray(g_cell))


def test_extras_table_matches_jax(spilled_jax_tiled):
    """Same table (slots, sentinels, weights) as the JAX package's, and the
    same float32 step: energy to 2e-5, forces and cell gradient to 5e-5 of
    max (the bars of tests/test_torch_md.py's float32 aligned step)."""
    fp_j, (e_j, f_j, c_j) = spilled_jax_tiled
    pos, q, cell = _spilled_system()
    _, calc = _spill_calcs()
    fp = _port_spill_fp(calc, pos, cell, "tiled")
    assert fp.extras_tiled is not None and int(fp.clist.extra_mask.sum()) > 0
    ours, theirs = md_state(fp)["extras_tiled"], jax_md_state(fp_j)["extras_tiled"]
    for name in ("local_x", "local_y", "start_z", "slot_of_atom", "atom_of_slot", "dropped"):
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    np.testing.assert_allclose(ours["weights"], theirs["weights"], atol=1e-6)
    e, f, c = _port_step(fp, pos, q, cell, torch.float32)
    assert abs(e - e_j) <= 2e-5 * abs(e_j)
    assert rel(f, f_j) <= 5e-5 and rel(c, c_j) <= 5e-5
    # the JAX state, converted, runs the same step
    e_conv = _port_step(port_from_jax(fp_j), pos, q, cell, torch.float32)[0]
    assert abs(e_conv - e) <= 1e-6 * abs(e)


def test_extras_routes_agree():
    """Table and scatter are the same math (same stencils, another order of
    summation): the step agrees to 1e-6 in float32 and to 1e-12 in
    float64, forces and cell gradient included."""
    pos, q, cell = _spilled_system()
    _, calc = _spill_calcs()
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        steps = [_port_step(_port_spill_fp(calc, pos, cell, impl, dtype), pos, q, cell, dtype)
                 for impl in ("tiled", "scatter")]
        (e_t, f_t, c_t), (e_s, f_s, c_s) = steps
        assert abs(e_t - e_s) <= tol * abs(e_s)
        assert rel(f_t, f_s) <= 10 * tol and rel(c_t, c_s) <= 10 * tol


def test_extras_stale_poisons():
    pos, q, cell = _spilled_system()
    _, calc = _spill_calcs()
    fp = _port_spill_fp(calc, pos, cell, "tiled")
    rows = fp.bucket(torch.tensor(pos)).requires_grad_()
    e_pad = fp.clist.extra_mask.shape[0]
    erow = fp.n_rows - e_pad + int(torch.argmax(fp.clist.extra_mask.int()))
    bad = rows.detach().clone()
    bad[erow] += torch.tensor([2.5, 2.5, 0.0])
    bad.requires_grad_()
    e = fp.energy(torch.tensor(q), torch.tensor(cell), bad)
    (g,) = torch.autograd.grad(e, bad)
    assert not np.isfinite(float(e.detach())) and not bool(torch.isfinite(g).all())
    # a rebucket keeps the table
    assert fp.rebucket(rows.detach(), torch.tensor(cell)).extras_tiled is not None


def test_extras_impl_validated_and_auto_rule():
    pos, q, cell = _spilled_system()
    _, calc = _spill_calcs()
    with pytest.raises(ValueError, match="extras_impl"):
        _port_spill_fp(calc, pos, cell, "bogus")
    # "auto" is the scatter at any number of spill atoms (on an H100 the table
    # lost at 168 and at 1101, PERF.md; the JAX package's "auto" takes it from
    # 512 on): here 48 spills and, in a denser box, more than 512
    assert _port_spill_fp(calc, pos, cell, "auto").extras_tiled is None
    rng = np.random.default_rng(7)
    dense = rng.uniform(0, 16.0, (2000, 3))
    kw = dict(mesh_impl="aligned", cell_capacity=12, balance=False, _spill=True, device="cpu")
    fp = tpt.MDFastPath.create(calc, dense, np.eye(3) * 16.0, 3.0, (32, 32, 32),
                               extras_impl="auto", **kw)
    assert int(fp.clist.extra_mask.sum()) >= 512 and fp.extras_tiled is None
    assert tpt.MDFastPath.create(calc, dense, np.eye(3) * 16.0, 3.0, (32, 32, 32),
                                 extras_impl="tiled", **kw).extras_tiled is not None


# -- MD steps over the potential family, float64 -----------------------------------

NS = (32, 32, 32)
CUTOFF = 3.0
W = np.array([0.8, -0.25, 0.1])


def _family_pot(pkg, weights):
    return pkg.CombinedPotential(
        [pkg.CoulombPotential(smearing=1.0)]
        + [pkg.InversePowerLawPotential(exponent=p, smearing=1.0) for p in (3, 6)],
        initial_weights=weights, smearing=1.0)


@pytest.fixture(scope="module")
def family_ref():
    """The JAX package's float64 energy sum(pot·q) of the per-atom PME call
    over a neighbor list at the step's cutoff and mesh (the MD step's energy:
    the same pairs and the same mesh), its forces, cell gradient and dE/dw."""
    from torchpme_tpu.utils.neighbors import compute_distances, neighbor_list

    pos, q, cell = lattice_box(6)
    idx, _, shifts = map(jnp.asarray, neighbor_list(pos, cell, CUTOFF))

    def energy(w, c, p):
        calc_j = tpme.PMECalculator(_family_pot(tpme, w), mesh_spacing=0.5, interpolation_nodes=5,
                                    mesh_backend="scatter")
        d = compute_distances(p, idx, c, shifts)
        return jnp.sum(calc_j(jnp.asarray(q), c, p, idx, d, ns_mesh=NS) * jnp.asarray(q))

    e, (g_w, g_cell, g_pos) = jax.jit(jax.value_and_grad(energy, argnums=(0, 1, 2)))(
        jnp.asarray(W), jnp.asarray(cell), jnp.asarray(pos))
    return float(e), -np.asarray(g_pos), np.asarray(g_cell), np.asarray(g_w)


@pytest.mark.parametrize("mode", ["aligned_table", "aligned_scatter", "fused", "tiled"])
def test_family_md_step_f64_matches_jax(family_ref, mode):
    ref = family_ref
    pos, q, cell = lattice_box(6)
    calc = tpt.PMECalculator(_family_pot(tpt, torch.tensor(W)), mesh_spacing=0.5,
                             interpolation_nodes=5)
    mesh_impl = "aligned" if mode.startswith("aligned") else mode
    fp = tpt.MDFastPath.create(
        calc, torch.tensor(pos), torch.tensor(cell), CUTOFF, NS, mesh_impl=mesh_impl,
        cell_capacity=5, _spill=True,
        extras_impl="scatter" if mode == "aligned_scatter" else "tiled",
    )
    assert fp.clist.extra_index is not None
    assert (fp.extras_tiled is not None) == (mode == "aligned_table")
    got = _port_step(fp, pos, q, cell, torch.float64)
    # the numpy state carries the potential (members, weights) and the table
    back = md_from_state(md_state(fp), device="cpu")
    assert (back.extras_tiled is None) == (fp.extras_tiled is None)
    assert _port_step(back, pos, q, cell, torch.float64)[0] == got[0]
    assert len(got) == len(ref)
    assert abs(got[0] - ref[0]) <= 1e-10 * abs(ref[0])
    for what, a, b in zip(("forces", "cell", "weights"), got[1:], ref[1:]):
        assert rel(a, b) <= 1e-10, (what, rel(a, b))
