"""The module of kernel G (``ops/rspace_cells_dipole.py``): the plain
version of the dipolar window ≡ the JAX package's XLA engine in float64
(1e-10 on every cotangent) and ≡ its fused Pallas kernel, run in interpret
mode, in float32 (that kernel's own tolerances: 3e-5 of max, 5e-4 for the
cancelling ``d_offs`` sum); the two entry points with a spill list, the plain
autograd path of trainable / exclusion-window potentials, the staleness
poison and the wrapper's contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_kernel_params as kernel_params
from torch_port_common import clustered_box, dipole_box, port_clist, rel, rows_of

import torchpme_tpu as tpme
from torchpme_tpu.ops import rspace_cells as jax_rc
from torchpme_tpu.ops import rspace_cells_dipole as jax_rcd
from torchpme_tpu.ops.pallas import window_dipole_pallas as jax_wdp
from torchpme_tpu_torch import PotentialDipole
from torchpme_tpu_torch.ops import rspace_cells as port_rc
from torchpme_tpu_torch.ops import rspace_cells_dipole as port_rcd

torch.set_num_threads(1)

CUTOFF = 3.0
GRAD_NAMES = ("d_pc", "d_mu", "d_offs", "d_mui")


def _window_inputs(n, box, smearing, dt, triclinic=False, seed=0, split=False):
    """JAX potential + window arrays, and the same arrays as torch tensors."""
    positions, dipoles, cell = dipole_box(n, box, seed, triclinic)
    jdt = getattr(jnp, dt)
    clist = jax_rc.compute_cell_list(positions, cell, CUTOFF, spill=False)
    pc_t, mu_g, mf_g, offs, _valid, chunks = jax_rc._prepare(
        jnp.asarray(dipoles, jdt), jnp.asarray(positions, jdt), jnp.asarray(cell, jdt), clist
    )
    arrays_j = [pc_t, mu_g, mf_g, offs]
    if split:
        keep = np.random.default_rng(42).uniform(size=mu_g.shape[:3]) > 0.3
        arrays_j.append(mu_g * jnp.asarray(keep, jdt)[..., None, None])
    else:
        arrays_j.append(None)
    pot_j = tpme.PotentialDipole(smearing=smearing, prefactor=1.3)
    pot_t = PotentialDipole(smearing=smearing, prefactor=1.3)
    arrays_t = [None if a is None else torch.tensor(np.asarray(a)) for a in arrays_j]
    return pot_j, pot_t, arrays_j, arrays_t, chunks


def _jax_grads(grads):
    """(d_pc, d_mu, d_offs[, d_mui]) of the JAX cotangent tuple
    (d_pot, d_pc, d_mu, d_mf, d_offs[, d_mui])."""
    return [np.asarray(g) for g in (grads[1], grads[2], grads[4], *grads[5:])]


F64_CASES = {
    "sr": dict(n=400, box=12.0, smearing=0.75),
    "direct": dict(n=400, box=12.0, smearing=None),
    "triclinic": dict(n=450, box=13.0, smearing=0.9, triclinic=True, seed=5),
    "split": dict(n=400, box=12.0, smearing=0.75, seed=7, split=True),
}


@pytest.mark.parametrize("name", list(F64_CASES))
def test_plain_window_matches_jax_f64(name):
    pot_j, pot_t, arrays_j, arrays_t, chunks = _window_inputs(dt="float64", **F64_CASES[name])
    spec = (CUTOFF, chunks, True)
    e_j, g_j = jax.jit(lambda *a: jax_rcd._dw_value_and_grad(spec, pot_j, *a))(*arrays_j)
    e_t, g_t = port_rcd._dw_value_and_grad(pot_t, CUTOFF, *arrays_t)
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    ref = _jax_grads(g_j)
    assert len(g_t) == len(ref) == (4 if name == "split" else 3)
    for label, a, b in zip(GRAD_NAMES, g_t, ref):
        assert a.dtype == torch.float64
        assert rel(a.numpy(), b) <= 1e-10, label


@pytest.mark.parametrize("name", ["sr", "direct", "split"])
def test_plain_window_matches_jax_pallas_kernel_f32(name):
    """float32: the port's plain version against the JAX package's fused
    kernel in interpret mode, as tests/ops/test_window_dipole_pallas.py holds
    that kernel against the XLA engine."""
    pot_j, pot_t, arrays_j, arrays_t, chunks = _window_inputs(dt="float32", **F64_CASES[name])
    spec = (CUTOFF, chunks, True, True)
    e_j, g_j = jax.jit(
        lambda *a: jax_wdp.pallas_dipole_window_value_and_grad(spec, pot_j, *a)
    )(*arrays_j)
    e_t, g_t = port_rcd._dw_value_and_grad(pot_t, CUTOFF, *arrays_t)
    assert e_t.dtype == torch.float32
    assert abs(float(e_t) - float(e_j)) <= 3e-5 * abs(float(e_j))
    tols = {"d_pc": 3e-5, "d_mu": 3e-5, "d_offs": 5e-4, "d_mui": 3e-5}
    for label, a, b in zip(GRAD_NAMES, g_t, _jax_grads(g_j)):
        assert a.dtype == torch.float32
        assert rel(a.numpy(), b) <= tols[label], label


def test_plain_window_f32_is_its_f64_self():
    """The fused float32 pair math (A&S erfc, rsqrt) against the exact float64
    scalars on the same inputs: 1e-5 of max, `d_offs` 1e-4 (it sums every
    j-side force of an offset, which cancel)."""
    _, pot_t, _, arrays_t, _ = _window_inputs(dt="float32", **F64_CASES["sr"])
    e32, g32 = port_rcd._dw_value_and_grad(pot_t, CUTOFF, *arrays_t)
    e64, g64 = port_rcd._dw_value_and_grad(
        pot_t, CUTOFF, *[None if a is None else a.double() for a in arrays_t]
    )
    assert abs(float(e32) - float(e64)) <= 1e-5 * abs(float(e64))
    for label, a, b in zip(GRAD_NAMES, g32, g64):
        assert rel(a.numpy(), b.numpy()) <= (1e-4 if label == "d_offs" else 1e-5), label


# -- entry points --------------------------------------------------------------------


def _spilled_system():
    positions, _, cell = clustered_box(300, 16.0, seed=2)
    dipoles = np.random.default_rng(9).normal(size=(positions.shape[0], 3))
    clist = jax_rc.compute_cell_list(positions, cell, CUTOFF)
    assert clist.extra_index is not None, "system did not spill"
    return positions, dipoles, cell, clist


ENTRY_CASES = [("spilled", 0.8), ("spilled", None), ("triclinic", 0.8)]


@pytest.fixture(scope="module", params=ENTRY_CASES, ids=[f"{n}-{s}" for n, s in ENTRY_CASES])
def entry(request):
    name, smearing = request.param
    if name == "spilled":
        positions, dipoles, cell, clist_j = _spilled_system()
    else:
        positions, dipoles, cell = dipole_box(300, 14.0, 8, triclinic=True)
        clist_j = jax_rc.compute_cell_list(positions, cell, CUTOFF)
    rows = rows_of(clist_j, positions)
    pot_j = tpme.PotentialDipole(smearing=smearing, prefactor=0.9)

    def e_j(mu, rr, cc):
        return jax_rcd.cell_list_rspace_dipole_energy_rows(pot_j, mu, rr, cc, clist_j)

    ej, gj = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1, 2)))(
        jnp.asarray(dipoles), jnp.asarray(rows), jnp.asarray(cell)
    )
    return dict(
        positions=positions, dipoles=dipoles, rows=rows, cell=cell, smearing=smearing,
        clist=port_clist(clist_j), e_j=float(ej), g_j=[np.asarray(g) for g in gj],
    )


def _port_rows(entry, pot=None, plain=False, dt=torch.float64):
    pot = pot or PotentialDipole(smearing=entry["smearing"], prefactor=0.9)
    args = [
        torch.tensor(entry[k], dtype=dt, requires_grad=True)
        for k in ("dipoles", "rows", "cell")
    ]
    e = port_rcd.cell_list_rspace_dipole_energy_rows(pot, *args, entry["clist"], plain=plain)
    return float(e.detach()), [g.numpy() for g in torch.autograd.grad(e, args)]


def test_rows_entry_point_matches_jax(entry):
    e, grads = _port_rows(entry)
    assert abs(e - entry["e_j"]) <= 1e-10 * abs(entry["e_j"])
    for label, a, b in zip(("dipoles", "pos_rows", "cell"), grads, entry["g_j"]):
        assert rel(a, b) <= 1e-10, label


def test_atom_order_entry_point_is_the_rows_one(entry):
    e_rows, g_rows = _port_rows(entry)
    args = [
        torch.tensor(entry[k], requires_grad=True) for k in ("dipoles", "positions", "cell")
    ]
    pot = PotentialDipole(smearing=entry["smearing"], prefactor=0.9)
    e = port_rcd.cell_list_rspace_dipole_energy(pot, *args, entry["clist"])
    g = torch.autograd.grad(e, args)
    assert float(e.detach()) == pytest.approx(e_rows, rel=1e-13)
    assert rel(g[0].numpy(), g_rows[0]) <= 1e-12
    assert rel(g[2].numpy(), g_rows[2]) <= 1e-12
    # the position gradient is the row gradient, un-bucketed
    back = rows_of_gradient(entry, g_rows[1])
    assert rel(g[1].numpy(), back) <= 1e-12


def rows_of_gradient(entry, g_rows):
    """Atom-order view of a row-layout gradient."""
    clist = entry["clist"]
    out = np.zeros_like(entry["positions"])
    idx, msk = clist.atom_index.numpy(), clist.slot_mask.numpy()
    n_cells, cap = msk.shape
    out[idx[msk]] = g_rows[: n_cells * cap].reshape(n_cells, cap, 3)[msk]
    if clist.extra_index is not None:
        e_idx, e_msk = clist.extra_index.numpy(), clist.extra_mask.numpy()
        out[e_idx[e_msk]] = g_rows[n_cells * cap :][e_msk]
    return out


def test_plain_flag_is_the_cpu_path(entry):
    e_a, g_a = _port_rows(entry)
    e_b, g_b = _port_rows(entry, plain=True)
    assert e_a == e_b
    for a, b in zip(g_a, g_b):
        np.testing.assert_array_equal(a, b)


def test_autograd_path_of_trainable_parameters_is_the_analytic_one(entry):
    """A potential parameter that requires grad sends the window down plain
    autograd (`_dw_math`): same energy and gradients as the fused pass, and a
    gradient for the parameter."""
    if entry["smearing"] is None:
        prefactor = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
        pot, param = PotentialDipole(prefactor=prefactor), prefactor
    else:
        smearing = torch.tensor(entry["smearing"], dtype=torch.float64, requires_grad=True)
        pot, param = PotentialDipole(smearing=smearing, prefactor=0.9), smearing
    assert not port_rcd._can_use_analytic_dipole(pot)
    args = [torch.tensor(entry[k], requires_grad=True) for k in ("dipoles", "rows", "cell")]
    e = port_rcd.cell_list_rspace_dipole_energy_rows(pot, *args, entry["clist"])
    *grads, g_param = torch.autograd.grad(e, (*args, param))
    e_ref, g_ref = _port_rows(entry)
    assert float(e.detach()) == pytest.approx(e_ref, rel=1e-12)
    for a, b in zip(grads, g_ref):
        assert rel(a.numpy(), b) <= 1e-10
    assert np.isfinite(float(g_param)) and float(g_param) != 0.0


def test_exclusion_window_takes_the_autograd_path_and_matches_jax():
    positions, dipoles, cell = dipole_box(200, 10.0, 4)
    clist_j = jax_rc.compute_cell_list(positions, cell, CUTOFF)
    rows = rows_of(clist_j, positions)
    kw = dict(smearing=0.8, exclusion_radius=2.0, exclusion_degree=2)
    pot_j, pot_t = tpme.PotentialDipole(**kw), PotentialDipole(**kw)
    assert not port_rcd._can_use_analytic_dipole(pot_t)

    def e_j(mu, rr):
        return jax_rcd.cell_list_rspace_dipole_energy_rows(
            pot_j, mu, rr, jnp.asarray(cell), clist_j
        )

    ej, gj = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1)))(
        jnp.asarray(dipoles), jnp.asarray(rows)
    )
    args = [torch.tensor(a, requires_grad=True) for a in (dipoles, rows)]
    e = port_rcd.cell_list_rspace_dipole_energy_rows(
        pot_t, *args, torch.tensor(cell), port_clist(clist_j)
    )
    grads = torch.autograd.grad(e, args)
    assert float(e.detach()) == pytest.approx(float(ej), rel=1e-10)
    for a, b in zip(grads, gj):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-10


def test_stale_bucketing_poisons_energy_and_gradients(entry):
    moved = {**entry, "rows": entry["rows"].copy()}
    moved["rows"][3, 0] += 8.0  # far out of its cell
    e, grads = _port_rows(moved)
    assert np.isnan(e)
    assert all(np.isnan(g).all() for g in grads[:2])


# -- the wrapper's contract ---------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_cpu():
    _, pot_t, _, arrays_t, _ = _window_inputs(dt="float32", **F64_CASES["split"])
    e_a, g_a = port_rcd.dipole_window_value_and_grad(pot_t, CUTOFF, *arrays_t)
    e_b, g_b = port_rcd._dw_value_and_grad(pot_t, CUTOFF, *arrays_t)
    assert float(e_a) == float(e_b)
    for a, b in zip(g_a, g_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_raises_off_cpu():
    _, pot_t, _, arrays_t, _ = _window_inputs(dt="float64", **F64_CASES["sr"])
    meta = [None if a is None else a.to("meta") for a in arrays_t]
    with pytest.raises(TypeError, match="float32"):
        port_rcd.dipole_window_value_and_grad(pot_t, CUTOFF, *meta)
    meta32 = [None if a is None else a.float() for a in meta]
    with pytest.raises(ValueError, match="CUDA"):
        port_rcd.dipole_window_value_and_grad(pot_t, CUTOFF, *meta32)
    from torchpme_tpu_torch import CoulombPotential

    with pytest.raises(TypeError, match="point-dipole"):
        port_rcd.dipole_window_value_and_grad(CoulombPotential(smearing=1.0), CUTOFF, *meta32)
    with pytest.raises(ValueError, match="exclusion window"):
        port_rcd.dipole_window_value_and_grad(
            PotentialDipole(smearing=1.0, exclusion_radius=2.0), CUTOFF, *meta32
        )


def test_non_analytic_potential_raises_off_cpu_unless_plain(monkeypatch):
    """An exclusion window or a trainable parameter has no kernel: off the CPU
    the window raises and names ``plain=True``; with the flag, and on the CPU,
    it reaches the plain autograd `_dw_math`."""
    _, _, _, arrays_t, _ = _window_inputs(dt="float32", **F64_CASES["sr"])
    pc_t, mu_g, mf_g, offs, _ = arrays_t
    trainable = PotentialDipole(smearing=torch.tensor(0.75, requires_grad=True))
    excluded = PotentialDipole(smearing=0.75, exclusion_radius=2.0)
    calls = []
    real = port_rcd._dw_math

    def counted(*args):
        calls.append(args[2].device.type)
        return real(*args) if args[2].device.type == "cpu" else "plain"

    monkeypatch.setattr(port_rcd, "_dw_math", counted)
    meta = [a.to("meta") for a in (pc_t, mu_g, mf_g, offs)]
    for pot in (trainable, excluded):
        with pytest.raises(ValueError, match="plain=True"):
            port_rcd._dipole_window_energy(pot, *meta, CUTOFF, False)
        assert calls == []
        assert port_rcd._dipole_window_energy(pot, *meta, CUTOFF, True) == "plain"
        assert calls.pop() == "meta"
        e_a = port_rcd._dipole_window_energy(pot, pc_t, mu_g, mf_g, offs, CUTOFF, True)
        e_b = port_rcd._dipole_window_energy(pot, pc_t, mu_g, mf_g, offs, CUTOFF, False)
        assert calls == ["cpu", "cpu"] and float(e_a.detach()) == float(e_b.detach())
        calls.clear()


def test_window_dipole_params_mirror_the_potential():
    from torchpme_tpu_torch import kernels

    _, pot_t, _, arrays_t, _ = _window_inputs(dt="float32", **F64_CASES["sr"])
    grid = tuple(arrays_t[0].shape[i] for i in (0, 1, 2, 4))
    p = kernel_params.window_dipole_params(*port_rcd._dipole_table(pot_t), CUTOFF, grid)
    alpha = 1.0 / (2 * 0.75**2)
    assert (p.nx, p.ny, p.nz, p.cap) == tuple(arrays_t[0].shape[i] for i in (0, 1, 2, 4))
    assert p.direct == 0 and p.self_k == kernels.N_OFFSETS - 1
    assert p.alpha == pytest.approx(alpha, rel=1e-6)
    assert p.sqrt_alpha == pytest.approx(alpha**0.5, rel=1e-6)
    assert p.c_gauss == pytest.approx(2 * (alpha / np.pi) ** 0.5, rel=1e-6)
    assert p.cutoff_sq == pytest.approx(9.0) and p.prefactor == pytest.approx(1.3)
    assert list(p.offsets[-3:]) == [0, 0, 0]
    direct = kernel_params.window_dipole_params(
        *port_rcd._dipole_table(PotentialDipole()), CUTOFF, grid)
    assert direct.direct == 1 and "window_dipole" in kernels.launch_counts()


# -- kernel G's decomposition, mirrored in float64 ----------------------------------


def _home_side_mirror(potential, cutoff, pc_t, mu_g, mf_g, offs, mui_g=None):
    """Test-only mirror of kernel G's index algebra: every home atom gathers
    over all 27 neighbor offsets and keeps only its own (home-side) terms.

    Offset ``o`` is half-window row ``k`` (vector ``offs[k]``, sign +) or its
    negation (sign −).  Partners are each neighbor cell's occupied slots in
    slot order (the kernel's compacted staging).  The home atom takes weight
    ``wi`` of the i-side terms (1 at +k, ½ on the self cell) and ``wj`` of
    the j-side ones (1 at −k, ½ on the self cell; occupied slots only), and
    the energy comes from the i side.  Without ``mui_g`` both sides read
    ``mu``; with it the i side reads ``mui`` against the partner's ``mu``
    (cotangent to ``d_mui``) and the j side ``mu`` against the partner's
    ``mui`` (to ``d_mu``).  Empty slots sit at the centre with zero dipoles.
    ``d_offs[k] = ½(S(−k) − S(+k))`` over the home-side position gradients,
    and the self row is ½(S_j − S_i) of its two roles."""
    nx, ny, nz, _, cap = pc_t.shape
    half = port_rc._window_offsets(cap)
    self_k = half.index((0, 0, 0))
    cut2 = torch.tensor(cutoff, dtype=pc_t.dtype) ** 2
    scalars, cderiv = port_rcd._scalar_hooks(potential)
    split = mui_g is not None
    mui_g = mu_g if mui_g is None else mui_g
    occupied = mf_g > 0.5
    p_home = pc_t.transpose(-1, -2)  # (x, y, z, cap, 3)
    # compacted partner order: occupied slots first, in slot order
    order = torch.argsort((~occupied).to(torch.int8), dim=-1, stable=True)

    def compact(t):  # (x, y, z, cap, c) by the cell's own order
        return torch.gather(t, 3, order[..., None].expand_as(t))

    p_c, mu_c, mui_c, occ_c = (compact(t) for t in (p_home, mu_g, mui_g, occupied[..., None]))
    e = torch.zeros((), dtype=torch.float64)
    d_pc, d_mu, d_mui = (torch.zeros_like(t) for t in (p_home, mu_g, mu_g))
    g_sum = {+1: torch.zeros_like(offs), -1: torch.zeros_like(offs)}
    self_row = torch.zeros(3, dtype=pc_t.dtype)

    def role(r, d_sq_safe, ok, m_home, m_part, w):
        """(energy, w·dE/dp_home, w·dE/dm_home) of one role, summed over the partners."""
        d = torch.sqrt(d_sq_safe)
        b, c = scalars(d)
        cpd = cderiv(d, b, c) / d
        okf = ok.to(pc_t.dtype)
        mm = (m_home[..., :, None, :] * m_part[..., None, :, :]).sum(-1)
        rh = (m_home[..., :, None, :] * r).sum(-1)
        rp = (m_part[..., None, :, :] * r).sum(-1)
        s = -(c * mm) - cpd * rh * rp
        g = (-s[..., None] * r + (c * rp)[..., None] * m_home[..., :, None, :]
             + (c * rh)[..., None] * m_part[..., None, :, :])
        h = b[..., None] * m_part[..., None, :, :] - (c * rp)[..., None] * r
        wf = w[..., None]
        return ((okf * (b * mm - c * rh * rp)).sum(-1),
                (okf[..., None] * g).sum(-2) * wf, (okf[..., None] * h).sum(-2) * wf)

    for o in port_rc._D27:
        neg = tuple(-c for c in o)
        sign = +1 if o in half else -1
        k = half.index(o if sign > 0 else neg)
        is_self = o == (0, 0, 0)
        pj = torch.roll(p_c, neg, dims=(0, 1, 2)) + sign * offs[k]
        mu_p = torch.roll(mu_c, neg, dims=(0, 1, 2))
        mui_p = torch.roll(mui_c, neg, dims=(0, 1, 2))
        occ_p = torch.roll(occ_c, neg, dims=(0, 1, 2))[..., 0]
        r = pj[..., None, :, :] - p_home[..., :, None, :]  # (x, y, z, home, partner, 3)
        d_sq = (r**2).sum(-1)
        ok = (d_sq > 0) & (d_sq < cut2) & occ_p[..., None, :]
        d_sq_safe = torch.where(ok, d_sq, 1.0)
        wi = torch.full(occupied.shape, 0.5 if is_self else float(sign > 0), dtype=pc_t.dtype)
        wj = torch.where(occupied, 0.5 if is_self else float(sign < 0), 0.0).to(pc_t.dtype)
        if not split:
            pair_e, g, h = role(r, d_sq_safe, ok, mu_g, mu_p, wi + wj)
            e = e + (wi * pair_e).sum()
            d_pc, d_mu = d_pc + g, d_mu + h
        else:
            pair_e, g_i, h_i = role(r, d_sq_safe, ok, mui_g, mu_p, wi)
            _, g_j, h_j = role(r, d_sq_safe, ok, mu_g, mui_p, wj)
            e = e + (wi * pair_e).sum()
            g = g_i + g_j
            d_pc, d_mui, d_mu = d_pc + g, d_mui + h_i, d_mu + h_j
            if is_self:
                self_row = self_row + 0.5 * (g_j - g_i).sum(dim=(0, 1, 2, 3))
        if not is_self:
            g_sum[sign][k] += g.sum(dim=(0, 1, 2, 3))
    d_offs = 0.5 * (g_sum[-1] - g_sum[+1])
    d_offs[self_k] = self_row
    grads = (d_pc.transpose(-1, -2), d_mu, d_offs)
    return e, grads + ((d_mui,) if split else ())


def _dense_dipole_grid(split):
    """A triclinic 3×3×3 cell grid whose capacity exceeds one warp, with
    empty slots (float64), and the i-side dipoles of the split case."""
    rng = np.random.default_rng(23)
    cell = np.eye(3) * 9.5 + np.asarray([[0, 0, 0], [0.7, 0, 0], [-0.4, 0.5, 0]])
    pos = rng.uniform(0, 1, (1100, 3)) @ cell
    mu = rng.normal(size=(1100, 3))
    clist = port_rc.compute_cell_list(pos, cell, CUTOFF, spill=False, device="cpu")
    n_cells, cap = clist.slot_mask.shape
    assert clist.n_axis == (3, 3, 3) and cap > 32
    idx = clist.atom_index.long()
    pc_t, mu_g, mf_g, offs, valid = port_rc._prepare_bucketed(
        torch.tensor(mu)[idx], torch.tensor(pos)[idx], torch.tensor(cell), clist
    )
    assert bool(valid) and not bool(mf_g.bool().all())
    mui_g = None
    if split:
        keep = torch.tensor(rng.uniform(size=mu_g.shape[:3]) > 0.3, dtype=mu_g.dtype)
        mui_g = mu_g * keep[..., None, None]
    return [pc_t, mu_g, mf_g, offs, mui_g]


MIRROR_CASES = [(name, split) for name in ("triclinic", "direct", "grid3_cap_gt_32")
                for split in (False, True)]


@pytest.mark.parametrize("name,split", MIRROR_CASES,
                         ids=[f"{n}-{'split' if s else 'mu'}" for n, s in MIRROR_CASES])
def test_kernel_decomposition_matches_plain(name, split):
    """Kernel G's 27-offset home-side gather (roles by offset sign, the
    centre item for empty slots, compacted partners, d_offs from the ± pairs)
    ≡ the plain half window with its j-side roll, float64, ≤ 1e-12 of max."""
    if name == "grid3_cap_gt_32":
        arrays = _dense_dipole_grid(split)
        pot = PotentialDipole(smearing=0.8, prefactor=1.3)
    else:
        case = {**F64_CASES[name], "seed": 11 if split else F64_CASES[name].get("seed", 0)}
        _, pot, _, arrays, _ = _window_inputs(dt="float64", split=split, **case)
    e_m, g_m = _home_side_mirror(pot, CUTOFF, *arrays)
    e_p, g_p = port_rcd._dw_value_and_grad(pot, CUTOFF, *arrays)
    assert len(g_m) == len(g_p) == (4 if split else 3)
    assert abs(float(e_m) - float(e_p)) <= 1e-12 * abs(float(e_p))
    for label, got, ref in zip(GRAD_NAMES, g_m, g_p):
        assert rel(got.numpy(), ref.numpy()) <= 1e-12, label
