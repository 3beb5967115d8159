"""The module of kernel C (``ops/rspace_cells.py``): the port's real-space
window energy from bucket rows ≡ the JAX package's, value and gradients
(rows, charges, cell), with spilled extras, plus the wrapper contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import clustered_box, port_clist, random_box, rel, rows_of

import torchpme_tpu as tpme
from torchpme_tpu.ops import rspace_cells as jax_rc
from torchpme_tpu_torch import CoulombPotential, Potential
from torchpme_tpu_torch.ops import rspace_cells as port_rc

torch.set_num_threads(1)

SMEARING, CUTOFF = 1.0, 3.0


def _systems():
    cpos, cq, ccell = clustered_box(300, 16.0, seed=2)
    tpos, tq, tcell = random_box(260, 14.0, seed=8)
    tcell = tcell + np.asarray([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [0.5, -1.0, 0.0]])
    return {
        "spilled": (cpos, cq, ccell, {}),
        "balanced_pinned": (cpos, cq, ccell, dict(xy_cells=(4, 4), balance=True)),
        "triclinic": (tpos, tq, tcell, {}),
    }


SYSTEMS = _systems()
CASES = [(name, dt) for name in SYSTEMS for dt in ("float64", "float32")]


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{d}" for n, d in CASES])
def case(request):
    name, dt = request.param
    pos, q, cell, kw = SYSTEMS[name]
    clist_j = jax_rc.compute_cell_list(pos, cell, CUTOFF, **kw)
    if name == "spilled":
        assert clist_j.extra_index is not None, "system did not spill"
    rows = rows_of(clist_j, pos).astype(dt)
    q, cell = q.astype(dt), cell.astype(dt)
    pot_j = tpme.CoulombPotential(smearing=SMEARING)

    def e_j(qq, rr, cc):
        return jax_rc.cell_list_rspace_energy_rows(pot_j, qq, rr, cc, clist_j)

    jdt = getattr(jnp, dt)
    ej, gj = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1, 2)))(
        jnp.asarray(q, jdt), jnp.asarray(rows, jdt), jnp.asarray(cell, jdt)
    )
    return dict(
        dt=dt, q=q, rows=rows, cell=cell, clist=port_clist(clist_j),
        e_j=float(ej), g_j=[np.asarray(g) for g in gj],
    )


def _port(case, plain=False):
    args = [torch.tensor(case[k], requires_grad=True) for k in ("q", "rows", "cell")]
    e = port_rc.cell_list_rspace_energy_rows(
        CoulombPotential(smearing=SMEARING), args[0], args[1], args[2], case["clist"],
        plain=plain,
    )
    grads = torch.autograd.grad(e, args)
    return float(e.detach()), [g.numpy() for g in grads]


def test_window_energy_matches_jax(case):
    e, _ = _port(case)
    tol = 1e-11 if case["dt"] == "float64" else 1e-5
    assert abs(e - case["e_j"]) <= tol * abs(case["e_j"])


@pytest.mark.parametrize("arg", ["charges", "pos_rows", "cell"])
def test_window_gradients_match_jax(case, arg):
    _, grads = _port(case)
    i = ["charges", "pos_rows", "cell"].index(arg)
    assert grads[i].dtype == np.dtype(case["dt"])
    if case["dt"] == "float64":
        assert rel(grads[i], case["g_j"][i]) <= 1e-11
    elif arg != "cell":
        assert rel(grads[i], case["g_j"][i]) <= 1e-5
    else:
        # the cell gradient is a virial sum with heavy cancellation: on the
        # spilled system the JAX package's own float32 result sits 1.1e-5
        # of max from float64.  Hold the port to 1e-5 of its float64 result
        # on the same inputs, and the two float32 results to the sum of both
        # packages' float32 error
        f64 = {**case, **{k: case[k].astype(np.float64) for k in ("q", "rows", "cell")}}
        _, grads64 = _port(f64)
        assert rel(grads[i], grads64[i]) <= 1e-5
        assert rel(grads[i], case["g_j"][i]) <= 2e-5


def test_plain_flag_is_the_cpu_path(case):
    e_a, g_a = _port(case)
    e_b, g_b = _port(case, plain=True)
    assert e_a == e_b
    for a, b in zip(g_a, g_b):
        np.testing.assert_array_equal(a, b)


def _window_inputs(case, dtype=None, device="cpu"):
    dtype = dtype or getattr(torch, case["dt"])
    clist = case["clist"]
    n_cells, cap = clist.slot_mask.shape
    pos = torch.tensor(case["rows"][: n_cells * cap]).reshape(n_cells, cap, 3)
    q = torch.tensor(case["q"])[clist.atom_index.long()]
    pc_t, q_g, mf_g, offs, _ = port_rc._prepare_bucketed(q, pos, torch.tensor(case["cell"]), clist)
    return [t.to(device=device, dtype=dtype) for t in (pc_t, q_g, mf_g, offs)]


def test_wrapper_takes_plain_twin_on_cpu(case):
    pot = CoulombPotential(smearing=SMEARING)
    ins = _window_inputs(case)
    e_a, g_a = port_rc.window_value_and_grad(pot, CUTOFF, *ins)
    e_b, g_b = port_rc._we_value_and_grad(pot, CUTOFF, *ins)
    assert float(e_a) == float(e_b)
    for a, b in zip(g_a, g_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_raises_off_cpu(case):
    pot = CoulombPotential(smearing=SMEARING)
    with pytest.raises(TypeError, match="float32"):
        port_rc.window_value_and_grad(pot, CUTOFF, *_window_inputs(case, torch.float64, "meta"))
    ins32 = _window_inputs(case, torch.float32, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        port_rc.window_value_and_grad(pot, CUTOFF, *ins32)
    with pytest.raises(TypeError, match="Coulomb"):
        port_rc.window_value_and_grad(Potential(smearing=SMEARING), CUTOFF, *ins32)


def _offset_loop(pot, pc_t, q_g, mf_g, offs):
    """The plain window offset by offset, each neighbour cell by a roll: the
    reference of ``_we_value_and_grad``, which takes the 14 offsets on one
    axis.  Returns ``(e, (d_pc, d_q, d_offs, d_image), member energies)``."""
    dtype, cap = pc_t.dtype, pc_t.shape[-1]
    f64 = torch.float64
    cutoff_sq = torch.tensor(CUTOFF, dtype=dtype) ** 2
    eye = torch.eye(cap, dtype=torch.bool)
    terms = port_rc._window_terms(pot)
    e, member_e = torch.zeros((), dtype=f64), torch.zeros(len(terms), dtype=f64)
    d_pc, d_q, d_offs = torch.zeros_like(pc_t), torch.zeros_like(q_g), torch.zeros_like(offs)
    d_image = torch.zeros((3, 3), dtype=f64)
    for k, off in enumerate(port_rc._window_offsets(cap)):
        w = 0.5 if off == (0, 0, 0) else 1.0
        shift = tuple(-o for o in off)
        pj = torch.roll(pc_t, shift, dims=(0, 1, 2)) + offs[k][:, None]
        mj = torch.roll(mf_g, shift, dims=(0, 1, 2))
        d_sq = sum((pc_t[..., c, :, None] - pj[..., c, None, :]) ** 2 for c in range(3))
        ok = (d_sq > 0.0) & (d_sq < cutoff_sq) & (mj[..., None, :] > 0.5)
        if off == (0, 0, 0):
            ok = ok & ~eye
        qj = torch.roll(q_g, shift, dims=(0, 1, 2)) * w
        d_sq_safe, okf = torch.where(ok, d_sq, 1.0), ok.to(dtype)
        vq = okf * torch.einsum("...ic,...jc->...ij", q_g, qj)
        if dtype == torch.float32:
            v_raw, w_raw, members = port_rc._window_math(pot, d_sq_safe)
            s = vq * w_raw
        else:
            d = torch.sqrt(d_sq_safe)
            v_raw, dd, members = port_rc._table_pair_terms(pot, terms, d, vq)
            s = dd / d
        e = e + torch.sum(vq * v_raw, dtype=f64)
        if members is not None:
            member_e = member_e + torch.stack([torch.sum(vq * m, dtype=f64) for m in members])
        v = okf * v_raw
        g_i = pc_t * s.sum(-1)[..., None, :] - torch.einsum("...ij,...dj->...di", s, pj)
        d_pj = pj * s.sum(-2)[..., None, :] - torch.einsum("...ij,...di->...dj", s, pc_t)
        d_pc = d_pc + g_i + torch.roll(d_pj, off, dims=(0, 1, 2))
        d_qj = torch.einsum("...ij,...ic->...jc", v, q_g)
        d_q = d_q + torch.matmul(v, qj) + torch.roll(d_qj, off, dims=(0, 1, 2)) * w
        d_offs[k] = d_pj.sum(dim=(0, 1, 2, 4))
        g_cells = g_i.sum(-1, dtype=f64)
        for a, o in enumerate(off):
            if o:
                n = g_cells.shape[a]
                m = torch.div(torch.arange(n) + o, n, rounding_mode="floor").to(f64)
                d_image[a] -= m @ g_cells.sum(dim=tuple(b for b in range(3) if b != a))
    return e.to(dtype), (d_pc, d_q, d_offs, d_image), member_e


@pytest.mark.parametrize("passes", ["stacked", "one_offset_a_pass"])
@pytest.mark.parametrize("pot_name", ["coulomb", "combined_direct"])
def test_plain_window_equals_the_offset_loop(case, pot_name, passes, monkeypatch):
    """The plain window with its offsets on one axis (in one pass here, or
    with a pair budget that forces one offset a pass) ≡ the loop over them,
    energy, the four gradients and the terms' energies (dE/dw), within the
    reordered sums' rounding: 1e-12 in float64, 1e-5 in float32."""
    import torchpme_tpu_torch as tpt

    if passes == "one_offset_a_pass":
        monkeypatch.setattr(port_rc, "_PAIR_BUDGET", 1)
    n_cells, cap = case["clist"].slot_mask.shape
    assert len(port_rc._offset_chunks(n_cells, cap)) == (1 if passes == "stacked" else 14)

    pot = {
        "coulomb": CoulombPotential(smearing=SMEARING),
        "combined_direct": tpt.CombinedPotential(
            [CoulombPotential(), tpt.InversePowerLawPotential(exponent=6)],
            initial_weights=torch.tensor([1.0, -0.5], dtype=torch.float64)),
    }[pot_name]
    ins = _window_inputs(case)
    tol = 1e-12 if case["dt"] == "float64" else 1e-5
    e, grads, member_e, _ = port_rc._we_plain(pot, CUTOFF, *ins, ())
    with torch.no_grad():
        e_ref, grads_ref, member_ref = _offset_loop(pot, *ins)
    assert abs(float(e) - float(e_ref)) <= tol * abs(float(e_ref))
    for got, ref in zip(grads, grads_ref):
        assert rel(got.numpy(), ref.numpy()) <= tol
    if pot_name == "combined_direct":
        assert rel(member_e.numpy(), member_ref.numpy()) <= tol


def test_half_window_offsets():
    assert port_rc._half_window_chunks(24) == jax_rc._half_window_chunks(24)
    flat = port_rc._window_offsets(24)
    assert len(flat) == 14 and flat[-1] == (0, 0, 0)
    assert len(set(flat)) == 14 and all((-o[0], -o[1], -o[2]) not in flat[:-1] for o in flat[:-1])


# -- kernel C's decomposition, mirrored in float64 --------------------------------


def _i_side_mirror(potential, cutoff, pc_t, q_g, mf_g, offs):
    """Test-only mirror of kernel C's index algebra: every home slot gathers
    over all 27 neighbor offsets and keeps only its own (i-side) terms.

    Offset ``o`` is half-window row ``k`` (vector ``offs[k]``) or its
    negation (``-offs[k]``).  An occupied slot takes every pair at ½ energy
    and full gradient weight; an empty slot (charge 0) keeps the plain
    version's ``d_q``: the half window only, the self cell at ½.
    ``d_offs[k] = ½(Σ_{−k} g − Σ_{+k} g)`` over the i-side gradients ``g``,
    and the self row is 0."""
    nx, ny, nz, _, cap = pc_t.shape
    half = port_rc._window_offsets(cap)
    self_k = half.index((0, 0, 0))
    cut2 = torch.tensor(cutoff, dtype=pc_t.dtype) ** 2
    eye = torch.eye(cap, dtype=torch.bool)
    occupied = mf_g > 0.5
    e = torch.zeros((), dtype=torch.float64)
    d_pc, d_q = torch.zeros_like(pc_t), torch.zeros_like(q_g)
    g_sum = {+1: torch.zeros_like(offs), -1: torch.zeros_like(offs)}
    for o in port_rc._D27:
        neg = tuple(-c for c in o)
        sign = +1 if o in half else -1
        k = half.index(o if sign > 0 else neg)
        is_self = o == (0, 0, 0)
        pj = torch.roll(pc_t, neg, dims=(0, 1, 2)) + sign * offs[k][:, None]
        qj = torch.roll(q_g, neg, dims=(0, 1, 2))
        mj = torch.roll(mf_g, neg, dims=(0, 1, 2))
        diff = pc_t[..., :, :, None] - pj[..., :, None, :]  # (x, y, z, 3, i, j)
        d_sq = (diff**2).sum(-3)
        ok = (d_sq > 0) & (d_sq < cut2) & (mj[..., None, :] > 0.5)
        if is_self:
            ok = ok & ~eye
        d = torch.sqrt(torch.where(ok, d_sq, 1.0))
        okf = ok.to(pc_t.dtype)
        vq = okf * torch.einsum("...ic,...jc->...ij", q_g, qj)
        v_raw = potential.sr_from_dist(d)
        pair_e = vq * v_raw
        e = e + 0.5 * pair_e.sum()
        s = potential.sr_pair_force(d, vq, pair_e) / d
        g = (s[..., None, :, :] * diff).sum(-1)  # (x, y, z, 3, i)
        w_empty = 0.0 if sign < 0 else (0.5 if is_self else 1.0)
        w_i = torch.where(occupied, 1.0, w_empty).to(pc_t.dtype)
        d_pc = d_pc + g
        d_q = d_q + w_i[..., None] * torch.matmul(okf * v_raw, qj)
        if not is_self:
            g_sum[sign][k] += g.sum(dim=(0, 1, 2, 4))
    d_offs = 0.5 * (g_sum[-1] - g_sum[+1])
    d_offs[self_k] = 0.0
    return e, (d_pc, d_q, d_offs)


def _dense_grid_inputs(n_ch=1):
    """A 3×3×3 cell grid whose capacity exceeds one warp (float64), with
    ``n_ch`` charge channels."""
    rng = np.random.default_rng(21)
    cell = np.eye(3) * 9.5 + np.asarray([[0, 0, 0], [0.7, 0, 0], [-0.4, 0.5, 0]])
    pos = rng.uniform(0, 1, (1150, 3)) @ cell
    q = rng.normal(size=(1150, n_ch))
    clist = port_rc.compute_cell_list(pos, cell, CUTOFF, spill=False, device="cpu")
    n_cells, cap = clist.slot_mask.shape
    assert clist.n_axis == (3, 3, 3) and cap > 32
    idx = clist.atom_index.long()
    pc_t, q_g, mf_g, offs, valid = port_rc._prepare_bucketed(
        torch.tensor(q)[idx], torch.tensor(pos)[idx], torch.tensor(cell), clist
    )
    assert bool(valid) and not bool(mf_g.bool().all())  # empty slots are covered
    return pc_t, q_g, mf_g, offs


@pytest.mark.parametrize(
    "name", ["spilled", "balanced_pinned", "triclinic", "grid3_cap_gt_32", "grid3_cap_gt_32_ch4"]
)
def test_kernel_decomposition_matches_plain(name):
    """Kernel C's 27-offset i-side gather, d_offs from the ± pairs, ≡ the
    plain half window with its j-side roll (float64, ≤ 1e-12), also at the
    kernel's largest channel count."""
    if name.startswith("grid3"):
        ins = _dense_grid_inputs(4 if name.endswith("ch4") else 1)
    else:
        pos, q, cell, kw = SYSTEMS[name]
        clist = port_clist(jax_rc.compute_cell_list(pos, cell, CUTOFF, **kw))
        ins = _window_inputs(dict(dt="float64", clist=clist, q=q, cell=cell,
                                  rows=rows_of(jax_rc.compute_cell_list(pos, cell, CUTOFF, **kw),
                                               pos)))
    pot = CoulombPotential(smearing=SMEARING)
    e_m, g_m = _i_side_mirror(pot, CUTOFF, *ins)
    e_p, g_p = port_rc._we_value_and_grad(pot, CUTOFF, *ins)
    assert abs(float(e_m) - float(e_p)) <= 1e-12 * abs(float(e_p))
    for got, ref in zip(g_m, g_p):
        assert rel(got.numpy(), ref.numpy()) <= 1e-12
