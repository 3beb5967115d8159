"""Padded batches of systems through ``torch.func.vmap`` ≡ the JAX package's
``jax.vmap`` (tests/calculators/test_padding.py, test_padding_mesh.py,
examples/12_batched_systems.py) ≡ the port's own loop over the systems,
float64 on the CPU.

Covered: direct and Ewald (batched k-vectors); PME and P3M on the scatter and
the tiled mesh (the plain versions of kernels D, E, F), with one shared cell
and with a cell per system under one ``ns_mesh``; ``PMECalculatorDipole``;
the position, charge (dipole) and cell gradients by ``vmap(grad)`` and by
``backward()`` through the batched output; a system whose padding overflows
the static tile capacity (NaN in that system only, as in JAX); a batched
bucketing passed back in; each mesh kernel's custom op under ``vmap`` against
a loop of the op, and ``torch.library.opcheck``; the static-size errors and
the paths that refuse a batch.  Bars: 1e-12 (of the largest value) against
the port's loop, 1e-10 against JAX; padded rows exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops import compute_batched_kvectors as j_batched_kvectors
from torchpme_tpu.utils.neighbors import compute_distances as j_distances
from torchpme_tpu_torch.ops import compute_batched_kvectors, get_ns_ewald, get_ns_mesh
from torchpme_tpu_torch.ops import mesh_kernels as mk
from torchpme_tpu_torch.ops import mesh_tiled as mt
from torchpme_tpu_torch.ops.math import inv3
from torchpme_tpu_torch.utils.neighbors import compute_distances, neighbor_list

torch.set_num_threads(1)

LR_WAVELENGTH = 0.5
LOOP_TOL = 1e-12
JAX_TOL = 1e-10
SPACING, DIPOLE_SPACING = 0.4, 0.5  # a 32^3 mesh for every batch here


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _stack(arrays, width, fill=0):
    """Right-pad each array's first axis to ``width`` and stack."""
    out = []
    for a in arrays:
        widths = [(0, width - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, widths, constant_values=fill))
    return np.stack(out)


def _pad_pairs(systems, n_pad_atoms, vector_pairs=False):
    """Stack the pair lists; a padded pair is (0, 1) with shift 0 (a nonzero
    distance, masked), or for the dipoles' unmasked pair lists a pair of one
    padding atom with itself one cell away (zero dipoles: no contribution)."""
    width = max(s["idx"].shape[0] for s in systems)
    idx, shifts, mask = [], [], []
    for s in systems:
        p = s["idx"].shape[0]
        if vector_pairs:
            pad_idx, pad_shift = [n_pad_atoms - 1] * 2, [1, 0, 0]
        else:
            pad_idx, pad_shift = [0, 1], [0, 0, 0]
        idx.append(np.concatenate([s["idx"], np.tile(pad_idx, (width - p, 1))]))
        shifts.append(np.concatenate([s["shifts"], np.tile(pad_shift, (width - p, 1))]))
        mask.append(np.arange(width) < p)
    return np.stack(idx), np.stack(shifts).astype(np.float64), np.stack(mask)


def _system(rng, n, box, cutoff, charges="alternating"):
    positions = rng.uniform(0.3, box - 0.3, (n, 3))
    q = np.tile([1.0, -1.0], n // 2 + 1)[:n].reshape(-1, 1)
    if charges == "dipoles":
        q = rng.normal(size=(n, 3))
    cell = np.eye(3) * box
    idx, dist, shifts = neighbor_list(positions, cell, cutoff=cutoff)
    return dict(positions=positions, q=q, cell=cell, idx=np.asarray(idx),
                dist=np.asarray(dist), shifts=np.asarray(shifts))


def make_batch(sizes, boxes, cutoff, seed, charges="alternating", extra_atoms=0,
               vector_pairs=False):
    """Systems of ``sizes`` atoms in cubic ``boxes``, padded to the largest
    (plus ``extra_atoms``) with zero-charge atoms uniform in each cell."""
    rng = np.random.default_rng(seed)
    systems = [_system(rng, n, box, cutoff, charges) for n, box in zip(sizes, boxes)]
    n_pad = max(sizes) + extra_atoms
    positions = []
    for s in systems:
        fill = rng.uniform(0.0, s["cell"][0, 0], (n_pad - s["positions"].shape[0], 3))
        positions.append(np.concatenate([s["positions"], fill]))
    idx, shifts, pair_mask = _pad_pairs(systems, n_pad, vector_pairs)
    batch = dict(
        q=_stack([s["q"] for s in systems], n_pad), cell=np.stack([s["cell"] for s in systems]),
        positions=np.stack(positions), idx=idx, shifts=shifts, pair_mask=pair_mask,
        node_mask=np.stack([np.arange(n_pad) < n for n in sizes]),
    )
    return systems, batch


def _distances(batch):
    """Padded distances (1 on padded pairs, as the JAX test pads them)."""
    out = []
    for b in range(batch["idx"].shape[0]):
        d = compute_distances(_t(batch["positions"][b]), _t(batch["idx"][b]),
                              _t(batch["cell"][b]), _t(batch["shifts"][b])).numpy()
        out.append(np.where(batch["pair_mask"][b], d, 1.0))
    return np.stack(out)


# -- (a) direct and Ewald: tests/calculators/test_padding.py ------------------


@pytest.mark.parametrize("kind", ["direct", "ewald"])
def test_direct_and_ewald_batch_equals_loop_and_jax(kind):
    sizes, boxes = (4, 6, 8), (4.0, 5.0, 6.0)
    systems, batch = make_batch(sizes, boxes, 1.9, seed=77)
    dist = _distances(batch)
    if kind == "direct":
        calc, calc_j = tpt.Calculator(tpt.CoulombPotential()), tpme.Calculator(tpme.CoulombPotential())
        kv = kv_j = None
    else:
        calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=LR_WAVELENGTH)
        calc_j = tpme.EwaldCalculator(tpme.CoulombPotential(smearing=1.0),
                                      lr_wavelength=LR_WAVELENGTH)
        kv = compute_batched_kvectors(LR_WAVELENGTH, _t(batch["cell"]))
        kv_j = j_batched_kvectors(LR_WAVELENGTH, jnp.asarray(batch["cell"]))
    names = ("q", "cell", "positions", "idx")
    args = [_t(batch[k]) for k in names] + [_t(dist), _t(batch["node_mask"]),
                                           _t(batch["pair_mask"]), kv]
    in_dims = (0,) * 7 + (None if kv is None else 0,)

    def single(c):
        return lambda q, cell, p, i, d, nm, pm, k: c(q, cell, p, i, d, node_mask=nm,
                                                       pair_mask=pm, kvectors=k)

    got = torch.func.vmap(single(calc), in_dims=in_dims)(*args).numpy()
    args_j = [jnp.asarray(batch[k]) for k in names] + [jnp.asarray(dist), jnp.asarray(
        batch["node_mask"]), jnp.asarray(batch["pair_mask"]), kv_j]
    ref_j = np.asarray(jax.jit(jax.vmap(single(calc_j), in_axes=in_dims))(*args_j))
    assert rel(got, ref_j) <= JAX_TOL
    for b, (s, n) in enumerate(zip(systems, sizes)):
        extra = {} if kind == "direct" else {"kvectors": calc.compute_kvectors(_t(s["cell"]))}
        ref = calc(_t(s["q"]), _t(s["cell"]), _t(s["positions"]), _t(s["idx"]),
                   _t(s["dist"]), **extra).numpy()
        assert rel(got[b, :n], ref) <= LOOP_TOL
        assert np.all(got[b, n:] == 0.0)


# -- (b) PME and P3M: tests/calculators/test_padding_mesh.py --------------------


MESH_CLASSES = {"PME": (tpt.PMECalculator, tpme.PMECalculator),
                "P3M": (tpt.P3MCalculator, tpme.P3MCalculator)}


def _mesh_calcs(name, backend, smearing=0.6, spacing=SPACING):
    cls, cls_j = MESH_CLASSES[name]
    return (cls(tpt.CoulombPotential(smearing=smearing), mesh_spacing=spacing,
                mesh_backend=backend),
            cls_j(tpme.CoulombPotential(smearing=smearing), mesh_spacing=spacing,
                  mesh_backend=backend))


def _mesh_call(c, ns):
    return lambda q, cell, p, i, d, nm, pm: c(q, cell, p, i, d, node_mask=nm, pair_mask=pm,
                                               ns_mesh=ns)


@pytest.mark.parametrize("cells", ["shared", "per_system"])
@pytest.mark.parametrize("backend", ["scatter", "tiled"])
@pytest.mark.parametrize("name", ["PME", "P3M"])
def test_mesh_batch_equals_loop_and_jax(name, backend, cells):
    boxes = (5.0, 5.0, 5.0) if cells == "shared" else (5.0, 5.25, 5.5)
    sizes = (10, 12, 14)
    systems, batch = make_batch(sizes, boxes, 2.0, seed=11)
    dist = _distances(batch)
    calc, calc_j = _mesh_calcs(name, backend)
    ns = get_ns_mesh(batch["cell"][-1], SPACING)  # the largest cell's
    assert ns == (32, 32, 32)
    names = ("q", "cell", "positions", "idx")
    masks = ("node_mask", "pair_mask")
    got = torch.func.vmap(_mesh_call(calc, ns))(
        *[_t(batch[k]) for k in names], _t(dist), *[_t(batch[k]) for k in masks]).numpy()
    ref_j = np.asarray(jax.jit(jax.vmap(_mesh_call(calc_j, ns)))(
        *[jnp.asarray(batch[k]) for k in names], jnp.asarray(dist),
        *[jnp.asarray(batch[k]) for k in masks]))
    assert rel(got, ref_j) <= JAX_TOL
    for b, (s, n) in enumerate(zip(systems, sizes)):
        ref = calc(_t(s["q"]), _t(s["cell"]), _t(s["positions"]), _t(s["idx"]), _t(s["dist"]),
                   ns_mesh=ns).numpy()
        assert rel(got[b, :n], ref) <= LOOP_TOL
        assert np.all(got[b, n:] == 0.0)


# -- (c) point dipoles ----------------------------------------------------------


def _dipole_batch():
    sizes, boxes = (30, 36, 40), (6.0, 6.3, 6.6)
    systems, batch = make_batch(sizes, boxes, 2.5, seed=5, charges="dipoles", extra_atoms=1,
                                vector_pairs=True)
    return sizes, systems, batch, get_ns_mesh(batch["cell"][-1], DIPOLE_SPACING)


def _dipole_calcs(backend):
    return (tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=0.9), mesh_spacing=DIPOLE_SPACING,
                                    mesh_backend=backend),
            tpme.PMECalculatorDipole(tpme.PotentialDipole(smearing=0.9), mesh_spacing=DIPOLE_SPACING,
                                     mesh_backend=backend))


def _dipole_energy(c, ns, xp):
    """Energy of one padded system of dipoles (vectors from positions)."""
    def energy(mu, cell, p, i, s):
        vec = p[i[:, 1]] - p[i[:, 0]] + s @ cell
        return xp.sum(c(mu, cell, p, i, vec, ns_kvectors=ns) * mu)

    return energy


@pytest.mark.parametrize("backend", ["scatter", "tiled"])
def test_dipole_batch_equals_loop_and_jax(backend):
    sizes, systems, batch, ns = _dipole_batch()
    calc, calc_j = _dipole_calcs(backend)

    def call(c, xp):
        def per_atom(mu, cell, p, i, s):
            return c(mu, cell, p, i, p[i[:, 1]] - p[i[:, 0]] + s @ cell, ns_kvectors=ns)
        return per_atom

    names = ("q", "cell", "positions", "idx", "shifts")
    got = torch.func.vmap(call(calc, torch))(*[_t(batch[k]) for k in names]).numpy()
    ref_j = np.asarray(jax.jit(jax.vmap(call(calc_j, jnp)))(
        *[jnp.asarray(batch[k]) for k in names]))
    assert rel(got, ref_j) <= JAX_TOL
    for b, (s, n) in enumerate(zip(systems, sizes)):
        p, cell = _t(s["positions"]), _t(s["cell"])
        i = _t(s["idx"])
        vec = p[i[:, 1]] - p[i[:, 0]] + _t(s["shifts"]).double() @ cell
        ref = calc(_t(s["q"]), cell, p, i, vec, ns_kvectors=ns).numpy()
        assert rel(got[b, :n], ref) <= LOOP_TOL


# -- (d) gradients --------------------------------------------------------------


def _charge_energy(c, ns, xp, distances):
    def energy(q, cell, p, i, s, nm, pm):
        d = distances(p, i, cell, s)
        d = xp.where(pm, d, 1.0)
        return xp.sum(c(q, cell, p, i, d, node_mask=nm, pair_mask=pm, ns_mesh=ns) * q)

    return energy


@pytest.mark.parametrize("name", ["PME", "P3M", "dipole"])
def test_gradients_by_vmap_grad_and_backward_equal_loop_and_jax(name):
    """∂E/∂(q or μ, cell, positions) of each system: ``vmap(grad)``,
    ``backward()`` through the batched energies, the loop of ``grad`` over
    the unpadded systems and JAX's ``vmap(grad)`` agree."""
    if name == "dipole":
        sizes, systems, batch, ns = _dipole_batch()
        calc, calc_j = _dipole_calcs("tiled")
        energy, energy_j = _dipole_energy(calc, ns, torch), _dipole_energy(calc_j, ns, jnp)
        names = ("q", "cell", "positions", "idx", "shifts")
    else:
        sizes = (10, 12, 14)
        systems, batch = make_batch(sizes, (5.0, 5.25, 5.5), 2.0, seed=11)
        ns = get_ns_mesh(batch["cell"][-1], SPACING)
        calc, calc_j = _mesh_calcs(name, "tiled")
        energy = _charge_energy(calc, ns, torch, compute_distances)
        energy_j = _charge_energy(calc_j, ns, jnp, j_distances)
        names = ("q", "cell", "positions", "idx", "shifts", "node_mask", "pair_mask")
    args = [_t(batch[k]) for k in names]
    grads = torch.func.vmap(torch.func.grad(energy, argnums=(0, 1, 2)))(*args)
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    torch.func.vmap(energy)(*leaves, *args[3:]).sum().backward()
    grads_j = jax.jit(jax.vmap(jax.grad(energy_j, argnums=(0, 1, 2))))(
        *[jnp.asarray(batch[k]) for k in names])
    for g, leaf, g_j in zip(grads, leaves, grads_j):
        assert rel(g.numpy(), np.asarray(g_j)) <= JAX_TOL
        assert rel(leaf.grad.numpy(), g.numpy()) <= LOOP_TOL
    for b, (s, n) in enumerate(zip(systems, sizes)):
        one = [_t(s[k]) for k in ("q", "cell", "positions", "idx")]
        one.append(_t(s["shifts"]).double())
        if name != "dipole":
            one += [torch.ones(n, dtype=torch.bool),
                    torch.ones(s["idx"].shape[0], dtype=torch.bool)]
        loop = torch.func.grad(energy, argnums=(0, 1, 2))(*one)
        for g, ref in zip(grads, loop):
            assert rel(g[b, : ref.shape[0]].numpy(), ref.numpy()) <= LOOP_TOL


# -- (e) a system that overflows the static tile capacity -------------------------


def test_overflowing_system_is_nan_in_that_system_only():
    """Under vmap the tile capacity is JAX's static ``min(N, 2⌈N/T⌉ + 32)``
    rounded up to 64: 64 slots for 100 atoms on 16 tiles.  The second system
    is padded at the origin (70 atoms in tile 0): its potentials are NaN, as
    JAX's are; the first system's are JAX's."""
    rng = np.random.default_rng(3)
    box, n = 5.0, 100
    real = (n, 30)
    positions = rng.uniform(0.3, box - 0.3, (2, n, 3))
    positions[1, real[1]:] = 0.0
    q = np.stack([np.tile([1.0, -1.0], n // 2).reshape(-1, 1)] * 2)
    q[1, real[1]:] = 0.0
    node_mask = np.stack([np.arange(n) < r for r in real])
    cell = np.eye(3) * box
    pairs = [neighbor_list(positions[b, : real[b]], cell, cutoff=1.0) for b in range(2)]
    width = max(p[0].shape[0] for p in pairs)
    idx = _stack([np.asarray(p[0]) for p in pairs], width)
    dist = _stack([np.asarray(p[1]) for p in pairs], width, fill=1.0)
    pair_mask = np.stack([np.arange(width) < p[0].shape[0] for p in pairs])
    calc, calc_j = _mesh_calcs("PME", "tiled")
    ns = get_ns_mesh(cell, SPACING)
    inputs = (q, np.stack([cell] * 2), positions, idx, dist, node_mask, pair_mask)
    got = torch.func.vmap(_mesh_call(calc, ns))(*map(_t, inputs)).numpy()
    ref_j = np.asarray(jax.jit(jax.vmap(_mesh_call(calc_j, ns)))(*map(jnp.asarray, inputs)))
    # JAX's jitted mask turns the padded rows' NaN into 0 (XLA folds the
    # product with the mask into a select); the real rows are NaN in both
    assert np.all(np.isnan(got[1])) and np.all(np.isnan(ref_j[1, : real[1]]))
    assert np.all(np.isfinite(got[0])) and rel(got[0], ref_j[0]) <= JAX_TOL
    # outside vmap the same system at the same capacity raises, as before
    capped = tpt.PMECalculator(tpt.CoulombPotential(smearing=0.6), mesh_spacing=SPACING,
                               mesh_backend="tiled", tile_capacity=64)
    with pytest.raises(ValueError, match="exceeded the tile capacity"):
        capped(*(_t(a[1]) for a in inputs[:5]), ns_mesh=ns)


# -- (f) a batched bucketing built once and passed back in ----------------------


def test_batched_bucketing_passed_back_equals_fresh_call():
    sizes = (10, 12, 14)
    _, batch = make_batch(sizes, (5.0, 5.25, 5.5), 2.0, seed=11)
    ns = get_ns_mesh(batch["cell"][-1], SPACING)
    calc, _ = _mesh_calcs("P3M", "tiled")
    energy = _charge_energy(calc, ns, torch, compute_distances)
    args = [_t(batch[k]) for k in ("q", "cell", "positions", "idx", "shifts", "node_mask",
                                     "pair_mask")]
    interp = torch.func.vmap(lambda p, c: mt.compute_tiled_interpolation(
        p, inv3(c), ns, calc.interpolation_nodes, "P3M"))(args[2], args[1])
    assert isinstance(interp, mt.TiledInterpolation) and interp.local_x.shape[0] == 3
    assert interp.ns == ns and interp.dropped.tolist() == [0, 0, 0]

    def reused(q, cell, p, i, s, nm, pm, it):
        d = torch.where(pm, compute_distances(p, i, cell, s), 1.0)
        return torch.sum(calc(q, cell, p, i, d, node_mask=nm, pair_mask=pm,
                              tiled_interp=it) * q)

    grad = torch.func.grad(energy, argnums=(0, 1, 2))
    grad_reused = torch.func.grad(reused, argnums=(0, 1, 2))
    fresh = torch.func.vmap(grad)(*args)
    again = torch.func.vmap(grad_reused)(*args, interp)
    for a, b in zip(again, fresh):
        assert rel(a.numpy(), b.numpy()) <= LOOP_TOL


# -- (g) the kernels' custom ops under vmap, and opcheck ------------------------


OPS = ("mesh_spread", "mesh_spread_dipole", "mesh_gather", "mesh_wgrad", "mesh_gather_wgrad",
       "mesh_gather_dipole", "mesh_wgrad_dipole", "mesh_gather_wgrad_dipole")
NS, NODES = (16, 16, 8), 4


def _op_inputs(seed, n_sys=3):
    """Per op, its tensor operands for ``n_sys`` systems stacked on axis 0
    (the bucketing of random atoms with weight derivatives, random slot
    values and meshes); the static arguments follow."""
    rng = np.random.default_rng(seed)
    inv = torch.tensor(np.linalg.inv(np.diag([6.0, 6.0, 3.0])))
    its = [mt.compute_tiled_interpolation(torch.tensor(rng.uniform(0, 6, (40, 3))), inv, NS,
                                          NODES, "Lagrange", capacity=64, derivatives=True)
           for _ in range(n_sys)]
    arrays = [torch.stack([getattr(it, n) for it in its])
              for n in ("local_x", "local_y", "start_z", "weights", "dweights")]
    t, k = arrays[0].shape[1:]
    q2 = torch.tensor(rng.normal(size=(n_sys, t, 2, k)))
    nu = torch.tensor(rng.normal(size=(n_sys, t, 3, k)))
    mesh2 = torch.tensor(rng.normal(size=(n_sys, 2, *NS)))
    mesh1 = torch.tensor(rng.normal(size=(n_sys, 1, *NS)))
    charge, dipole = arrays[:4], arrays
    return {
        "mesh_spread": (*charge, q2),
        "mesh_spread_dipole": (*dipole, nu),
        "mesh_gather": (*charge, mesh2),
        "mesh_wgrad": (*charge, q2, mesh2),
        "mesh_gather_wgrad": (*charge, q2, mesh2),
        "mesh_gather_dipole": (*dipole, mesh1),
        "mesh_wgrad_dipole": (*dipole, nu, mesh1),
        "mesh_gather_wgrad_dipole": (*dipole, nu, mesh1),
    }


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", OPS)
def test_custom_op_vmap_is_one_batched_call_equal_to_a_loop(name, monkeypatch):
    """``vmap`` of each op makes one call of its implementation with the
    batch axis in front (here the plain versions), equal to a loop of the op
    over the systems; the last operand shared by the batch (``in_dims``
    None) is expanded to it."""
    op = getattr(mk, name)
    tensors = _op_inputs(seed=2)[name]
    for shared in (False, True):
        calls = []
        plains = [n for n in dir(mk) if n.endswith("_plain")]
        for plain in plains:
            fn = getattr(mk, plain)
            monkeypatch.setattr(mk, plain, lambda *a, _fn=fn, _n=plain: (
                calls.append((_n, tuple(a[0].shape))), _fn(*a))[1])
        last = tensors[-1][0] if shared else tensors[-1]
        in_dims = (0,) * (len(tensors) - 1) + (None if shared else 0,)
        got = _as_tuple(torch.func.vmap(lambda *a: op(*a, NS, NODES), in_dims=in_dims)(
            *tensors[:-1], last))
        assert [shape for _, shape in calls[:1]] == [tuple(tensors[0].shape)]
        assert all(shape[0] == 3 for _, shape in calls)
        monkeypatch.undo()
        for b in range(3):
            one = [x[b] for x in tensors[:-1]] + [last if shared else last[b]]
            for g, r in zip(got, _as_tuple(op(*one, NS, NODES))):
                assert rel(g[b].numpy(), r.numpy()) <= 1e-13


@pytest.mark.parametrize("name", OPS)
def test_custom_ops_pass_opcheck(name):
    """``torch.library.opcheck`` (schema, fake tensor, autograd registration,
    AOT dispatch) on one system and on a batch; the differentiable ops with
    inputs that require grad."""
    op = getattr(mk, name)
    tensors = _op_inputs(seed=4, n_sys=2)[name]
    diff = name in ("mesh_spread", "mesh_spread_dipole", "mesh_gather", "mesh_gather_dipole")
    for batch in (False, True):
        args = [x if batch else x[0] for x in tensors]
        if diff:
            args = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
        torch.library.opcheck(op, (*args, NS, NODES))


@pytest.mark.parametrize("name", ["mesh_spread", "mesh_gather", "mesh_spread_dipole",
                                  "mesh_gather_dipole"])
def test_registered_autograd_of_an_op_equals_its_entry_point(name):
    """The op's ``register_autograd`` (a direct call) and the entry point's
    autograd.Function (which ``torch.func.grad`` can differentiate) run one
    VJP: equal cotangents."""
    tensors = list(_op_inputs(seed=6, n_sys=1)[name])
    tensors = [x[0] for x in tensors]
    dipole = "dipole" in name
    interp = mt.TiledInterpolation(
        local_x=tensors[0], local_y=tensors[1], start_z=tensors[2], weights=tensors[3],
        slot_of_atom=torch.zeros(1, dtype=torch.int32), dropped=torch.zeros((), dtype=torch.int32),
        dweights=tensors[4] if dipole else None, ns=NS, nodes=NODES,
    )
    entry = {"mesh_spread": mk.spread_tiles, "mesh_gather": mk.gather_tiles,
             "mesh_spread_dipole": mk.spread_dipoles,
             "mesh_gather_dipole": mk.gather_dipole_fields}[name]
    diff_at = (3, 4, 5) if dipole else (3, 4)

    def run(direct):
        leaves = [x.clone().requires_grad_(i in diff_at) for i, x in enumerate(tensors)]
        if direct:
            out = getattr(mk, name)(*leaves, NS, NODES)
        else:
            it = mt.TiledInterpolation(**{**interp.__dict__, "weights": leaves[3],
                                          "dweights": leaves[4] if dipole else None})
            out = entry(it, leaves[-1])
        ct = torch.linspace(-1, 1, out.numel(), dtype=out.dtype).reshape(out.shape)
        return torch.autograd.grad((out * ct).sum(), [leaves[i] for i in diff_at])

    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- static sizes and the paths without a vmap rule -----------------------------


def test_mesh_and_kvector_sizes_under_vmap_name_the_static_argument():
    cells = torch.stack([torch.eye(3, dtype=torch.float64) * b for b in (5.0, 5.5)])
    with pytest.raises(ValueError, match="ns_mesh"):
        torch.func.vmap(lambda c: torch.tensor(get_ns_mesh(c, 0.3)))(cells)
    with pytest.raises(ValueError, match="ns_kvectors"):
        torch.func.vmap(lambda c: torch.tensor(get_ns_ewald(c, 0.5)))(cells)
    _, batch = make_batch((10, 12), (5.0, 5.5), 2.0, seed=1)
    dist = _t(_distances(batch))
    args = [_t(batch[k]) for k in ("q", "cell", "positions", "idx")]
    pme, _ = _mesh_calcs("PME", "tiled")
    with pytest.raises(ValueError, match="ns_mesh"):
        torch.func.vmap(lambda q, c, p, i, d: pme(q, c, p, i, d))(*args, dist)
    ewald = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=0.5)
    with pytest.raises(ValueError, match="ns_kvectors"):
        torch.func.vmap(lambda q, c, p, i, d: ewald(q, c, p, i, d))(*args, dist)
    # unbatched, under torch.func.grad, the cell's values are read as before
    cell = torch.eye(3, dtype=torch.float64) * 5.0
    assert torch.func.grad(lambda c: (c * get_ns_mesh(c, 0.3)[0]).sum())(cell)[0, 0] == 64


def test_paths_without_a_vmap_rule_refuse_a_batch():
    """Kernels A, B, C and G have no vmap rule: the MD fast paths and the
    fused spread raise instead of taking another route."""
    rng = np.random.default_rng(0)
    f32 = torch.float32
    pos = torch.tensor(rng.uniform(0, 8, (2, 60, 3)), dtype=f32)
    q = torch.tensor(rng.normal(size=(2, 60, 1)), dtype=f32)
    cell = torch.eye(3, dtype=f32) * 8
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.5,
                             mesh_backend="fused")
    fp = tpt.MDFastPath.create(calc, pos[0], cell, 3.0, (16, 16, 16), device="cpu")
    with pytest.raises(NotImplementedError, match="MDFastPath.*ROADMAP"):
        torch.func.vmap(lambda p, qq: fp.energy(qq, cell, fp.bucket(p)))(pos, q)
    interp = mt.compute_tiled_interpolation(pos[0], inv3(cell), (16, 16, 16), 4, "Lagrange")
    empty = (torch.zeros((0, 2), dtype=torch.long), torch.zeros(0, dtype=f32))
    with pytest.raises(NotImplementedError, match="fused.*ROADMAP"):
        torch.func.vmap(lambda p, qq: calc.energy(qq, cell, p, *empty, tiled_interp=interp))(
            pos, q)
