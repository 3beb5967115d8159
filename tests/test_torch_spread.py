"""The module of kernels A and B (``ops/spread_fused.py``): the port's plain
aligned spread and its VJP ≡ the JAX package's Pallas kernels (interpret
mode) on the rows of an aligned MDFastPath, plus the wrapper contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_kernel_params as kernel_params
from torch_port_common import port_from_jax, random_box, rel

import torchpme_tpu as tpme
from torchpme_tpu.ops.math import inv3 as jax_inv3
from torchpme_tpu.ops.pallas.spread_fused import (
    aligned_tiled_density as jax_aligned_density,
)
from torchpme_tpu_torch.ops import spread_fused as sf

torch.set_num_threads(1)

NS = (32, 32, 32)

# (nodes, balance): nodes 5 with the default balance spills and widens the
# window (aligned_pad >= 1); nodes 4 exercises the even (floor) stencils
CASES = {"nodes5_spill_pad": (5, "auto"), "nodes4_unbalanced": (4, False)}


def _system(nodes, balance):
    pos, q, cell = random_box(400, 16.0, seed=3, lo=-1.0, hi=17.0)
    calc = tpme.PMECalculator(
        tpme.CoulombPotential(smearing=1.0), mesh_spacing=0.5,
        interpolation_nodes=nodes,
    )
    f32 = jnp.float32
    fp_j = tpme.MDFastPath.create(
        calc, jnp.asarray(pos, f32), jnp.asarray(cell, f32), 3.0, NS,
        mesh_impl="aligned", balance=balance,
    )
    rows = np.asarray(fp_j.bucket(jnp.asarray(pos, f32)))
    q_rows = np.zeros((fp_j.n_rows, 1), np.float32)
    q_rows[np.asarray(fp_j.row_of_atom)] = q
    inv = np.asarray(jax_inv3(jnp.asarray(cell, f32)))
    w = np.random.default_rng(11).normal(size=(1, *NS)).astype(np.float32)
    return fp_j, rows, q_rows, inv, w


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    nodes, balance = CASES[request.param]
    fp_j, rows, q_rows, inv, w = _system(nodes, balance)
    args = (NS, nodes, "Lagrange", fp_j.cell_grid)

    def loss_j(p, q, c):
        rho = jax_aligned_density(p, q, c, *args, pad_cells=fp_j.aligned_pad)
        return jnp.sum(rho * jnp.asarray(w)), rho

    (_, rho_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(rows), jnp.asarray(q_rows), jnp.asarray(inv)
    )
    return dict(
        fp_j=fp_j, rows=rows, q_rows=q_rows, inv=inv, w=w, args=args,
        rho_j=np.asarray(rho_j), g_j=[np.asarray(g) for g in g_j],
    )


def _port(case, plain=False):
    p = torch.tensor(case["rows"], requires_grad=True)
    q = torch.tensor(case["q_rows"], requires_grad=True)
    c = torch.tensor(case["inv"], requires_grad=True)
    rho = sf.aligned_tiled_density(
        p, q, c, *case["args"], pad_cells=case["fp_j"].aligned_pad, plain=plain
    )
    grads = torch.autograd.grad(torch.sum(rho * torch.tensor(case["w"])), (p, q, c))
    return rho.detach().numpy(), [g.numpy() for g in grads]


def test_case_geometry(case):
    fp_j = case["fp_j"]
    if fp_j.calc.interpolation_nodes == 5:
        assert fp_j.aligned_pad >= 1
        assert fp_j.clist.extra_index is not None, "no spill extras"
    else:
        assert fp_j.aligned_pad == 0


def test_density_matches_jax(case):
    rho, _ = _port(case)
    assert rho.dtype == np.float32
    np.testing.assert_allclose(rho, case["rho_j"], atol=1e-5)  # tests/ops/test_spread_fused.py:49


@pytest.mark.parametrize("arg", ["pos_rows", "q_rows", "inverse_cell"])
def test_density_vjp_matches_jax(case, arg):
    _, grads = _port(case)
    i = ["pos_rows", "q_rows", "inverse_cell"].index(arg)
    assert rel(grads[i], case["g_j"][i]) <= 1e-5


def test_plain_flag_is_the_cpu_path(case):
    rho_a, g_a = _port(case)
    rho_b, g_b = _port(case, plain=True)
    np.testing.assert_array_equal(rho_a, rho_b)
    for a, b in zip(g_a, g_b):
        np.testing.assert_array_equal(a, b)


def test_float64_plain_spread(case):
    """The plain twins take float64 too (the on-card reference path); the
    float32 density agrees with it to float32 roundoff."""
    p = torch.tensor(case["rows"], dtype=torch.float64)
    q = torch.tensor(case["q_rows"], dtype=torch.float64)
    c = torch.tensor(case["inv"], dtype=torch.float64)
    rho64 = sf.aligned_tiled_density(p, q, c, *case["args"], pad_cells=case["fp_j"].aligned_pad)
    assert rho64.dtype == torch.float64
    assert rel(case["rho_j"], rho64.numpy()) <= 1e-5


def _slots(case, dtype=torch.float32, device="cpu"):
    fp = port_from_jax(case["fp_j"])
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = sf.aligned_geometry(fp.calc.interpolation_nodes, fp.aligned_pad)
    geom = sf.SpreadGeometry(
        NS, fp.calc.interpolation_nodes, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap,
        nz_c,
    )
    nb = geom.n_tiles * geom.slots_per_tile
    rel_t = torch.tensor(case["rows"][:nb] @ case["inv"] * np.asarray(NS, np.float32))
    q = torch.tensor(case["q_rows"][:nb])
    return rel_t.to(device=device, dtype=dtype), q.to(device=device, dtype=dtype), geom


def test_wrappers_take_plain_twin_on_cpu(case):
    rel_t, q, geom = _slots(case)
    np.testing.assert_array_equal(
        sf.fused_spread(rel_t, q, geom).numpy(), sf.spread_plain(rel_t, q, geom).numpy()
    )
    ct = torch.tensor(case["w"])
    for a, b in zip(
        sf.fused_spread_bwd(rel_t, q, ct, geom), sf.spread_plain_bwd(rel_t, q, ct, geom)
    ):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrappers_raise_off_cpu(case):
    """A tensor that is not on the CPU never takes the plain twin: the
    wrapper validates it for the kernel and raises on what it cannot take."""
    rel64, q64, geom = _slots(case, torch.float64, "meta")
    with pytest.raises(TypeError, match="float32"):
        sf.fused_spread(rel64, q64, geom)
    with pytest.raises(TypeError, match="float32"):
        sf.fused_spread_bwd(rel64, q64, torch.empty((1, *NS), device="meta"), geom)
    rel32, q32, geom = _slots(case, torch.float32, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        sf.fused_spread(rel32, q32, geom)


def test_spread_geometry_checks():
    p = torch.zeros((4 * 4 * 2 * 8, 3))
    q = torch.zeros((p.shape[0], 1))
    inv = torch.eye(3)
    with pytest.raises(ValueError, match="not aligned"):
        sf.aligned_tiled_density(p, q, inv, NS, 5, "Lagrange", (2, 4, 2, 8))
    with pytest.raises(ValueError, match="2-tile fold"):
        sf.aligned_tiled_density(p, q, inv, NS, 5, "Lagrange", (4, 4, 2, 8), pad_cells=2)


# -- kernel A's decomposition, mirrored in float64 --------------------------------


def _owner_block_mirror(rel, q, geom, z_chunk):
    """Test-only mirror of kernel A's index algebra: one owner block per
    (mesh tile, z chunk) holds its 8×8×zc cells, reads the slots of the 3×3
    torus tiles around it (2 distinct ones along an axis of 2 tiles) in the
    z cells whose atoms can reach the chunk (an atom stays within one z cell
    of its own while the staleness check accepts it), and adds every
    stencil node that lands in its cells; nothing crosses blocks.  Returns
    the density and the number of blocks that read fewer than all z cells."""
    nx, ny, nz = geom.ns
    n, e, lpad = geom.nodes, geom.extent, geom.lpad
    tx_count, ty_count = nx // sf.TILE, geom.ty_count
    cap = geom.slots_per_tile // geom.z_cells
    hz = nz / geom.z_cells
    shift0 = 1 - (n + 1) // 2
    coeffs, _ = sf._tables(geom.method, n)
    rho = torch.zeros((q.shape[1], nx, ny, nz), dtype=rel.dtype)
    nodes = torch.arange(n)
    n_restricted = 0

    def near(count):
        return (-1, 0, 1) if count >= 3 else (0, 1)

    def axis(base, tile_origin, size, origin):
        """Local index of each node in the owner tile (−1 when outside)."""
        local = torch.remainder(
            torch.remainder(base + shift0, size) + lpad - tile_origin, size
        )[:, None]
        g = torch.remainder(tile_origin[:, None] - lpad + local + nodes, size)
        own = torch.remainder(g - origin, size)
        return torch.where((local + nodes < e) & (own < sf.TILE), own, -1)

    for tx in range(tx_count):
        for ty in range(ty_count):
            for z0 in range(0, nz, z_chunk):
                zlen = min(z_chunk, nz - z0)
                c_lo = int(np.floor((z0 - n - 1) / hz)) - 2
                c_hi = int(np.ceil((z0 + zlen + n + 1) / hz)) + 1
                zcells = range(geom.z_cells)
                if c_hi - c_lo + 1 < geom.z_cells:
                    zcells = [c % geom.z_cells for c in range(c_lo, c_hi + 1)]
                    n_restricted += 1
                tiles = [
                    ((tx + dx) % tx_count) * ty_count + (ty + dy) % ty_count
                    for dx in near(tx_count) for dy in near(ty_count)
                ]
                slots = torch.tensor([
                    t * geom.slots_per_tile + c * cap + s
                    for t in tiles for c in zcells for s in range(cap)
                ])
                tile = slots // geom.slots_per_tile
                r = rel[slots]
                bx, offx = sf._axis_offsets(r[:, 0], n)
                by, offy = sf._axis_offsets(r[:, 1], n)
                bz, offz = sf._axis_offsets(r[:, 2], n)
                lx = axis(bx, tile // ty_count * sf.TILE, nx, tx * sf.TILE)
                ly = axis(by, tile % ty_count * sf.TILE, ny, ty * sf.TILE)
                lz = torch.remainder(bz + shift0, nz)[:, None] + nodes - z0
                lz = torch.where(lz >= nz, lz - nz, lz)
                lz = torch.where((lz >= 0) & (lz < zlen), lz, -1)
                w = (
                    sf._node_weights(offx, coeffs)[:, :, None, None]
                    * sf._node_weights(offy, coeffs)[:, None, :, None]
                    * sf._node_weights(offz, coeffs)[:, None, None, :]
                )
                keep = (lx[:, :, None, None] >= 0) & (ly[:, None, :, None] >= 0) & (
                    lz[:, None, None, :] >= 0
                )
                ix = lx[:, :, None, None].expand_as(keep)[keep]
                iy = ly[:, None, :, None].expand_as(keep)[keep]
                iz = lz[:, None, None, :].expand_as(keep)[keep]
                for ch in range(q.shape[1]):
                    field = torch.zeros((sf.TILE, sf.TILE, zlen), dtype=rel.dtype)
                    vals = (w * q[slots, ch][:, None, None, None])[keep]
                    field.index_put_((ix, iy, iz), vals, accumulate=True)
                    rho[ch, tx * sf.TILE:(tx + 1) * sf.TILE, ty * sf.TILE:(ty + 1) * sf.TILE,
                        z0:z0 + zlen] = field
    return rho, n_restricted


def _port_slots(nodes, ns, box, n_atoms, capacity=None, n_ch=1, seed=0):
    """float64 slots of a port-built aligned MD state (CPU) in an
    orthorhombic box of edges ``box``."""
    from torchpme_tpu_torch import CoulombPotential, MDFastPath, PMECalculator

    rng = np.random.default_rng(seed)
    cell = np.diag(np.broadcast_to(np.asarray(box, np.float64), (3,)))
    pos = rng.uniform(0, 1, (n_atoms, 3)) @ cell
    calc = PMECalculator(CoulombPotential(smearing=1.0), interpolation_nodes=nodes)
    fp = MDFastPath.create(calc, pos, cell, 3.0, ns, mesh_impl="aligned",
                           cell_capacity=capacity, device="cpu")
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = sf.aligned_geometry(nodes, fp.aligned_pad)
    geom = sf.SpreadGeometry(ns, nodes, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap, nz_c)
    nb = geom.n_tiles * geom.slots_per_tile
    rows = fp.bucket(torch.tensor(pos))[:nb]
    rel_t = rows @ torch.linalg.inv(torch.tensor(cell)) * torch.tensor(ns, dtype=torch.float64)
    q = torch.zeros((fp.n_rows, n_ch), dtype=torch.float64)
    q = q.index_copy(0, fp.row_of_atom.long(), torch.tensor(rng.normal(size=(n_atoms, n_ch))))
    return rel_t, q[:nb].contiguous(), geom


MIRROR_CASES = {
    # the main path's layout scaled down: 5 nodes, balanced, widened window
    "nodes5_scaled": dict(nodes=5, ns=(32, 32, 32), box=16.0, n_atoms=600),
    # a tall column (13 z cells): chunks read only the z cells near them
    "nodes5_tall": dict(nodes=5, ns=(32, 32, 80), box=(16.0, 16.0, 40.0), n_atoms=1400),
    "nodes4_even": dict(nodes=4, ns=(32, 32, 40), box=16.0, n_atoms=500, n_ch=2),
    "nodes3_cap_gt_32": dict(nodes=3, ns=(32, 32, 32), box=12.0, n_atoms=900, capacity=40),
    "nodes6_two_tiles": dict(nodes=6, ns=(16, 16, 40), box=8.0, n_atoms=150),
}


@pytest.mark.parametrize("z_chunk", [8, 12, "rule"])
@pytest.mark.parametrize("name", list(MIRROR_CASES))
def test_kernel_decomposition_matches_plain(name, z_chunk):
    """Kernel A's owner blocks (tile × z chunk, 3×3 tile neighbourhood, z
    cell range) ≡ the plain tile fields and fold (float64, ≤ 1e-12), at
    small chunks and at the chunk the wrapper picks (``z_chunk``)."""
    rel_t, q, geom = _port_slots(**MIRROR_CASES[name])
    if name == "nodes3_cap_gt_32":
        assert geom.slots_per_tile // geom.z_cells > 32
    assert geom.z_cells > 1
    if z_chunk == "rule":
        z_chunk = kernel_params.z_chunk(geom.ns[2])
        assert 2 * z_chunk >= geom.ns[2] > z_chunk
    got, n_restricted = _owner_block_mirror(rel_t, q, geom, z_chunk)
    if z_chunk in (8, 12):  # chunks this small read only the z cells near them
        assert (n_restricted > 0) == (name == "nodes5_tall")
    ref = sf.spread_plain(rel_t, q, geom)
    assert rel(got.numpy(), ref.numpy()) <= 1e-12
    np.testing.assert_allclose(float(got.sum()), float(q.sum()), rtol=1e-12, atol=1e-12)


# -- kernel B's decomposition, mirrored in float64 --------------------------------


def _bwd_block_mirror(rel, q, ct, geom, z_chunk):
    """Test-only mirror of kernel B's staged blocks: one block per (tile, z
    chunk) stages the tile's ``(C, E, E, zn + n − 1)`` window of the mesh
    cotangent (wrapping modulo the mesh), scans all of its tile's slots and
    owns those whose z stencil start lies in its chunk, and contracts each
    against the staged window in the kernel's summation order.  Checks that
    every node a slot reads is the mesh node it stands for, and returns
    ``(ct_rel, ct_q, owners)``: the outputs and how many blocks own each
    slot."""
    nx, ny, nz = geom.ns
    n, e, lpad = geom.nodes, geom.extent, geom.lpad
    kp, n_ch = geom.slots_per_tile, q.shape[1]
    shift0 = 1 - (n + 1) // 2
    coeffs, deriv = sf._tables(geom.method, n)
    (bx, offx), (by, offy), (bz, offz) = (sf._axis_offsets(rel[:, i], n) for i in range(3))
    gx0 = torch.remainder(bx + shift0, nx)
    gy0 = torch.remainder(by + shift0, ny)
    sz = torch.remainder(bz + shift0, nz)
    w = [sf._node_weights(off, coeffs) for off in (offx, offy, offz)]
    d = [sf._node_weights(off, deriv) for off in (offx, offy, offz)]
    ct_rel = torch.full((rel.shape[0], 3), float("nan"), dtype=rel.dtype)
    ct_q = torch.full((rel.shape[0], n_ch), float("nan"), dtype=rel.dtype)
    owners = torch.zeros(rel.shape[0], dtype=torch.long)
    for tile in range(geom.n_tiles):
        ox, oy = tile // geom.ty_count * sf.TILE, tile % geom.ty_count * sf.TILE
        slots = torch.arange(tile * kp, (tile + 1) * kp)
        for z0 in range(0, nz, z_chunk):
            zn = min(z_chunk, nz - z0)
            zlen = zn + n - 1
            assert zlen <= (z_chunk + n - 1 + 3) & ~3  # the kernel's row of floats
            wx_ = torch.remainder(ox - lpad + torch.arange(e), nx)
            wy_ = torch.remainder(oy - lpad + torch.arange(e), ny)
            wz_ = torch.remainder(z0 + torch.arange(zlen), nz)
            window = ct[:, wx_][:, :, wy_][:, :, :, wz_]  # (C, E, E, zlen)
            mine = slots[(sz[slots] >= z0) & (sz[slots] < z0 + zn)]
            owners[mine] += 1
            if mine.numel() == 0:
                continue
            lx = torch.remainder(gx0[mine] + lpad - ox, nx)
            ly = torch.remainder(gy0[mine] + lpad - oy, ny)
            zi = sz[mine] - z0
            (wx, wy, wz), (dx, dy, dz) = ([t[mine] for t in w], [t[mine] for t in d])
            zero = torch.zeros(mine.numel(), dtype=rel.dtype)
            cx = cy = cz = zero
            for ch in range(n_ch):
                cq = gx = gy = gz = zero
                for a in range(n):
                    ok_x = lx + a < e
                    sw = sdy = sdz = zero
                    for b in range(n):
                        ok = ok_x & (ly + b < e)
                        ia = torch.where(ok, lx + a, 0)
                        ib = torch.where(ok, ly + b, 0)
                        sw_c = sd_c = zero
                        for c in range(n):
                            v = window[ch, ia, ib, zi + c]
                            node = ct[ch, torch.remainder(gx0[mine] + a, nx),
                                      torch.remainder(gy0[mine] + b, ny),
                                      torch.remainder(sz[mine] + c, nz)]
                            assert torch.equal(v[ok], node[ok])
                            sw_c = sw_c + wz[:, c] * v
                            sd_c = sd_c + dz[:, c] * v
                        sw = torch.where(ok, sw + wy[:, b] * sw_c, sw)
                        sdy = torch.where(ok, sdy + dy[:, b] * sw_c, sdy)
                        sdz = torch.where(ok, sdz + wy[:, b] * sd_c, sdz)
                    cq = torch.where(ok_x, cq + wx[:, a] * sw, cq)
                    gx = torch.where(ok_x, gx + dx[:, a] * sw, gx)
                    gy = torch.where(ok_x, gy + wx[:, a] * sdy, gy)
                    gz = torch.where(ok_x, gz + wx[:, a] * sdz, gz)
                ct_q[mine, ch] = cq
                qv = q[mine, ch]
                cx, cy, cz = cx + qv * gx, cy + qv * gy, cz + qv * gz
            ct_rel[mine] = torch.stack([cx, cy, cz], dim=1)
    return ct_rel, ct_q, owners


def _fused_bwd_slots(nodes, ns, box, n_atoms, n_ch, seed=0):
    """float64 slots of a stencil-start bucketing (``fused_tiled_density``'s
    layout), with one atom drifted out of its tile after the bucketing (a
    stale slot) and an atom at the top of the box (its z stencil wraps)."""
    from torchpme_tpu_torch.ops.mesh_tiled import compute_tiled_interpolation

    rng = np.random.default_rng(seed)
    cell = torch.tensor(np.diag(np.broadcast_to(np.asarray(box, np.float64), (3,))))
    pos = torch.tensor(rng.uniform(0, 1, (n_atoms, 3))) @ cell
    pos[1, 2] = cell[2, 2] * (1 - 0.2 / ns[2])
    inv = torch.linalg.inv(cell)
    interp = compute_tiled_interpolation(pos, inv, ns, nodes, "Lagrange")
    pos[0, 0] += 0.4 * cell[0, 0]
    q = torch.tensor(rng.normal(size=(n_atoms, n_ch)))
    return sf._fused_slots(interp, pos, inv, q, "Lagrange")


BWD_MIRROR_CASES = {
    **{f"aligned_{name}": name for name in ("nodes5_scaled", "nodes4_even", "nodes6_two_tiles")},
    "fused_nodes5": dict(nodes=5, ns=(32, 32, 40), box=10.0, n_atoms=300, n_ch=1),
    "fused_nodes4_ch2": dict(nodes=4, ns=(16, 32, 36), box=(5.0, 10.0, 12.0), n_atoms=200,
                             n_ch=2),
    "fused_nodes7": dict(nodes=7, ns=(16, 16, 24), box=6.0, n_atoms=120, n_ch=1),
}


@pytest.mark.parametrize("z_chunk", [8, 16, "rule"])
@pytest.mark.parametrize("name", list(BWD_MIRROR_CASES))
def test_kernel_b_partition_matches_plain(name, z_chunk):
    """Kernel B's blocks (tile × z chunk, every slot of the tile scanned,
    the owner the chunk of its z stencil start) own every slot once, stage
    every node the slot reads, and in the kernel's summation order ≡ the
    plain VJP (float64, ≤ 1e-12): in the aligned layout and the fused one,
    with a partial last chunk (nz = 40, 36, 24 at 16 cells), z stencils that
    wrap, empty slots and a stale slot."""
    case = BWD_MIRROR_CASES[name]
    if isinstance(case, str):
        rel_t, q, geom = _port_slots(**MIRROR_CASES[case])
        occupied = torch.nonzero((q != 0).any(dim=1))[:, 0]
        rel_t[occupied[0], 2] = geom.ns[2] - 0.3  # its z stencil wraps
        rel_t[occupied[1], 2] += 0.45 * geom.ns[2]  # stale: far from its z cell
    else:
        rel_t, q, geom = _fused_bwd_slots(**case)
        assert geom.lpad == 0 and geom.z_cells == 1
    if z_chunk == "rule":
        z_chunk = kernel_params.bwd_z_chunk(geom.nodes, geom.extent, q.shape[1])
    ct = torch.tensor(
        np.random.default_rng(5).normal(size=(q.shape[1], *geom.ns)), dtype=torch.float64
    )
    got_rel, got_q, owners = _bwd_block_mirror(rel_t, q, ct, geom, z_chunk)
    assert bool((owners == 1).all())
    ref_rel, ref_q = sf.spread_plain_bwd(rel_t, q, ct, geom)
    assert rel(got_rel.numpy(), ref_rel.numpy()) <= 1e-12
    assert rel(got_q.numpy(), ref_q.numpy()) <= 1e-12
    empty = (q == 0).all(dim=1)
    assert float(got_rel[empty].abs().sum()) == 0.0
    nz, n = geom.ns[2], geom.nodes
    sz = torch.remainder(sf._axis_offsets(rel_t[~empty, 2], n)[0] + 1 - (n + 1) // 2, nz)
    assert bool((sz + n - 1 >= nz).any())  # a z stencil wraps
