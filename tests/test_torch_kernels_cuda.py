"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the kernels
have no CPU mode; their arithmetic is covered on the CPU through the twins).
On a machine with a card (which has no JAX, so without the suite's
conftest): ``python -m pytest tests/test_torch_kernels_cuda.py --noconftest``.
"""

import numpy as np
import pytest
import torch

import torchpme_tpu_torch as tpt
from torchpme_tpu_torch import kernels
from torchpme_tpu_torch.ops import rspace_cells as rc
from torchpme_tpu_torch.ops import spread_fused as sf

pytestmark = pytest.mark.cuda

NS = (32, 32, 32)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _clustered_box(seed=3):
    """400 random atoms plus a dense cluster (the cell list spills)."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(0, 16.0, (400, 3)), 0.5 + 0.6 * rng.uniform(size=(30, 3))])
    q = rng.normal(size=(430, 1))
    return pos, q - q.mean(), np.eye(3) * 16.0


@pytest.fixture(scope="module")
def step(device):
    pos, q, cell = _clustered_box()
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=5)
    f32 = dict(dtype=torch.float32, device=device)
    fp = tpt.MDFastPath.create(calc, torch.tensor(pos, **f32), torch.tensor(cell, **f32), 3.0, NS)
    return fp, torch.tensor(pos, **f32), torch.tensor(q, **f32), torch.tensor(cell, **f32)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _slots(fp, pos, q, cell):
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = sf.aligned_geometry(5, fp.aligned_pad)
    geom = sf.SpreadGeometry(NS, 5, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap)
    nb = geom.n_tiles * geom.slots_per_tile
    rows = fp.bucket(pos)
    ns = torch.tensor(NS, dtype=torch.float32, device=pos.device)
    rel = (rows @ torch.linalg.inv(cell) * ns)[:nb].contiguous()
    q_rows = torch.zeros((fp.n_rows, 1), dtype=torch.float32, device=pos.device)
    q_rows = q_rows.index_copy(0, fp.row_of_atom.long(), q)[:nb].contiguous()
    return rel, q_rows, geom


def test_spread_kernels_match_plain(step):
    fp, pos, q, cell = step
    rel, q_rows, geom = _slots(fp, pos, q, cell)
    assert _rel(sf.fused_spread(rel, q_rows, geom), sf.spread_plain(rel, q_rows, geom)) <= 1e-5
    ct = torch.randn((1, *NS), device=pos.device)
    for a, b in zip(
        sf.fused_spread_bwd(rel, q_rows, ct, geom), sf.spread_plain_bwd(rel, q_rows, ct, geom)
    ):
        assert _rel(a, b) <= 1e-5


def test_window_kernel_matches_plain(step):
    fp, pos, q, cell = step
    n_cells, cap = fp.clist.slot_mask.shape
    rows = fp.bucket(pos)[: n_cells * cap].reshape(n_cells, cap, 3)
    ins = rc._prepare_bucketed(q[fp.clist.atom_index.long()], rows, cell, fp.clist)[:4]
    pot = fp.calc.potential
    e_k, g_k = rc.window_value_and_grad(pot, 3.0, *ins)
    e_p, g_p = rc._we_value_and_grad(pot, 3.0, *ins)
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * abs(float(e_p))
    for a, b in zip(g_k, g_p):
        assert _rel(a, b) <= 1e-5


def test_step_launches_every_kernel_and_matches_plain(step):
    fp, pos, q, cell = step
    out = {}
    for plain in (False, True):
        rows = fp.bucket(pos).requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(q, cell, rows, plain=plain)
        (g,) = torch.autograd.grad(e, rows)
        torch.cuda.synchronize()
        out[plain] = (float(e.detach()), g, kernels.launch_counts())
    assert all(n == 1 for n in out[False][2].values()), out[False][2]
    assert all(n == 0 for n in out[True][2].values()), out[True][2]
    assert abs(out[False][0] - out[True][0]) <= 1e-5 * abs(out[True][0])
    assert _rel(out[False][1], out[True][1]) <= 1e-5


def test_kernels_refuse_float64(step):
    fp, pos, q, cell = step
    with pytest.raises(TypeError, match="float32"):
        fp.energy(q.double(), cell.double(), fp.bucket(pos.double()))
    assert np.isfinite(float(fp.energy(q.double(), cell.double(), fp.bucket(pos.double()), plain=True)))
