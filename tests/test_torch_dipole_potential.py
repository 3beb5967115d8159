"""``PotentialDipole`` and the host-side pieces of the dipolar slice
(``ops/polyfit.py``, the Ewald k-vector sets): every method of the port ≡ the
JAX package's on the same seeded numpy inputs.

float64 comparisons hold to 1e-12 of max (both sides evaluate the same
closed forms; erfc/exp differ by an ulp between the libraries); float32 to a
few ulp (3e-6 of max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import rel

import torchpme_tpu as tpme
from torchpme_tpu.ops import kvectors as jax_kv
from torchpme_tpu.ops import polyfit as jax_polyfit
from torchpme_tpu_torch import PotentialDipole
from torchpme_tpu_torch.ops import kvectors as port_kv
from torchpme_tpu_torch.ops import polyfit as port_polyfit

torch.set_num_threads(1)

PARAMS = {
    "direct": dict(prefactor=1.3),
    "sr": dict(smearing=0.8, prefactor=1.3),
    "sr_eps": dict(smearing=1.1, epsilon=2.0),
    "excl": dict(smearing=0.9, exclusion_radius=2.5, exclusion_degree=2, prefactor=0.7),
}


def _pair(name):
    return tpme.PotentialDipole(**PARAMS[name]), PotentialDipole(**PARAMS[name])


def _vectors(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1.5 + 0.3


TENSOR_CASES = [
    ("direct", "from_dist"), ("sr", "from_dist"), ("sr", "lr_from_dist"),
    ("sr", "sr_from_dist"), ("sr_eps", "sr_from_dist"), ("excl", "sr_from_dist"),
    ("excl", "lr_from_dist"), ("excl", "f_cutoff"),
]


@pytest.mark.parametrize("name,method", TENSOR_CASES)
def test_tensor_kernels_match_jax(name, method):
    pot_j, pot_t = _pair(name)
    v = _vectors()
    ref = np.asarray(getattr(pot_j, method)(jnp.asarray(v)))
    got = getattr(pot_t, method)(torch.tensor(v)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float64
    assert rel(got, ref) <= 1e-12


SCALAR_CASES = [
    ("direct", "scalar_kernels"), ("sr", "scalar_kernels"), ("sr", "sr_scalar_kernels"),
    ("sr_eps", "sr_scalar_kernels"), ("excl", "sr_scalar_kernels"),
]


@pytest.mark.parametrize("name,method", SCALAR_CASES)
def test_scalar_kernels_match_jax(name, method):
    pot_j, pot_t = _pair(name)
    # from 0.5: below it the LR scalars cancel 1/d⁵ ~ 3e3 against erfc terms
    # down to ~0.1, which amplifies the libraries' 1-ulp erfc difference
    d = np.linspace(0.5, 4.0, 300)
    ref = getattr(pot_j, method)(jnp.asarray(d))
    got = getattr(pot_t, method)(torch.tensor(d))
    for a, b in zip(got, ref):
        assert rel(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("name", ["sr", "excl"])
def test_scalar_kernels_are_the_tensor_kernel(name):
    _, pot_t = _pair(name)
    v = torch.tensor(_vectors(seed=3))
    b, c = pot_t.sr_scalar_kernels(torch.linalg.norm(v, dim=1))
    tensor = b[:, None, None] * torch.eye(3, dtype=v.dtype) - c[:, None, None] * (
        v[:, :, None] * v[:, None, :]
    )
    assert rel(tensor.numpy(), pot_t.sr_from_dist(v).numpy()) <= 1e-12


@pytest.mark.parametrize("name,method", [("direct", "scalar_kernel_derivative"),
                                         ("sr", "sr_scalar_kernel_derivative")])
def test_scalar_kernel_derivative_matches_jax_and_autograd(name, method):
    pot_j, pot_t = _pair(name)
    d = np.linspace(0.3, 4.0, 200)
    kernels = "scalar_kernels" if name == "direct" else "sr_scalar_kernels"
    bj, cj = getattr(pot_j, kernels)(jnp.asarray(d))
    ref = np.asarray(getattr(pot_j, method)(jnp.asarray(d), bj, cj))
    dt = torch.tensor(d, requires_grad=True)
    b, c = getattr(pot_t, kernels)(dt)
    got = getattr(pot_t, method)(dt, b, c)
    assert rel(got.detach().numpy(), ref) <= 1e-12
    (auto,) = torch.autograd.grad(c.sum(), dt)
    assert rel(got.detach().numpy(), auto.numpy()) <= 1e-10


@pytest.mark.parametrize("name", ["direct", "sr"])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_window_scalar_math_sq_matches_jax(name, dt):
    pot_j, pot_t = _pair(name)
    d2 = (np.linspace(0.3, 5.0, 400) ** 2).astype(dt)
    ref = pot_j.window_scalar_math_sq(jnp.asarray(d2))
    got = pot_t.window_scalar_math_sq(torch.tensor(d2))
    tol = 3e-6 if dt == "float32" else 1e-12
    for a, b in zip(got, ref):
        assert a.numpy().dtype == np.dtype(dt)
        assert rel(a.numpy(), b) <= tol


def test_window_scalar_math_sq_is_the_exact_scalars_to_float32():
    """The A&S erfc of the fused float32 form sits below float32 roundoff of
    the exact scalars: 2e-6 of max over the window's distances."""
    _, pot_t = _pair("sr")
    d = torch.linspace(0.3, 5.0, 400, dtype=torch.float64)
    b, c = pot_t.sr_scalar_kernels(d)
    cp = pot_t.sr_scalar_kernel_derivative(d, b, c) / d
    got = pot_t.window_scalar_math_sq((d * d).float())
    for a, ref in zip(got, (b, c, cp)):
        assert rel(a.numpy(), ref.numpy()) <= 2e-6


@pytest.mark.parametrize("name", ["sr", "excl"])
def test_fourier_kernel_and_corrections_match_jax(name):
    pot_j, pot_t = _pair(name)
    k_sq = np.concatenate([[0.0], np.linspace(0.01, 30.0, 100)])
    ref = np.asarray(pot_j.lr_from_k_sq(jnp.asarray(k_sq)))
    got = pot_t.lr_from_k_sq(torch.tensor(k_sq)).numpy()
    assert got[0] == 0.0 and rel(got, ref) <= 1e-12
    assert abs(float(pot_t.self_contribution()) - float(pot_j.self_contribution())) <= (
        1e-12 * abs(float(pot_j.self_contribution()))
    )


@pytest.mark.parametrize("name", ["sr", "sr_eps"])
def test_background_correction_matches_jax(name):
    pot_j, pot_t = _pair(name)
    ref = float(pot_j.background_correction(jnp.asarray(123.0)))
    got = float(pot_t.background_correction(torch.tensor(123.0, dtype=torch.float64)))
    assert got == pytest.approx(ref, rel=1e-12, abs=0.0)
    if name == "sr":
        assert got == 0.0  # epsilon = 0: the surface term is off


def test_methods_needing_smearing_raise_without_it():
    pot = PotentialDipole()
    v = torch.tensor(_vectors(n=4))
    for call in (
        lambda: pot.sr_from_dist(v), lambda: pot.lr_from_dist(v),
        lambda: pot.sr_scalar_kernels(v[:, 0].abs()), lambda: pot.lr_from_k_sq(v[:, 0].abs()),
        pot.self_contribution,
    ):
        with pytest.raises(ValueError, match="smearing"):
            call()
    with pytest.raises(ValueError, match="exclusion_radius"):
        pot.f_cutoff(v)


# -- ops/polyfit.py -------------------------------------------------------------------


def test_polyfit_coefficients_are_bit_identical():
    fn = lambda r: np.exp(-0.7 * r**2) * (1 + r)  # noqa: E731
    ours = port_polyfit.fit_f32_cheb(fn, 0.0, 3.0)
    theirs = jax_polyfit.fit_f32_cheb(fn, 0.0, 3.0)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert port_polyfit.fit_f32_cheb(lambda r: np.sign(r - 1.5), 0.0, 3.0) is None


@pytest.mark.parametrize("smearing,cutoff", [(0.7, 3.0), (1.2826, 5.0)])
def test_dipole_window_scalar_math_is_bit_identical(smearing, cutoff):
    """Same coefficients → the same float32 Clenshaw values, bit for bit, on
    numpy inputs; and on a torch tensor the port's callable agrees to float32
    roundoff (4e-6 of max: the recurrence amplifies an ulp)."""
    ours = port_polyfit.dipole_window_scalar_math(1.3, smearing, cutoff)
    theirs = jax_polyfit.dipole_window_scalar_math(1.3, smearing, cutoff)
    d = np.linspace(0.05, cutoff, 500, dtype=np.float32)
    for a, b in zip(ours(d), theirs(d)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours(torch.tensor(d)), theirs(d)):
        assert a.dtype == torch.float32
        assert rel(a.numpy(), b) <= 4e-6


def test_clenshaw_matches_numpy_chebval():
    rng = np.random.default_rng(0)
    coeffs = rng.normal(size=12)
    u = np.linspace(-1, 1, 50)
    ref = np.polynomial.chebyshev.chebval(u, coeffs)
    np.testing.assert_allclose(port_polyfit.clenshaw(coeffs, u), ref, atol=1e-12)
    got = port_polyfit.clenshaw(coeffs, torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)


def test_window_scalar_math_gates():
    # an exclusion window changes the pair term
    assert PotentialDipole(smearing=1.0, exclusion_radius=1.0).window_scalar_math(3.0) is None
    # extreme alpha·cutoff: the fit cannot reach tolerance
    assert PotentialDipole(smearing=0.1).window_scalar_math(10.0) is None
    # direct mode is exact rational math: always available
    assert PotentialDipole(smearing=None).window_scalar_math(3.0) is not None
    # a parameter that wants a gradient: the fused forms give it none
    trainable = PotentialDipole(smearing=torch.tensor(1.0, requires_grad=True))
    assert trainable.has_trainable_parameters()
    assert trainable.window_scalar_math(3.0) is None
    assert not PotentialDipole(smearing=torch.tensor(1.0)).has_trainable_parameters()


@pytest.mark.parametrize("smearing", [0.7, None])
def test_window_scalar_math_matches_exact_scalars(smearing):
    """(B, C, C') of the transcendental-free hook against the exact scalars,
    2e-6 of max (the JAX package's own bar for the fits)."""
    pot_t = PotentialDipole(smearing=smearing, prefactor=1.3)
    pot_j = tpme.PotentialDipole(smearing=smearing, prefactor=1.3)
    d = torch.linspace(0.05, 3.0, 2000, dtype=torch.float64)
    if smearing is None:
        b_ref, c_ref = pot_t.scalar_kernels(d)
        cp_ref = pot_t.scalar_kernel_derivative(d, b_ref, c_ref)
    else:
        b_ref, c_ref = pot_t.sr_scalar_kernels(d)
        cp_ref = pot_t.sr_scalar_kernel_derivative(d, b_ref, c_ref)
    got = pot_t.window_scalar_math(3.0)(d.float())
    theirs = pot_j.window_scalar_math(3.0)(jnp.asarray(d.numpy(), jnp.float32))
    for a, ref, b in zip(got, (b_ref, c_ref, cp_ref), theirs):
        assert rel(a.numpy(), ref.numpy()) <= 2e-6
        assert rel(a.numpy(), b) <= 4e-6


# -- ops/kvectors.py ------------------------------------------------------------------


@pytest.mark.parametrize("lr_wavelength", [0.5, 1.7])
def test_ewald_kvectors_match_jax(lr_wavelength):
    cell = np.asarray([[9.0, 0.0, 0.0], [1.5, 8.0, 0.0], [0.5, -1.0, 11.0]])
    ns = port_kv.get_ns_ewald(cell, lr_wavelength)
    assert ns == jax_kv.get_ns_ewald(cell, lr_wavelength)
    assert ns == port_kv.get_ns_ewald(torch.tensor(cell), lr_wavelength)
    ref = np.asarray(jax.jit(jax_kv.generate_kvectors_for_ewald, static_argnums=(1,))(
        jnp.asarray(cell), ns))
    got = port_kv.generate_kvectors_for_ewald(torch.tensor(cell), ns).numpy()
    assert got.shape == ref.shape == (ns[0] * ns[1] * ns[2], 3)
    assert np.all(got[0] == 0.0) and rel(got, ref) <= 1e-13
