"""The port's ``ops`` namespace exports what it has ported of the JAX
package's: the same public surface for the same functions."""

import importlib
import pkgutil

import torchpme_tpu.ops as jax_ops
import torchpme_tpu_torch.ops as port_ops


def _port_definitions() -> set[str]:
    """Public names defined in any module of the port's ``ops`` package."""
    names = set()
    for info in pkgutil.iter_modules(port_ops.__path__, prefix="torchpme_tpu_torch.ops."):
        module = importlib.import_module(info.name)
        names.update(n for n in vars(module) if not n.startswith("_"))
    return names


def test_ops_exports_every_ported_name_of_the_jax_namespace():
    ported = set(jax_ops.__all__) & _port_definitions()
    assert {"cell_list_rspace_energy", "MeshInterpolationWeights"} <= ported
    # the scalar math and the spline tier (ops/math.py, ops/splines.py)
    assert {"exp1", "CustomExp1", "gamma", "gammainc_over_powerlaw", "gammaincc_over_powerlaw",
            "CubicSpline", "CubicSplineReciprocal", "compute_spline_ft",
            "compute_second_derivatives", "solve_tridiagonal"} <= ported
    missing = sorted(ported - set(port_ops.__all__))
    assert not missing, f"defined by the port but not exported from its ops: {missing}"


def test_ops_exports_resolve():
    for name in port_ops.__all__:
        assert getattr(port_ops, name) is not None, name
