"""Ahead-of-time export / serialized deployment of calculators (``torch.export``).

Counterpart of :mod:`torchpme_tpu.deploy`.  A step — a calculator call, or
an MD step with its forces — is traced once with :func:`torch.export.export`
at example arguments, serialised with :func:`torch.export.save` to bytes,
and later run from those bytes, in a process that need not import the
calculators:

* :func:`export_step` — trace ``fn(*example_args)`` (optionally its value
  and gradient) for one or more platforms and return the bytes;
* :func:`load_step` — deserialise them back to a callable.

"Exporting a calculator" is exporting a closure over it: its state (an MD
step's cell list, tile geometry and ``ns_mesh``, a potential's parameters)
becomes constants of the artifact, as the JAX package bakes its pytrees in.
Shapes are static: a call at other shapes raises.

The hand-written kernels are the ``tpme::`` ops, which ``torch.export``
traces as single nodes.  A **CPU** program has each of them replaced by its
plain version at export (:data:`~torchpme_tpu_torch.kernels.PLAIN_VERSIONS`,
through ``run_decompositions``): its graph holds ATen operators only and
runs with ``torch`` alone, ``torch.export.load(io.BytesIO(data)).module()``.
A **CUDA** program keeps the ops, so it runs the hand kernels, and the
artifact carries the op library they are registered in (C++,
:mod:`~torchpme_tpu_torch.kernels`): a zip of the program (``cuda.pt2``),
the library (``tpme_ops.so``) and what it was built for
(``tpme_library.json``: the torch version, the card's architecture
``sm_90a``).  So it too runs with ``torch`` alone, in a process that never
imports this package, or in a C++ engine that embeds libtorch:

.. code-block:: python

    import io, tempfile, zipfile
    import torch

    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        library, program = archive.read("tpme_ops.so"), archive.read("cuda.pt2")
    with tempfile.NamedTemporaryFile(suffix=".so") as f:
        f.write(library)
        f.flush()
        torch.ops.load_library(f.name)   # the tpme:: ops and kernels A-G
    step = torch.export.load(io.BytesIO(program)).module()
    energy, grads = step(*args)          # CUDA tensors of the exported shapes

:func:`load_step` does that, and checks the torch version and the device
first.  The library must match the process's torch: it is built against
torch's headers and links its libraries.

Example
-------
>>> import numpy as np, torch
>>> import torchpme_tpu_torch as tpt
>>> from torchpme_tpu_torch.deploy import export_step, load_step
>>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
>>> rng = np.random.default_rng(0)
>>> positions = torch.tensor(rng.uniform(0, 8.0, (24, 3)))
>>> charges = torch.tensor(np.tile([1.0, -1.0], 12).reshape(-1, 1))
>>> cell = torch.eye(3, dtype=torch.float64) * 8.0
>>> calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0),
...                            lr_wavelength=2.0)
>>> idx, dist, _ = (torch.as_tensor(a) for a in neighbor_list(positions, cell, 3.0))
>>> ns_k = calc.get_ns_kvectors(cell)  # static, like every k-grid of an export
>>> def potentials(charges, cell, positions, dist):
...     return calc(charges, cell, positions, idx, dist, ns_kvectors=ns_k)
>>> blob = export_step(potentials, charges, cell, positions, dist)
>>> restored = load_step(blob)          # no calculator needed from here on
>>> out = restored(charges, cell, positions, dist)
>>> ref = potentials(charges, cell, positions, dist)
>>> print(bool(torch.allclose(out, ref, atol=1e-12)))
True
"""

from __future__ import annotations

import importlib
import io
import json
import tempfile
import warnings
import zipfile
from collections.abc import Callable, Sequence

import torch
from torch import nn

__all__ = ["export_step", "load_step"]

#: The modules whose import registers the ``tpme::`` ops' plain versions,
#: which a CPU export puts in place of the ops (an artifact's loader imports
#: none of them).
OP_MODULES = (
    "torchpme_tpu_torch.ops.spread_fused",
    "torchpme_tpu_torch.ops.rspace_cells",
    "torchpme_tpu_torch.ops.rspace_cells_dipole",
    "torchpme_tpu_torch.ops.mesh_kernels",
)
PLATFORMS = ("cpu", "cuda")
#: members of a zip artifact: the platforms, one program per platform
#: (``<platform>.pt2``), and with a CUDA program the op library and what it
#: was built for
_INDEX = "tpme_platforms.json"
LIBRARY = "tpme_ops.so"
LIBRARY_INFO = "tpme_library.json"


class _Step(nn.Module):
    """``fn``, or with ``argnums`` its value and gradient: the gradient is
    taken by ``torch.autograd.grad`` on fresh leaves."""

    def __init__(self, fn: Callable, argnums):
        super().__init__()
        self.fn = fn
        self.argnums = argnums

    def forward(self, *args):
        if self.argnums is None:
            return self.fn(*args)
        nums = (self.argnums,) if isinstance(self.argnums, int) else self.argnums
        with torch.enable_grad():
            leaves = list(args)
            for i in nums:
                leaves[i] = args[i].detach().requires_grad_(True)
            value = self.fn(*leaves)
            grads = torch.autograd.grad(
                value, [leaves[i] for i in nums], allow_unused=True, materialize_grads=True
            )
        grads = [g.detach() for g in grads]
        return value.detach(), grads[0] if isinstance(self.argnums, int) else tuple(grads)


def _platform_of(args) -> str:
    kinds = {a.device.type for a in args if isinstance(a, torch.Tensor)}
    if len(kinds) > 1:
        raise ValueError(f"the arguments lie on several devices: {sorted(kinds)}")
    return kinds.pop() if kinds else "cpu"


class _Graph(nn.Module):
    def __init__(self, graph):
        super().__init__()
        self.graph_module = graph

    def forward(self, *args):
        return self.graph_module(*args)


def _plain_table() -> dict:
    """Every ``tpme::`` op → its plain version."""
    from . import kernels

    for module in OP_MODULES:
        importlib.import_module(module)
    return {getattr(torch.ops.tpme, name).default: fn
            for name, fn in kernels.PLAIN_VERSIONS.items()}


def _trace(step: _Step, args, plain: bool):
    """The exported program of ``step`` at ``args``, with each ``tpme::`` op
    replaced by its plain version when ``plain``.  The step is traced once
    with ``make_fx`` on fake tensors first: autograd runs there, so the
    graph holds the backward as operators (the custom ops' registered VJPs
    among them, or their plain versions), and ``torch.export`` then traces a
    graph free of autograd.  (Exported in one pass, an in-graph
    ``torch.autograd.grad`` through any operator whose backward reads its own
    output — ``exp``, ``sqrt``, ``rsqrt`` — leaves a fake tensor among the
    program's constants, on torch 2.13.)"""
    from torch.fx.experimental.proxy_tensor import make_fx

    graph = make_fx(step, decomposition_table=_plain_table() if plain else None,
                    tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    return torch.export.export(_Graph(graph), tuple(args), strict=False)


def _export_one(step: _Step, args, platform: str) -> bytes:
    device = torch.device(platform)
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    # a CPU program takes the plain versions: ATen operators only
    program = _trace(step, args, plain=platform == "cpu")
    left = sorted({str(n.target) for n in program.graph.nodes if _is_tpme(n)})
    if platform == "cpu" and left:
        raise RuntimeError(f"the CPU program still calls {left}")
    for node in program.graph.nodes:
        # the second trace's stack traces all point at _Graph.forward
        node.meta.pop("stack_trace", None)
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def _is_tpme(node) -> bool:
    target = getattr(node.target, "namespace", None)
    return node.op == "call_function" and target == "tpme"


def export_step(
    fn: Callable,
    *example_args,
    with_grad: int | Sequence[int] | None = None,
    platforms: Sequence[str] | None = None,
) -> bytes:
    """Serialise ``fn`` (``torch.export``) traced at ``example_args``.

    :param fn: a function of tensor arguments (typically a closure over a
        calculator or :class:`~torchpme_tpu_torch.md.MDFastPath`) returning
        a tensor.
    :param example_args: tensors fixing the traced shapes and dtypes.
    :param with_grad: an argument index or a tuple of them: the artifact then
        returns ``(value, grads)``, as ``jax.value_and_grad(fn,
        argnums=with_grad)`` does — e.g. the energy and minus the forces for
        an MD engine (``value`` must be a scalar).
    :param platforms: ``"cpu"`` and/or ``"cuda"``; defaults to the device of
        ``example_args``.  With two, the artifact holds one program for each
        (the arguments are moved to each device, so ``fn`` must run on
        both).  ``"cuda"`` without a card raises.
    :return: the serialised bytes: for the CPU alone what
        :func:`torch.export.save` writes (it loads with ``torch.export.load``
        alone); otherwise a zip of one such archive a platform and, for
        ``"cuda"``, the op library (the module's torch-only recipe).
    """
    if platforms is None:
        platforms = (_platform_of(example_args),)
    platforms = tuple(platforms)
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown or not platforms or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms must be distinct names of {PLATFORMS}, got {platforms}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("exporting for 'cuda' needs a CUDA device, and none is available")
    argnums = tuple(with_grad) if isinstance(with_grad, (tuple, list)) else with_grad
    step = _Step(fn, argnums)
    if platforms == ("cpu",):
        return _export_one(step, example_args, "cpu")
    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w") as archive:
        archive.writestr(_INDEX, json.dumps(list(platforms)))
        for platform in platforms:
            archive.writestr(f"{platform}.pt2", _export_one(step, example_args, platform))
        if "cuda" in platforms:
            from . import kernels

            archive.writestr(LIBRARY, kernels.load_library().path.read_bytes())
            archive.writestr(LIBRARY_INFO, json.dumps(
                {"torch": torch.__version__, "arch": kernels.ARCH}))
    return buffer.getvalue()


def _programs(data: bytes) -> dict:
    """``{platform or None: program bytes}`` of an artifact (``None``: a
    single program, which names its platform in its inputs)."""
    with zipfile.ZipFile(io.BytesIO(data)) as archive:
        if _INDEX not in archive.namelist():
            return {None: data}
        return {p: archive.read(f"{p}.pt2") for p in json.loads(archive.read(_INDEX))}


def _calls_tpme(data: bytes) -> bool:
    """Whether a program of the artifact calls a ``tpme::`` op (its graph, a
    JSON member of the program's archive, names it)."""
    for program in _programs(data).values():
        with zipfile.ZipFile(io.BytesIO(program)) as archive:
            if any(b"torch.ops.tpme." in archive.read(name)
                   for name in archive.namelist() if name.endswith(".json")):
                return True
    return False


def _load_library(data: bytes) -> None:
    """Load the op library a CUDA artifact carries, once per process: where
    ``tpme::`` ops are already defined (this package's library, another
    artifact's) it is not loaded again, since a second ``TORCH_LIBRARY(tpme)``
    aborts the process.  Raises on a torch version or a device the library
    was not built for."""
    with zipfile.ZipFile(io.BytesIO(data)) as archive:
        library, info = archive.read(LIBRARY), json.loads(archive.read(LIBRARY_INFO))
    if info["torch"] != torch.__version__:
        raise RuntimeError(
            f"the artifact's kernel library was built for torch {info['torch']}, and this "
            f"process has torch {torch.__version__}: export the step again with this torch"
        )
    if not torch.cuda.is_available():
        raise RuntimeError("the artifact's CUDA program needs a CUDA device, and none is available")
    capability = torch.cuda.get_device_capability()
    if info["arch"] != f"sm_{capability[0]}{capability[1]}a":
        raise RuntimeError(
            f"the artifact's kernel library was built for {info['arch']}, and this device "
            f"({torch.cuda.get_device_name()}) has compute capability "
            f"{capability[0]}.{capability[1]}"
        )
    if hasattr(torch.ops.tpme, "launch_counts"):
        return
    with tempfile.NamedTemporaryFile(suffix=".so") as f:
        f.write(library)
        f.flush()
        torch.ops.load_library(f.name)


def _load_program(data: bytes):
    with warnings.catch_warnings():
        # torch's reader warns of its own read-only byte buffers (copied to
        # the device at once) and of constants that share one storage
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        warnings.filterwarnings("ignore", message="No complete tensor found in the group")
        return torch.export.load(io.BytesIO(data))


def _input_specs(program) -> list:
    """``(shape, dtype, device type)`` of each user input of ``program``."""
    names = set(program.graph_signature.user_inputs)
    return [
        (tuple(node.meta["val"].shape), node.meta["val"].dtype, node.meta["val"].device.type)
        for node in program.graph.nodes
        if node.op == "placeholder" and node.name in names
    ]


def load_step(data: bytes) -> Callable:
    """Deserialise an :func:`export_step` artifact into a callable.

    The callable runs the program of its arguments' device at the exact
    shapes and dtypes it was traced at: other shapes or dtypes, or a device
    the artifact holds no program for, raise.  A CUDA program's ``tpme::``
    ops come from the op library the artifact carries (:func:`_load_library`),
    so nothing of this package is imported.
    """
    programs = _programs(data)
    if "cuda" in programs:
        _load_library(data)
    runners = {}
    for blob in programs.values():
        program = _load_program(blob)
        specs = _input_specs(program)
        platform = specs[0][2] if specs else "cpu"
        runners[platform] = (program.module(), specs)

    def step(*args):
        platform = _platform_of(args)
        if platform not in runners:
            raise ValueError(
                f"the artifact holds programs for {sorted(runners)}, not for {platform!r}"
            )
        module, specs = runners[platform]
        if len(args) != len(specs):
            raise TypeError(f"the step takes {len(specs)} arguments, got {len(args)}")
        for i, (arg, (shape, dtype, _)) in enumerate(zip(args, specs)):
            if tuple(arg.shape) != shape or arg.dtype != dtype:
                raise ValueError(
                    f"argument {i} is {arg.dtype} of shape {tuple(arg.shape)}; the step was "
                    f"exported at {dtype} of shape {shape} (shape mismatch)"
                )
        return module(*args)

    return step
