"""Build, load and count the port's hand-written CUDA kernels, the
``tpme::`` operators.

The kernels live in ``torchpme_tpu_torch/csrc/*.cu`` with a plain C
interface.  Their host layer is C++ too: ``csrc/tpme_ops.cpp`` defines the
``tpme::`` ops (``torch.ops.tpme.*``) with ``TORCH_LIBRARY`` from the schemas
of ``csrc/tpme_ops.h``, and gives each a Meta kernel (its output shapes) and a
CUDA kernel, which checks the operands, builds the kernel's parameters,
allocates the outputs, launches on PyTorch's current stream and counts the
launch.  :func:`load_library` compiles the ``.cu`` files with ``nvcc`` for
``sm_90a`` and ``tpme_ops.cpp`` with the host compiler against torch's
headers (one compiler per source, all started together), links one shared
library at first use (cached under ``_build/`` by a hash of the sources, the
flags and the torch version) and loads it with ``torch.ops.load_library``.
A process that loads that library has the ops and their kernels with
``torch`` alone, which is how an exported CUDA program runs
(:mod:`torchpme_tpu_torch.deploy` puts the library into the artifact).

:func:`define_ops` gives the ops their schemas once per process: the library
where a card is present, and where none is (the CPU tests) the same schemas
defined from ``tpme_ops.h`` in Python, with their fake kernels, and nothing
built.  The ``ops/`` modules then register on the ops by name what is
Python: each op's plain version as its CPU kernel (:data:`PLAIN_VERSIONS`),
the autograd of the differentiable ones, and the vmap rules (kernels D, E and
F take a batch of systems in one launch; A, B, C and G have none yet, and
their ops refuse a batch, :func:`refuse_vmap`, as their entry points do,
:func:`refuse_batched`).  Nothing here touches CUDA at import time: the CPU
tests import every module.

The launch counters are C++ atomics bumped in the ops' CUDA kernels, one per
kernel and kernel C's split variant apart, so a launch from an exported
program counts too; :func:`launch_counts` reads them through
``tpme::launch_counts``.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = [
    "COUNTER_NAMES",
    "PLAIN_VERSIONS",
    "call",
    "check_cuda_tensor",
    "define_ops",
    "host_values",
    "is_batched",
    "is_tracing",
    "launch_counts",
    "load_library",
    "op_function",
    "op_schemas",
    "override_z_chunk",
    "plain_version",
    "register_autograd",
    "refuse_batched",
    "refuse_vmap",
    "register_fake",
    "reset_launch_counts",
    "tpme_op",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: the header both definitions of the ops read their schemas from
SCHEMA_HEADER = CSRC_DIR / "tpme_ops.h"
ARCH = "sm_90a"  # Hopper with its architecture-specific features (H100)
ARCH_FLAGS = ("-gencode", f"arch=compute_{ARCH[3:]},code={ARCH}")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

N_OFFSETS = 14  # csrc/window.cu, csrc/window_dipole.cu: half-window offsets + the self cell
MAX_CHANNELS = 4  # csrc/window.cu: per-thread charge-channel registers
MAX_MEMBERS = 4  # csrc/window.cu: pair terms of a combined potential


# -- the schemas ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _header() -> tuple[dict, tuple]:
    text = SCHEMA_HEADER.read_text()
    ops = dict(re.findall(r'^TPME_OP\((\w+), "([^"]*)"\)', text, flags=re.M))
    counters = tuple(re.findall(r"^TPME_COUNTER\((\w+)\)", text, flags=re.M))
    return ops, counters


def op_schemas() -> dict[str, str]:
    """Every ``tpme::`` op's schema by name, as ``csrc/tpme_ops.h`` gives it."""
    return dict(_header()[0])


#: the launch counters, in the order ``tpme::launch_counts`` returns them
COUNTER_NAMES: tuple[str, ...] = _header()[1]


# -- the build ----------------------------------------------------------------------


@dataclass(frozen=True)
class KernelLibrary:
    """The op library and how it was obtained."""

    path: Path
    build_seconds: float  # 0.0 when the cached library was reused
    build_log: str


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from torchpme_tpu_torch/csrc at first use"
    )


def host_compiler() -> str | None:
    """The C++ compiler for ``tpme_ops.cpp``: ``$CXX``, else ``c++`` or
    ``g++`` on the path (``None`` where there is none)."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


def _cxx_standard() -> str:
    """The C++ standard of the installed torch's own extension builds (its
    headers need it)."""
    import torch.utils.cpp_extension as ext

    return "c++20" if "-std=c++20" in Path(ext.__file__).read_text() else "c++17"


def torch_flags(cuda: bool) -> tuple[list[str], list[str]]:
    """``(compile, link)`` flags of ``tpme_ops.cpp`` against the installed
    torch: its headers, its C++ ABI and standard, its libraries; with
    ``cuda`` the CUDA section and the toolkit's headers (beside ``nvcc``)."""
    import torch.utils.cpp_extension as ext

    compile_flags = [
        f"-std={_cxx_standard()}", "-O2", "-fPIC", "-ffp-contract=off",
        f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
        *(f"-I{p}" for p in ext.include_paths()),
    ]
    libs = ["torch", "torch_cpu", "c10"]
    if cuda:
        compile_flags += ["-DTPME_WITH_CUDA", f"-I{Path(_nvcc()).parent.parent / 'include'}"]
        libs += ["torch_cuda", "c10_cuda"]
    link_flags = [*(f"-L{p}" for p in ext.library_paths()), *(f"-l{lib}" for lib in libs)]
    return compile_flags, link_flags


def _run_all(commands: list[list[str]]) -> str:
    """Run the compilers at once; raise with their output when one fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [proc.communicate()[0] for proc in procs]
    log = "".join(outputs)
    for proc, cmd in zip(procs, commands):
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}) on "
                               f"{cmd[-1]}:\n{log}")
    return log


def _build(path: Path, cuda: bool) -> tuple[float, str]:
    """Compile every source to an object file, all at once, and link them
    into ``path``; returns (seconds, compiler output).  Without ``cuda`` only
    the host part of ``tpme_ops.cpp`` (schemas, Meta kernels, parameter
    builders)."""
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found ($CXX, c++, g++) for csrc/tpme_ops.cpp")
    compile_flags, link_flags = torch_flags(cuda)
    tag = f"{path.stem}.{os.getpid()}"
    host_src = CSRC_DIR / "tpme_ops.cpp"
    host_obj = BUILD_DIR / f"{tag}.tpme_ops.o"
    commands = [[cxx, *compile_flags, "-c", "-o", str(host_obj), str(host_src)]]
    objects = [host_obj]
    if cuda:
        nvcc = _nvcc()
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            objects.append(obj)
            commands.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    try:
        log = _run_all(commands)
        linker = [_nvcc(), *ARCH_FLAGS, "-shared"] if cuda else [cxx, "-shared"]
        link = subprocess.run([*linker, "-o", str(tmp), *map(str, objects), *link_flags],
                              capture_output=True, text=True, check=False)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"link failed ({link.returncode}):\n{log}")
        os.replace(tmp, path)
    finally:
        for leftover in (*objects, tmp):
            leftover.unlink(missing_ok=True)
    return time.perf_counter() - start, log


def build_library(cuda: bool = True) -> KernelLibrary:
    """Build the op library (once per hash of the sources, the flags and the
    torch version) without loading it: with ``cuda`` the kernels and their
    CUDA ops, else the host part alone (which a CPU test builds)."""
    sources = sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cpp"), *CSRC_DIR.glob("*.h")])
    digest = hashlib.sha256(f"{torch.__version__} {cuda} {' '.join(NVCC_FLAGS)}".encode())
    digest.update(" ".join(torch_flags(False)[0]).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    name = "libtpme_ops" if cuda else "libtpme_ops_host"
    path = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_seconds, log = _build(path, cuda)
    return KernelLibrary(path, build_seconds, log)


def _defined_in_cpp() -> bool:
    """Whether a ``tpme`` op library is loaded in this process (this
    package's, or the copy an exported artifact carries)."""
    return not _PY_LIBRARIES and hasattr(torch.ops.tpme, "launch_counts")


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build the op library with its kernels (once per source hash) and load
    it: the ``tpme::`` ops with their CUDA and Meta kernels.  Where a copy is
    already loaded (an artifact's) the build is not loaded again: a second
    ``TORCH_LIBRARY(tpme)`` would abort the process."""
    if _PY_LIBRARIES:
        raise RuntimeError("the tpme ops are defined in Python in this process (no card "
                           "was found when they were first used): the library cannot load")
    built = build_library(cuda=True)
    if not _defined_in_cpp():
        torch.ops.load_library(str(built.path))
    return built


#: the Python definitions where no library is loaded (kept alive: a
#: ``Library`` unregisters what it holds when collected)
_PY_LIBRARIES: list = []


def _define_in_python() -> None:
    """The ops of ``tpme_ops.h`` defined in Python, for a process without
    the library: their CPU kernels are the plain versions the ``ops/``
    modules register, the counters read zero, and the kernel queries
    raise."""
    lib = torch.library.Library("tpme", "DEF")
    _PY_LIBRARIES.append(lib)
    for schema in op_schemas().values():
        lib.define(schema)

    def no_card(*_):
        raise RuntimeError("the tpme kernels need the op library, which is built on a CUDA card")

    no_tensor = {
        "launch_counts": lambda: [0] * len(COUNTER_NAMES),
        "reset_launch_counts": lambda: None,
        "window_plan": no_card,
        "window_dipole_plan": no_card,
        "override_z_chunk": no_card,
    }
    for name, fn in no_tensor.items():
        lib.impl(name, fn, "CompositeExplicitAutograd")


@functools.lru_cache(maxsize=None)
def define_ops() -> bool:
    """Give the ``tpme::`` ops their schemas, once per process; returns
    whether they come from the C++ library.  A loaded library (this
    package's or an artifact's) is kept; on a machine with a card the library
    is built (at first use) and loaded; elsewhere the schemas of
    ``tpme_ops.h`` are defined in Python."""
    if _defined_in_cpp():
        return True
    if torch.cuda.is_available():
        load_library()
        return True
    _define_in_python()
    return False


def tpme_op(name: str):
    """The ``torch.ops.tpme.<name>.default`` overload (the ops defined)."""
    define_ops()
    return getattr(torch.ops.tpme, name).default


def override_z_chunk(kernel: str, z_chunk: int | None) -> int:
    """Hold the z chunk of kernel A (``"spread_fwd"``), B (``"spread_bwd"``)
    or E and F (``"mesh_gather"``) at ``z_chunk`` for the launches that
    follow (0: the one-thread-a-slot form of B, E and F), ``None`` for the
    rule again; returns the override it replaces (-1: the rule)."""
    return tpme_op("override_z_chunk")(kernel, -1 if z_chunk is None else int(z_chunk))


# -- the launch counters -----------------------------------------------------------


def reset_launch_counts() -> None:
    tpme_op("reset_launch_counts")()


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset, by counter name."""
    return dict(zip(COUNTER_NAMES, tpme_op("launch_counts")()))


# -- the Python registrations on the ops ------------------------------------------


#: Every ``tpme::`` kernel op's plain version, by op name, with the op's
#: signature: the op's CPU kernel, the body of an entry point's ``plain=True``
#: on any device, and what :func:`torchpme_tpu_torch.deploy.export_step` puts
#: in place of the op in a CPU program.
PLAIN_VERSIONS: dict = {}

_IMPLS: list = []


def plain_version(name: str):
    """Record ``fn`` as op ``name``'s plain version and register it as the
    op's CPU kernel."""

    def wrap(fn):
        define_ops()
        if not _IMPLS:
            _IMPLS.append(torch.library.Library("tpme", "IMPL"))
        _IMPLS[0].impl(name, fn, "CPU")
        PLAIN_VERSIONS[name] = fn
        return fn

    return wrap


def register_fake(name: str):
    """Register ``fn`` as op ``name``'s fake kernel where the ops are defined
    in Python; the library's Meta kernels serve where it is loaded."""

    def wrap(fn):
        if not define_ops():
            torch.library.register_fake(f"tpme::{name}", fn)
        return fn

    return wrap


def check_cuda_tensor(t: torch.Tensor, name: str, shape, dtype=torch.float32):
    """Validate a kernel operand: on a CUDA device, of ``dtype``, of
    ``shape``, contiguous.  Raises on anything the kernel does not take (the
    ops' CUDA kernels check the same in C++, with the same messages)."""
    if t.dtype != dtype:
        raise TypeError(
            f"{name} is {t.dtype}; the CUDA kernels take {dtype} only"
        )
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def is_batched(*tensors) -> bool:
    """Whether any of ``tensors`` carries a ``torch.func.vmap`` batch
    dimension (at any level of nested transforms).  Inside ``vmap`` a tensor
    looks unbatched to shape queries, and its values cannot be read on the
    host, so code that reads values (a tile capacity, a validity flag, a mesh
    size) asks this first."""
    from torch._C import _functorch

    for t in tensors:
        while isinstance(t, torch.Tensor) and _functorch.is_functorch_wrapped_tensor(t):
            if _functorch.is_batchedtensor(t):
                return True
            t = _functorch.get_unwrapped(t)
    return False


def is_tracing() -> bool:
    """Whether ``make_fx`` traces a graph (as :mod:`torchpme_tpu_torch.deploy`
    does): values cannot be read on the host then, so a check that would
    read one (a stale bucketing, a tile overflow) poisons the result with
    NaN instead, as under ``vmap``."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    return get_proxy_mode() is not None


def host_values(t: torch.Tensor):
    """The values of ``t`` as a numpy array, read through any
    ``torch.func.grad``-style wrappers (not through ``vmap``, whose batch has
    no single value: that raises)."""
    from torch._C import _functorch

    while _functorch.is_functorch_wrapped_tensor(t):
        if _functorch.is_batchedtensor(t):
            raise ValueError("a batched tensor has no single value to read")
        t = _functorch.get_unwrapped(t)
    with torch._C._DisableFuncTorch():
        return t.detach().cpu().numpy()


def _refusal(what: str) -> str:
    return (
        f"{what} does not run under torch.func.vmap yet: kernels A, B, C and G "
        "have no vmap rule (ROADMAP.md §2, column 'vmap rule'). Batch the "
        "per-atom calculators over a neighbor list instead (the tiled or "
        "scatter mesh, kernels D, E, F)."
    )


def refuse_batched(what: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when ``what`` (a path through kernel A,
    B, C or G) is called under ``torch.func.vmap``: those kernels have no vmap
    rule yet, and no other route stands in for them."""
    if is_batched(*tensors):
        raise NotImplementedError(_refusal(what))


def refuse_vmap(name: str, what: str) -> None:
    """Register op ``name``'s vmap rule as the refusal of
    :func:`refuse_batched`, so a batch reaching the op by any entry point
    raises the same error."""

    def rule(info, in_dims, *args):
        raise NotImplementedError(_refusal(what))

    torch.library.register_vmap(f"tpme::{name}", rule)


def call(name: str, *args, plain: bool = False):
    """Op ``name`` on ``args``, or with ``plain`` its plain version on any
    device (the reference path of the comparisons; float64 on a card)."""
    return PLAIN_VERSIONS[name](*args) if plain else tpme_op(name)(*args)


def _split_plain(inputs) -> tuple[tuple, bool, bool]:
    """``(op arguments, plain, whether plain was given)`` of an
    :func:`op_function`'s inputs: a trailing ``bool`` is ``plain`` (no op
    ends with a ``bool`` argument)."""
    if inputs and type(inputs[-1]) is bool:
        return tuple(inputs[:-1]), inputs[-1], True
    return tuple(inputs), False, False


def op_function(name: str, op_name: str, setup_context, backward) -> type:
    """The differentiable entry to op ``op_name``: an ``autograd.Function``
    of the ``setup_context`` form, ``apply(*op_args[, plain])``, that runs
    the op (with ``plain`` its plain version, :func:`call`) under
    ``no_grad`` and the same VJP (``setup_context``, ``backward``: the
    functions given to the op's :func:`register_autograd`, which find
    ``ctx.plain``).  ``torch.func.grad`` refuses the autograd registered on
    an op (torch builds it as an ``autograd.Function`` without
    ``setup_context``) and takes this one; ``make_fx`` traces it into the op
    and its VJP's ops (:mod:`torchpme_tpu_torch.deploy`).  Its vmap rule is
    generated, so under ``vmap`` the op's own rule applies."""

    def forward(*inputs):
        args, plain, _ = _split_plain(inputs)
        # the Function records the graph; the op must not record its own
        with torch.no_grad():
            return call(op_name, *args, plain=plain)

    def setup(ctx, inputs, output):
        args, plain, given = _split_plain(inputs)
        setup_context(ctx, args, output)
        ctx.plain, ctx.plain_given = plain, given

    def vjp(ctx, *cts):
        grads = tuple(backward(ctx, *cts))
        return (*grads, None) if ctx.plain_given else grads

    return type(name, (torch.autograd.Function,), {
        "generate_vmap_rule": True,
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup),
        "backward": staticmethod(torch.autograd.function.once_differentiable(vjp)),
    })


def register_autograd(name: str, backward, setup_context) -> None:
    """Register op ``name``'s autograd; a direct call of the op is never the
    plain version (``ctx.plain`` False)."""

    def setup(ctx, inputs, output):
        setup_context(ctx, inputs, output)
        ctx.plain = False

    torch.library.register_autograd(f"tpme::{name}", backward, setup_context=setup)


