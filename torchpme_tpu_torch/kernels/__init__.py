"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``torchpme_tpu_torch/csrc/*.cu`` with a plain C
interface.  :func:`load_library` compiles them with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and links one shared library
at first use (cached under ``_build/`` by a hash of the sources and flags),
then binds it with ``ctypes``.  Nothing here touches
CUDA at import time: the CPU tests import every module.

Each kernel has a :class:`LaunchCounter` that its wrapper (beside the
kernel's plain PyTorch twin, in ``ops/``) bumps by one per launch and
nowhere else, so a run can show that the main path went through it.

Every kernel is a ``tpme::`` custom op (``torch.ops.tpme.*``) with fake and
vmap registrations, and autograd where its output is differentiated, so
:mod:`torch.export` traces the paths through them
(:mod:`torchpme_tpu_torch.deploy`).  Kernels D, E and F take a
batch of systems in one launch (the vmap rules of their ops in
``ops/mesh_kernels.py``); A, B, C and G have no vmap rule yet: their entry
points refuse batched tensors (:func:`refuse_batched`), and so do their ops'
vmap registrations (:func:`refuse_vmap`).

The launch counters are bumped inside the ops' CUDA bodies, so a launch made
from an exported program counts too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = [
    "COUNTERS",
    "PLAIN_VERSIONS",
    "LaunchCounter",
    "MeshParams",
    "SpreadParams",
    "WindowDipoleParams",
    "WindowMember",
    "WindowParams",
    "check_cuda_tensor",
    "check_status",
    "custom_op",
    "host_values",
    "is_batched",
    "is_tracing",
    "launch_counts",
    "load_library",
    "op_function",
    "refuse_batched",
    "refuse_vmap",
    "reset_launch_counts",
    "stream_handle",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

MAX_NODES = 8  # csrc/spread.cu: coefficient table rows/cols
N_OFFSETS = 14  # csrc/window.cu, csrc/window_dipole.cu: half-window offsets + the self cell
MAX_CHANNELS = 4  # csrc/window.cu: per-thread charge-channel registers
MAX_MEMBERS = 4  # csrc/window.cu: pair terms of a combined potential
#: csrc/window.cu: first row of the members' energies in the accumulator
#: (after the energy, the 14 × 3 d_offs sums and the block counter)
WINDOW_MEMBER_ROW = 2 + 3 * N_OFFSETS
#: csrc/window.cu: first of the 3 × 3 rows of the image term of the cell gradient
WINDOW_IMAGE_ROW = WINDOW_MEMBER_ROW + MAX_MEMBERS


@dataclass
class LaunchCounter:
    """Number of launches of one kernel since the last reset."""

    name: str
    launches: int = 0


SPREAD_FWD = LaunchCounter("spread_fwd")
SPREAD_BWD = LaunchCounter("spread_bwd")
WINDOW = LaunchCounter("window")
#: kernel C's split variant: separate i-side charges (the x-slab sharded window)
WINDOW_SPLIT = LaunchCounter("window_split")
MESH_SPREAD = LaunchCounter("mesh_spread")
MESH_GATHER = LaunchCounter("mesh_gather")
MESH_WGRAD = LaunchCounter("mesh_wgrad")
WINDOW_DIPOLE = LaunchCounter("window_dipole")
COUNTERS = (
    SPREAD_FWD, SPREAD_BWD, WINDOW, WINDOW_SPLIT, MESH_SPREAD, MESH_GATHER, MESH_WGRAD,
    WINDOW_DIPOLE,
)


def reset_launch_counts() -> None:
    for counter in COUNTERS:
        counter.launches = 0


def launch_counts() -> dict[str, int]:
    return {counter.name: counter.launches for counter in COUNTERS}


class SpreadParams(ctypes.Structure):
    """Mirror of ``struct SpreadParams`` in ``csrc/spread.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("nodes", ctypes.c_int),
        ("extent", ctypes.c_int),
        ("lpad", ctypes.c_int),
        ("ty_count", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("kp", ctypes.c_int),
        ("n_ch", ctypes.c_int),
        ("z_cells", ctypes.c_int),
        ("z_chunk", ctypes.c_int),
        ("bwd_z_chunk", ctypes.c_int),
        ("coeff", ctypes.c_float * (MAX_NODES * MAX_NODES)),
        ("deriv", ctypes.c_float * (MAX_NODES * MAX_NODES)),
    ]


class WindowMember(ctypes.Structure):
    """Mirror of ``struct WindowMember`` in ``csrc/window.cu``: one ``1/r^p``
    pair term."""

    _fields_ = [
        ("p", ctypes.c_int),
        ("alpha", ctypes.c_float),
        ("alpha_sq", ctypes.c_float),
        ("prefactor", ctypes.c_float),
        ("c_gauss", ctypes.c_float),
    ]


class WindowParams(ctypes.Structure):
    """Mirror of ``struct WindowParams`` in ``csrc/window.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("n_ch", ctypes.c_int),
        ("self_k", ctypes.c_int),
        ("group", ctypes.c_int),
        ("direct", ctypes.c_int),
        ("kind", ctypes.c_int),
        ("n_members", ctypes.c_int),
        ("cutoff_sq", ctypes.c_float),
        ("members", WindowMember * MAX_MEMBERS),
        ("offsets", ctypes.c_int * (3 * N_OFFSETS)),
    ]


class WindowDipoleParams(ctypes.Structure):
    """Mirror of ``struct WindowDipoleParams`` in ``csrc/window_dipole.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("self_k", ctypes.c_int),
        ("direct", ctypes.c_int),
        ("warps", ctypes.c_int),
        ("cutoff_sq", ctypes.c_float),
        ("alpha", ctypes.c_float),
        ("sqrt_alpha", ctypes.c_float),
        ("prefactor", ctypes.c_float),
        ("c_gauss", ctypes.c_float),
        ("offsets", ctypes.c_int * (3 * N_OFFSETS)),
    ]


class MeshParams(ctypes.Structure):
    """Mirror of ``struct MeshParams`` in ``csrc/mesh.cu``."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("nodes", ctypes.c_int),
        ("extent", ctypes.c_int),
        ("ty_count", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("n_ch", ctypes.c_int),
        ("z_chunk", ctypes.c_int),
        ("n_sys", ctypes.c_int),
        ("slot_stride", ctypes.c_longlong),
        ("val_stride", ctypes.c_longlong),
        ("mesh_stride", ctypes.c_longlong),
    ]


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
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


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.tpme_error_string.argtypes = [ctypes.c_int]
    lib.tpme_error_string.restype = ctypes.c_char_p
    lib.tpme_max_smem_optin.argtypes = [ctypes.c_int]
    lib.tpme_max_smem_optin.restype = ctypes.c_int
    lib.tpme_spread_fwd.argtypes = [p, p, p, ctypes.POINTER(SpreadParams), p]
    lib.tpme_spread_fwd.restype = ctypes.c_int
    lib.tpme_spread_bwd.argtypes = [p, p, p, p, p, ctypes.POINTER(SpreadParams), p]
    lib.tpme_spread_bwd.restype = ctypes.c_int
    lib.tpme_window.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, ctypes.POINTER(WindowParams), p,
    ]
    lib.tpme_window.restype = ctypes.c_int
    lib.tpme_window_group.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpme_window_group.restype = ctypes.c_int
    lib.tpme_window_max_cap.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpme_window_max_cap.restype = ctypes.c_int
    lib.tpme_window_dipole.argtypes = [
        p, p, p, p, p, p, p, p, p, p, ctypes.POINTER(WindowDipoleParams), p,
    ]
    lib.tpme_window_dipole.restype = ctypes.c_int
    lib.tpme_window_dipole_warps.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpme_window_dipole_warps.restype = ctypes.c_int
    lib.tpme_window_dipole_max_cap.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpme_window_dipole_max_cap.restype = ctypes.c_int
    lib.tpme_mesh_spread.argtypes = [p, p, p, p, p, p, p, ctypes.POINTER(MeshParams), p]
    lib.tpme_mesh_spread.restype = ctypes.c_int
    lib.tpme_mesh_gather_wgrad.argtypes = [
        p, p, p, p, p, p, p, p, p, p, ctypes.POINTER(MeshParams), p,
    ]
    lib.tpme_mesh_gather_wgrad.restype = ctypes.c_int


def _build(sources: list[Path], path: Path) -> tuple[float, str]:
    """Compile every source to an object file, all at once, and link them
    into ``path``; returns (seconds, compiler output)."""
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        outputs = [proc.communicate()[0] for proc in procs]
        log = "".join(outputs)
        for proc, src in zip(procs, sources):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {src.name}:\n{log}"
                )
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True, check=False,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, path)
    finally:
        for leftover in (*objects, tmp):
            leftover.unlink(missing_ok=True)
    return time.perf_counter() - start, log


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Compile ``csrc/*.cu`` (once per source hash) and load the library."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"libtpme_kernels_{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_seconds, log = _build(sources, path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return KernelLibrary(lib, path, build_seconds, log)


def check_status(status: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if status != 0:
        msg = load_library().lib.tpme_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {status} ({msg})")


def check_cuda_tensor(t: torch.Tensor, name: str, shape, dtype=torch.float32):
    """Validate a kernel operand: on a CUDA device, of ``dtype``, of
    ``shape``, contiguous.  Raises on anything the kernel does not take."""
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


def refuse_vmap(op, what: str) -> None:
    """Register ``op``'s vmap rule as the refusal of :func:`refuse_batched`,
    so a batch reaching the op by any entry point raises the same error."""

    def rule(info, in_dims, *args):
        raise NotImplementedError(_refusal(what))

    op.register_vmap(rule)


#: The plain version of every ``tpme::`` op, by op name: its body with
#: ``plain=True``, which :func:`torchpme_tpu_torch.deploy.export_step` puts
#: in place of the op in a CPU program.
PLAIN_VERSIONS: dict = {}


def custom_op(name: str):
    """``torch.library.custom_op("tpme::<name>")`` for a function whose last
    argument is ``plain: bool`` (its plain version on any device), which is
    also recorded in :data:`PLAIN_VERSIONS`."""

    def wrap(fn):
        op = torch.library.custom_op(f"tpme::{name}", mutates_args=())(fn)
        signature = inspect.signature(fn)

        def plain_version(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.arguments["plain"] = True
            return fn(*bound.args, **bound.kwargs)

        PLAIN_VERSIONS[name] = plain_version
        return op

    return wrap


def op_function(name: str, op, setup_context, backward) -> type:
    """The differentiable entry to a custom op: an ``autograd.Function`` of
    the ``setup_context`` form that runs the op under ``no_grad`` and the
    same VJP (``setup_context``, ``backward``: the functions given to the
    op's ``register_autograd``).  ``torch.func.grad`` refuses the autograd
    that custom ops register (torch builds it as an ``autograd.Function``
    without ``setup_context``) and takes this one; ``make_fx`` traces it into
    the op and its VJP's ops (:mod:`torchpme_tpu_torch.deploy`).  Its vmap
    rule is generated, so under ``vmap`` the op's own rule applies."""

    def forward(*inputs):
        # the Function records the graph; the op must not record its own
        with torch.no_grad():
            return op(*inputs)

    return type(name, (torch.autograd.Function,), {
        "generate_vmap_rule": True,
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(torch.autograd.function.once_differentiable(backward)),
    })


def stream_handle(device: torch.device) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
