"""Build the CUDA sources under ``ops/csrc/`` with ``nvcc`` and load them.

No counterpart in ``qrkit_tpu`` (Pallas kernels compile inside ``jax.jit``).
Each source is compiled at first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
ctypes, its launchers' signatures set.  A library is keyed by its source,
its ``-D`` defines and a hash of the source text, the defines and the
flags, so an edited source never loads a stale library.  Libraries go under
``build/qrkit_tpu_torch/`` at the root of the checkout.

* ``blockdiag_qr.cu``: one library per block shape (br, bc), compiled with
  ``-DQRK_BR=br -DQRK_BC=bc`` so the per-thread recurrence unrolls fully
  into registers (:func:`build`, :func:`load`).
* ``banded_chain.cu``: one library for every shape; the banded kernels take
  their geometry as arguments (:func:`load_banded`).
* ``chain_apply.cu``: the banded family's two serial scans, the
  two-segment compact-WY apply (K1) and the blocked banded
  back-substitution (K2), in one launch or as the phases of their chunked
  forms, one library for every shape (:func:`load_chain`).
* ``graph_loop.cu``: the LM loop's condition kernel (L1), the stamp
  kernel a step runs inside the loop's body (L2) and the host functions
  that build a conditional WHILE graph around captured graphs, linked
  against the driver (``-lcuda``; :func:`load_graph_loop`).
* ``lm_step.cu``: the lane-major damped LM step (K3: one cooperative
  launch a step, its point pass, carries, last-CTA finish and per-point
  back-substitution), one library per step shape (bl, bc, m2), compiled
  with ``-DQRK_BL -DQRK_BC -DQRK_M2`` so a point's work unrolls into
  registers (:func:`build_lm_step`, :func:`load_lm_step`).
* ``ellipse_eval.cu``: the ellipse model's residuals, Jacobian and
  gradient (K4), one pass over the points each, one library for every
  shape (:func:`load_ellipse_eval`).
* ``tall_qr.cu``: the R-only tall-skinny QR of the ragged block-angular
  step's bottom (K5: panels, tiles and a tree of their R blocks), one
  library for every shape (:func:`load_tall_qr`).

Each launcher takes its operands' CUDA ordinal first, makes that device
current for the launch and the caller's device current again after it, so
the kernels run on any ``cuda:N`` and leave PyTorch's current device as it
was.  :func:`blockdiag_launcher` / :func:`banded_launcher` /
:func:`chain_launcher` / :func:`lm_step_launcher` /
:func:`ellipse_launcher` / :func:`tall_qr_launcher` bind a launcher
once (:class:`Launcher`); a call then costs one ctypes call and one read of
the device's current stream.

There is no fallback: a missing ``nvcc`` or a failed compile raises with
the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import torch

__all__ = [
    "NVCC_FLAGS", "Launcher", "banded_launcher", "blockdiag_launcher", "build",
    "build_lm_step", "build_source", "chain_launcher", "current_stream", "ellipse_launcher",
    "find_nvcc", "load", "load_banded", "load_chain", "load_ellipse_eval", "load_graph_loop",
    "load_lm_step", "load_source", "load_tall_qr",
    "lm_step_geometry", "lm_step_launcher", "tall_qr_launcher", "tall_qr_plan",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qrkit_tpu_torch"
_DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the CUDA toolkit's standard prefix

# --fmad=false: see the numerics notes in the csrc/ sources.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_DEV, _PTR, _I64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
BLOCKDIAG_SOURCE = "blockdiag_qr.cu"
BANDED_SOURCE = "banded_chain.cu"
CHAIN_SOURCE = "chain_apply.cu"
GRAPH_LOOP_SOURCE = "graph_loop.cu"
LM_STEP_SOURCE = "lm_step.cu"
ELLIPSE_SOURCE = "ellipse_eval.cu"
TALL_QR_SOURCE = "tall_qr.cu"
# libraries a source links besides the static CUDA runtime (after the source)
_LINK = {GRAPH_LOOP_SOURCE: ("-lcuda",)}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# launcher name -> argument types: the device ordinal, the kernel's own, the
# stream (each returns a cudaError_t as int)
_BLOCKDIAG_SIGNATURES = tuple(
    (f"qrk_blockdiag_{kind}_{dt}", (_DEV, *args, _PTR))
    for dt in ("f32", "f64")
    for kind, args in (
        ("lstsq", (_PTR, _PTR, _PTR, _I64)),
        ("lstsq_opt", (_PTR,) * 6 + (_I64,)),
        ("qr_r", (_PTR, _PTR, _I64)),
    )
)
_BLOCKDIAG_SIGNATURES += (("qrk_blockdiag_empty", (_DEV, _I64, _PTR)),)
_BANDED_SIGNATURES = tuple(
    (f"qrk_banded_{kind}_{dt}", (_DEV, *args, _PTR))
    for dt in ("f32", "f64")
    for kind, args in (
        ("segment_chains", (_PTR,) * 5 + (_I64,) * 8),
        ("chain_qr", (_PTR,) * 5 + (_I64,) * 7),
        ("apply_w", (_PTR,) * 5 + (_I64,) * 8),
    )
)
_CHAIN_SIGNATURES = tuple(
    (f"qrk_chain_{kind}_{dt}", (_DEV, *args, _PTR))
    for dt in ("f32", "f64")
    for kind, args in (
        ("two_seg", (_PTR,) * 6 + (_I64,) * 10),
        ("solve", (_PTR,) * 7 + (_I64,) * 9),
        ("two_seg_chunk", (_PTR,) * 12 + (_I64,) * 14),
        ("solve_chunk", (_PTR,) * 14 + (_I64,) * 13),
        ("join", (_PTR,) * 3 + (_I64,) * 4),
    )
)
_INT = ctypes.c_int
_LM_STEP_SIGNATURES = tuple(
    (f"qrk_lm_step_{dt}", (_DEV,) + (_PTR,) * 7 + (_I64, _PTR, _I64, _PTR) + (_I64,) * 3 + (_INT, _PTR))
    for dt in ("f32", "f64")
) + tuple((f"qrk_lm_geometry_{dt}", (_I64,) * 3 + (_PTR,)) for dt in ("f32", "f64")) + (
    ("qrk_lm_empty", (_DEV, _I64, _I64, _INT, _PTR)),
)
_ELLIPSE_SIGNATURES = tuple(
    (f"qrk_ellipse_{kind}_{dt}", (_DEV, *args, _PTR))
    for dt in ("f32", "f64")
    for kind, args in (
        ("residuals", (_PTR, _I64, _PTR, _I64, _I64, _PTR, _I64, _I64)),
        ("jacobian", (_PTR, _I64, _PTR, _I64, _I64, _PTR, _PTR, _PTR, _I64, _I64)),
        ("vjp", (_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I64, _I64)),
    )
)
_TALL_QR_SIGNATURES = tuple(
    (f"qrk_tall_qr_{dt}", (_DEV, _PTR, _I64, _I64, _I64, _PTR, _PTR, _PTR, _I64, _PTR))
    for dt in ("f32", "f64")
) + (("qrk_tall_qr_plan", (_I64, _I64, _PTR)),)
_GRAPH_LOOP_SIGNATURES = (
    ("qrk_loop_cond", (_DEV, _PTR, _I64, _PTR, _INT, _PTR, _PTR)),
    ("qrk_loop_build", (_DEV, _PTR, _PTR, _PTR, _PTR, _I64, _PTR, _INT, _PTR, _PTR, _PTR, _INT,
                        _PTR)),
    ("qrk_loop_mark", (_DEV, _PTR, _PTR, _INT, _INT, _INT, _PTR)),
    ("qrk_loop_launch", (_PTR, _PTR)),
    ("qrk_loop_destroy", (_PTR,)),
    ("qrk_versions", (_PTR, _PTR)),
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``$CUDA_PATH/bin``, ``PATH``,
    then the toolkit's standard prefix.  Raises RuntimeError if none has it."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    default = os.path.join(_DEFAULT_CUDA_HOME, "bin", "nvcc")
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, PATH and "
        f"{_DEFAULT_CUDA_HOME}/bin): the qrkit_tpu_torch CUDA kernels are "
        "built from source at first use and need the CUDA toolkit"
    )


def _library_path(source: str, defines: Tuple[Tuple[str, int], ...], tag: str) -> Path:
    h = hashlib.sha256((_CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS + _LINK.get(source, ())).encode())
    h.update(repr(defines).encode())
    return _BUILD_DIR / f"{Path(source).stem}{tag}_{h.hexdigest()[:16]}.so"


def build_source(source: str, defines: Tuple[Tuple[str, int], ...] = (), tag: str = "") -> Path:
    """Compile ``csrc/<source>`` with ``-D<name>=<value>`` for each of
    ``defines`` (cached on disk); returns the library's path.  ``tag`` goes
    into the library's file name.  An nvcc run is set-up part ``build``
    (:func:`qrkit_tpu_torch.profiling.setup_seconds`)."""
    from .. import profiling  # here: profiling imports the kernels, which import this

    out = _library_path(source, defines, tag)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines), "-o", tmp, str(_CSRC / source),
           *_LINK.get(source, ())]
    try:
        with profiling.span("qrk.setup.build", setup=True):
            proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {source}{tag}:\n"
                f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_source(
    source: str, defines: Tuple[Tuple[str, int], ...], signatures, tag: str = ""
) -> ctypes.CDLL:
    """Build (if needed) and load one library, with the ctypes argument
    types of each launcher in ``signatures`` (``(name, argtypes)`` pairs)
    set and ``qrk_error_string`` bound; the ``ctypes.CDLL`` is set-up part
    ``load``."""
    from .. import profiling  # here: profiling imports the kernels, which import this

    path = str(build_source(source, defines, tag))
    with profiling.span("qrk.setup.load", setup=True):
        lib = ctypes.CDLL(path)
    for name, argtypes in signatures:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.qrk_error_string.argtypes = [ctypes.c_int]
    lib.qrk_error_string.restype = ctypes.c_char_p
    return lib


def _blockdiag_defines(br: int, bc: int):
    return (("QRK_BR", int(br)), ("QRK_BC", int(bc))), f"_{br}x{bc}"


def build(br: int, bc: int) -> Path:
    """Compile the block-diagonal kernels for one block shape (cached on
    disk); returns the library's path."""
    return build_source(BLOCKDIAG_SOURCE, *_blockdiag_defines(br, bc))


def load(br: int, bc: int) -> ctypes.CDLL:
    """Build (if needed) and load the block-diagonal kernels for one block
    shape."""
    defines, tag = _blockdiag_defines(br, bc)
    return load_source(BLOCKDIAG_SOURCE, defines, _BLOCKDIAG_SIGNATURES, tag)


def _lm_step_defines(bl: int, bc: int, m2: int, extra=()):
    tag = f"_{bl}x{bc}x{m2}" + "".join(f"_{k.lower()}{v}" for k, v in extra)
    return (("QRK_BL", int(bl)), ("QRK_BC", int(bc)), ("QRK_M2", int(m2)), *extra), tag


def build_lm_step(bl: int, bc: int, m2: int, extra=()) -> Path:
    """Compile the damped-step kernels for one step shape (cached on
    disk); returns the library's path.  ``extra``: more ``(name, value)``
    defines, a measurement build's (``QRK_CTAS``, ``QRK_TRACE``,
    ``QRK_STAGE=0``: ``lm_step.cu``'s header)."""
    return build_source(LM_STEP_SOURCE, *_lm_step_defines(bl, bc, m2, extra))


def load_lm_step(bl: int, bc: int, m2: int, extra=()) -> ctypes.CDLL:
    """Build (if needed) and load the damped-step kernels for one step
    shape (``extra``: :func:`build_lm_step`)."""
    defines, tag = _lm_step_defines(bl, bc, m2, extra)
    return load_source(LM_STEP_SOURCE, defines, _LM_STEP_SIGNATURES, tag)


def load_banded() -> ctypes.CDLL:
    """Build (if needed) and load the banded-chain kernels (one library for
    every shape)."""
    return load_source(BANDED_SOURCE, (), _BANDED_SIGNATURES)


def load_chain() -> ctypes.CDLL:
    """Build (if needed) and load the chain-scan kernels K1 and K2 (one
    library for every shape)."""
    return load_source(CHAIN_SOURCE, (), _CHAIN_SIGNATURES)


def load_ellipse_eval() -> ctypes.CDLL:
    """Build (if needed) and load the ellipse model's kernels K4 (one
    library for every shape)."""
    return load_source(ELLIPSE_SOURCE, (), _ELLIPSE_SIGNATURES)


def load_tall_qr() -> ctypes.CDLL:
    """Build (if needed) and load the tall-skinny QR kernel K5 (one library
    for every shape)."""
    return load_source(TALL_QR_SOURCE, (), _TALL_QR_SIGNATURES)


def load_graph_loop() -> ctypes.CDLL:
    """Build (if needed) and load the graph-loop library (L1 and the
    conditional WHILE graphs)."""
    return load_source(GRAPH_LOOP_SOURCE, (), _GRAPH_LOOP_SIGNATURES)


def current_stream(device: int) -> int:
    """The raw handle of ``cuda:device``'s current stream, without building
    a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device)


class Launcher:
    """One ctypes launcher of a loaded library, bound once.

    ``launcher(device, *args)`` passes the operands' CUDA ordinal, ``args``
    (data pointers as ints, None for a null pointer, ints as they are) and
    that device's current stream, and raises on a non-zero
    ``cudaGetLastError()``: a refused launch never runs, and a later
    synchronize would not report it."""

    __slots__ = ("fn", "_lib")

    def __init__(self, lib: ctypes.CDLL, name: str):
        self.fn, self._lib = getattr(lib, name), lib

    def __call__(self, device: int, *args) -> None:
        err = self.fn(device, *args, current_stream(device))
        if err:
            raise RuntimeError(
                f"{self.fn.__name__} launch failed on cuda:{device}: CUDA error {err} "
                f"({self._lib.qrk_error_string(err).decode()})"
            )


@functools.lru_cache(maxsize=None)
def blockdiag_launcher(kind: str, br: int, bc: int, dtype=None) -> Launcher:
    """``qrk_blockdiag_<kind>_<f32|f64>`` of the br×bc library (no suffix
    without a dtype: ``empty``), built and bound at first use."""
    name = f"qrk_blockdiag_{kind}" + ("" if dtype is None else f"_{_SUFFIX[dtype]}")
    return Launcher(load(br, bc), name)


@functools.lru_cache(maxsize=None)
def banded_launcher(kind: str, dtype) -> Launcher:
    """``qrk_banded_<kind>_<f32|f64>``, built and bound at first use."""
    return Launcher(load_banded(), f"qrk_banded_{kind}_{_SUFFIX[dtype]}")


@functools.lru_cache(maxsize=None)
def chain_launcher(kind: str, dtype) -> Launcher:
    """``qrk_chain_<kind>_<f32|f64>`` (``two_seg``: K1, ``solve``: K2;
    ``two_seg_chunk`` / ``solve_chunk``: one phase of a level of their
    chunked forms, ``join``: a level's boundary pass), built and bound at
    first use."""
    return Launcher(load_chain(), f"qrk_chain_{kind}_{_SUFFIX[dtype]}")


@functools.lru_cache(maxsize=None)
def ellipse_launcher(kind: str, dtype) -> Launcher:
    """``qrk_ellipse_<kind>_<f32|f64>`` (``residuals``: K4r, ``jacobian``:
    K4j, ``vjp``: K4g's memset and launch), built and bound at first use."""
    return Launcher(load_ellipse_eval(), f"qrk_ellipse_{kind}_{_SUFFIX[dtype]}")


@functools.lru_cache(maxsize=None)
def tall_qr_launcher(dtype) -> Launcher:
    """``qrk_tall_qr_<f32|f64>`` (K5: a panel's leaf and tree levels, every
    panel), built and bound at first use."""
    return Launcher(load_tall_qr(), f"qrk_tall_qr_{_SUFFIX[dtype]}")


def tall_qr_plan(m: int, n: int) -> Tuple[int, int, int, int, int]:
    """K5's schedule of an ``[m, n + 1]`` operand as the library computes it:
    (tiles, levels, panels, launches, scratch blocks)."""
    out = (ctypes.c_int64 * 5)()
    load_tall_qr().qrk_tall_qr_plan(m, n, out)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def lm_step_launcher(kind: str, bl: int, bc: int, m2: int, dtype=None, extra=()) -> Launcher:
    """``qrk_lm_<kind>_<f32|f64>`` of the (bl, bc, m2) library (``step``:
    K3's memset and cooperative launch; no suffix without a dtype:
    ``empty``, the launch floor; ``extra``: :func:`build_lm_step`), built
    and bound at first use."""
    name = f"qrk_lm_{kind}" + ("" if dtype is None else f"_{_SUFFIX[dtype]}")
    return Launcher(load_lm_step(bl, bc, m2, extra), name)


def lm_step_geometry(bl: int, bc: int, m2: int, dtype, nb: int, nprob: int, tile: int,
                     extra=()) -> Tuple[int, int, int, bool]:
    """K3's launch geometry as the library computes it: (tiles, segs, grid,
    whether the factor rows stay in registers)."""
    out = (ctypes.c_int64 * 4)()
    getattr(load_lm_step(bl, bc, m2, extra), f"qrk_lm_geometry_{_SUFFIX[dtype]}")(nb, nprob, tile, out)
    return out[0], out[1], out[2], bool(out[3])
