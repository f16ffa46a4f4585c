"""Build the CUDA sources under ``ops/csrc/`` with ``nvcc`` and load them.

No counterpart in ``qrkit_tpu`` (Pallas kernels compile inside ``jax.jit``).
Each block shape (br, bc) gets its own shared library, compiled at first use
with ``-DQRK_BR=br -DQRK_BC=bc`` so the per-thread recurrence unrolls fully
into registers; float and double launchers live in the same library.  The
libraries are plain C (no PyTorch headers), so a build takes seconds, and
are loaded with ctypes.  They go under ``build/qrkit_tpu_torch/`` at the
root of the checkout, keyed by shape and a hash of the source and flags, so
an edited source never loads a stale library.

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

__all__ = ["NVCC_FLAGS", "build", "find_nvcc", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "blockdiag_qr.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qrkit_tpu_torch"
_DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the CUDA toolkit's standard prefix

# --fmad=false: see the numerics note in csrc/blockdiag_qr.cu.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
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


def _library_path(br: int, bc: int) -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"blockdiag_qr_{br}x{bc}_{h.hexdigest()[:16]}.so"


def build(br: int, bc: int) -> Path:
    """Compile the block-diagonal kernels for one block shape (cached on
    disk); returns the library's path."""
    out = _library_path(br, bc)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, f"-DQRK_BR={br}", f"-DQRK_BC={bc}", "-o", tmp, str(_SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {_SOURCE.name} for "
                f"{br}x{bc} blocks:\n{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(br: int, bc: int) -> ctypes.CDLL:
    """Build (if needed) and load the kernels for one block shape, with the
    launchers' ctypes signatures set."""
    lib = ctypes.CDLL(str(build(br, bc)))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"qrk_blockdiag_lstsq_{dt}")
        fn.argtypes = [ptr, ptr, ptr, i64, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qrk_blockdiag_qr_r_{dt}")
        fn.argtypes = [ptr, ptr, i64, ptr]
        fn.restype = ctypes.c_int
    lib.qrk_error_string.argtypes = [ctypes.c_int]
    lib.qrk_error_string.restype = ctypes.c_char_p
    return lib
