"""Build the port's CUDA kernels and load them with ctypes.

On first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface (no PyTorch headers, so
the build takes seconds).  The library lands in ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``) under a name that hashes
the sources and flags, so an edited source is never served a stale build.
Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: wall seconds the last build in this process took (0.0 when the
#: library was already on disk)
build_seconds = 0.0


def _nvcc() -> str:
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's own prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgenfer_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv2d_trunc_f32.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.conv2d_trunc_f32.restype = i32
    lib.conv2d_trunc_f32_error_string.argtypes = [i32]
    lib.conv2d_trunc_f32_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` if it is not on disk."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
    return _lib
