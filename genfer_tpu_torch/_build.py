"""Build the port's CUDA kernels and load them with ctypes.

On first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``,
one ``nvcc`` process per source, all started together, and the objects
are linked into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds).  The library lands in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``)
under a name that hashes the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edited source is never served a
stale build.  Nothing here runs at import time; a failed build raises.
The first ``load`` in a process is the span ``kernels.load`` of the
port's tracer, and a build inside it the child span ``kernels.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from . import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgenfer_kernels-{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every ``(cmd, Popen)``; raise with the output of those
    that failed."""
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"({proc.returncode}) {' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _compile(out: Path) -> None:
    objs = out.parent / f"objects.{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    try:
        pairs = [(src, objs / f"{src.stem}.o") for src in _sources()]
        _run([_start([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
              for src, obj in pairs])
        _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                      *(str(obj) for _, obj in pairs)])])
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objs, ignore_errors=True)
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    i64 = ctypes.c_longlong
    for name, args in (
        *((name, [ptr] * 5 + [i32, ptr] + [i32] * 6 + [ptr])
          for name in ("conv2d_trunc_f32", "conv2d_trunc_f32_tile",
                       "conv2d_trunc_f32_grouped")),
        *((name, [ptr] * 5 + [i32, ptr] + [i32] * 6 + [ptr, i32, ptr])
          for name in ("conv2d_trunc_f32_tile_1pass",
                       "conv2d_trunc_f32_grouped_1pass")),
        ("conv2d_trunc_f32_batched",
         [ptr] * 5 + [i32, ptr, i32, i32] + [size] * 2 + [i32] * 6 + [ptr]),
        ("conv2d_trunc_f32_batched_1pass",
         [ptr] * 5 + [i32, ptr, i32, i32] + [size] * 2 + [i32] * 6
         + [ptr, i32, ptr]),
        ("conv2d_trunc_f64_batched",
         [ptr] * 5 + [i32, ptr, i32, i32] + [size] * 2 + [i32] * 8
         + [ptr] * 2),
        ("tf32_round_operands",
         [ptr, ptr, i64, i32, i32, ptr, ptr, i64, i32, i32, ptr]),
        ("conv1d_trunc_f32", [ptr] * 5 + [i32, ptr] + [i32] * 4 + [ptr]),
        ("conv2d_small_f64", [ptr] * 3 + [i32] * 9 + [ptr] * 2),
        ("ozaki_split", [ptr] * 2 + [i32] * 7 + [ptr] * 6),
        ("ozaki_conv2d", [ptr] * 9 + [i32, ptr] + [i32] * 14 + [ptr]),
        ("ozaki_small", [ptr] * 7 + [i32] * 12 + [ptr]),
        ("spine_f64", [ptr, i64, ptr, i64] + [ptr] * 3 + [i32] * 3 + [ptr]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if the launch function ``name`` returned a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` if it is not on disk."""
    global _lib
    with _lock:
        if _lib is None:
            with trace.span("kernels.load"):
                path = library_path()
                if not path.exists():
                    with trace.span("kernels.build"):
                        _compile(path)
                lib = ctypes.CDLL(str(path))
                _declare(lib)
                _lib = lib
    return _lib
