"""Build the port's host C++ extensions with g++ and load them.

``csrc/host/`` holds the port's copies of genfer_tpu's native sources:
``_seriesops`` (f64 series kernels), ``_evaltape`` (the C++ GF-DAG
evaluator) and ``_exactops`` (GMP/MPFR scalars and kernels).  On first use
every missing one is compiled, all at once in parallel, with the flags of
genfer_tpu's ``native/build.py`` (``-O3 -march=native -shared -fPIC
-std=c++17``, plus ``-pthread`` for the tape and the system libmpfr /
libgmp for ``_exactops``): another flag would change FMA contraction and
with it the last bits of the f64 results.  The libraries land in
``build/host/`` at the root of the checkout (listed in ``.gitignore``)
under names that hash the sources and flags, are written under a
temporary name and moved into place while a file lock is held (several
test workers may start at once), and are loaded with
``importlib.util.spec_from_file_location``.

``-march=native`` ties a build to the CPU that made it, so the name also
hashes the CPU's feature flags (``/proc/cpuinfo``): a checkout moved to
another machine builds anew instead of loading code its CPU may not run.

As in genfer_tpu, the extensions are optional: ``load_extension`` returns
None when there is no C++ compiler or no Python headers (``_exactops``
also when libgmp / libmpfr are absent), and the callers take their
Python paths.  A compiler that is present but fails raises.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
GMP = Path("/lib/x86_64-linux-gnu/libgmp.so.10")
MPFR = Path("/lib/x86_64-linux-gnu/libmpfr.so.6")

#: extension -> (its source files, the first one compiled, and its extra
#: g++ arguments)
EXTENSIONS: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "_seriesops": (("seriesops.cpp",), ()),
    "_evaltape": (("evaltape.cpp", "evaltape_eval.inc"), ("-pthread",)),
    "_exactops": (("exactops.cpp", "exactops_abi.h"), (str(MPFR), str(GMP))),
}

_lock = threading.Lock()
_loaded: dict[str, object] = {}


def _buildable(name: str) -> bool:
    if name == "_exactops":
        return GMP.exists() and MPFR.exists()
    return True


def _headers() -> str | None:
    include = sysconfig.get_path("include")
    return include if (Path(include) / "Python.h").exists() else None


def _cpu_flags() -> bytes:
    """The feature flags of the first CPU in ``/proc/cpuinfo`` (empty where
    there is none)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path(name: str) -> Path:
    srcs, extra = EXTENSIONS[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + extra).encode())
    h.update(sys.version.encode())
    h.update(_cpu_flags())
    for src in srcs:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{suffix}"


def _compile_missing(include: str) -> None:
    """Compile every buildable extension that is not on disk, in parallel;
    the caller holds the build lock."""
    procs = []
    for name, (srcs, extra) in EXTENSIONS.items():
        out = library_path(name)
        if out.exists() or not _buildable(name):
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, f"-I{include}", str(CSRC / srcs[0]),
               "-o", str(tmp), *extra]
        procs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    failed = []
    for cmd, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("g++ failed:\n" + "\n".join(failed))


def load_extension(name: str):
    """The extension module ``name`` (a key of ``EXTENSIONS``), built on
    first use; None where it cannot be built here."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        mod = None
        include = _headers()
        if _buildable(name) and include and shutil.which("g++"):
            path = library_path(name)
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(BUILD_DIR / ".lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    _compile_missing(include)
            full = f"{__package__}.{name}"
            spec = importlib.util.spec_from_file_location(full, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[full] = mod
        _loaded[name] = mod
        return mod
