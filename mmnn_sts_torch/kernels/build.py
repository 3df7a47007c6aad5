"""Build the hand-written CUDA kernels at first use, and load them.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface, loaded with ``ctypes``. The
library's name carries a hash of every file under ``csrc/`` and of the nvcc
flags, so an edited source or header is rebuilt and a stale library is never
loaded. Builds go to ``_build/`` beside this file (listed in ``.gitignore``).
No PyTorch header is compiled, so a build takes seconds, and no ``ninja`` is
needed.

Nothing is built when this module is imported: the first CUDA call of a
kernel's wrapper builds it, and ``build_all`` builds every source at once,
one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives. Its name hashes
    the flags and every file under ``csrc/`` (path and bytes), since a source
    may include any header there."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(CSRC)).encode() + b"\0")
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every named source (default: all of ``csrc/``) that has no
    current library yet, one ``nvcc`` each, all running at once. Raises on
    any compile error. Returns name -> library path."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, lib, log,
        )
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)  # atomic: a reader never sees half a file
        else:
            failed.append(f"{name}: nvcc exited {rc}\n"
                          + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib
