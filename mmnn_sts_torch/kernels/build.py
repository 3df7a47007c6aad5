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

The host C++ library of the cohort build (``native/mmnn_native.cpp``: the
NIfTI decoder, the threaded cohort pool and the JPEG-LS, JPEG-Lossless and
JPEG 2000 decoders, bound in ``data/native.py``) is built by ``build_host``
with ``g++`` and the flags of ``native/Makefile``, into the same directory,
under a name that hashes the source, the flags, the compiler's version and
the CPU (``-march=native``). A file lock serialises concurrent builds (test
workers, threads); a failed build raises with the compiler's log.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
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

# host libraries: name -> source, and the flags of native/Makefile
HOST_SOURCES = {"mmnn_native": Path(__file__).resolve().parents[2] / "native"
                / "mmnn_native.cpp"}
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-march=native", "-shared")
HOST_LIBS = ("-lz", "-lpthread")

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


@functools.lru_cache(maxsize=None)
def _host_identity() -> bytes:
    """The compiler's version and this CPU's model and flags: what
    ``-march=native`` compiles for."""
    out = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout
    try:
        with open("/proc/cpuinfo") as f:
            out += "".join(line for line in f.read().split("\n\n")[0]
                           .splitlines(True)
                           if line.startswith(("model name", "flags")))
    except OSError:
        pass
    return out.encode()


def host_library_path(name: str) -> Path:
    """Where the host library built from ``HOST_SOURCES[name]`` lives: its
    name hashes the flags, the compiler and CPU, and the source's bytes."""
    source = HOST_SOURCES[name]
    h = hashlib.sha256("\0".join(HOST_FLAGS + HOST_LIBS).encode())
    h.update(_host_identity())
    h.update(source.read_bytes() if source.is_file()
             else str(source).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile the host library ``name`` from ``HOST_SOURCES[name]`` with
    g++ unless a current one exists; returns its path. Raises with the
    compiler's log if the build fails."""
    source = HOST_SOURCES[name]
    lib = host_library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{lib.name}.lock", "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it meanwhile
            return lib
        tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
        cmd = ["g++", *HOST_FLAGS, str(source), "-o", str(tmp), *HOST_LIBS]
        res = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"host library build failed: {' '.join(cmd)} exited "
                f"{res.returncode}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)  # atomic: a reader never sees half a file
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name``, built first if needed."""
    with _lock:
        key = f"host:{name}"
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            _loaded[key] = lib
        return lib
