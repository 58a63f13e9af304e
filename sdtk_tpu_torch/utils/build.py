"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled on
first use into ``sdtk_tpu_torch/_build/lib<name>-<hash>.so`` for
``sm_90a`` with ``-I csrc``.  The hash covers the source, every header
under ``csrc`` and the flags, so an edited kernel or header rebuilds.
Nothing here falls back: a missing ``nvcc``, a failed compile or a launch
that returns a CUDA error raises :class:`KernelError`.

Threads of one process may ask for the same kernel at once (the batch
orchestrator's workers do): one lock serializes building and loading, so
each library is compiled once per process, and each compile writes a
temporary file named by process and thread before its atomic rename, so
compiles running in several processes never share one.

The host library (``csrc/host/*.cc``: the WAV reader and resampler, the
threaded loader and BLAKE3, under the JAX package's C ABI) is built the
same way by ``g++`` (``$CXX`` if set) with the JAX package's
``native/Makefile`` flags into ``_build/libsdtk_native-<hash>.so``
(:func:`build_host`); a missing or failing compiler raises
:class:`KernelError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_SRC = CSRC / "host"
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()  # held across build and load; load_library calls build


class KernelError(RuntimeError):
    """A kernel could not be built or its launch returned a CUDA error.

    Callers that degrade gracefully on other failures re-raise this one:
    a dead kernel must stop the run, not leave a result without it."""


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any of them
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named kernels (default: all), one ``nvcc`` each, all
    started together.  Returns each kernel's compiler output (register and
    shared-memory use from ``-Xptxas -v``); "" for one already built."""
    with _lock:
        jobs = {n: _start(n) for n in (names or kernel_names())}
        logs: dict[str, str] = {}
        failed = []
        for name, job in jobs.items():
            if job is None:
                logs[name] = ""
                continue
            proc, tmp, out = job
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}:\n{logs[name]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: no reader sees half a file
        if failed:
            raise KernelError("nvcc failed for " + "\n".join(failed))
        return logs


def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def _host_sources() -> list[Path]:
    return sorted(HOST_SRC.glob("*.cc"))


def _cpu_identity() -> bytes:
    """The CPU's model and feature flags: ``-march=native`` compiles for
    them, so a library built on another CPU gets another name."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keys = (b"model name", b"flags", b"Features", b"CPU part")
    return b"\n".join(sorted({ln for ln in lines if ln.split(b":")[0].strip() in keys}))


def host_library_path() -> Path:
    h = hashlib.sha256()
    for src in _host_sources():
        h.update(src.name.encode() + src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode() + _cpu_identity())
    return BUILD_DIR / f"libsdtk_native-{h.hexdigest()[:12]}.so"


def cxx() -> str:
    cand = os.environ.get("CXX") or "g++"
    found = shutil.which(cand)
    if found is None:
        raise KernelError(f"C++ compiler {cand!r} not found ($CXX, else g++ on PATH): "
                          f"cannot build the host library")
    return found


def build_host() -> Path:
    """Compile ``csrc/host/*.cc`` into the host library unless it is
    built; its path."""
    with _lock:
        out = host_library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        compiler = cxx()
        try:
            proc = subprocess.run([compiler, *HOST_FLAGS, "-o", str(tmp),
                                   *map(str, _host_sources())],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise KernelError(f"{compiler} failed for the host library:\n{proc.stdout}")
            os.replace(tmp, out)  # atomic: no reader sees half a file
        finally:
            tmp.unlink(missing_ok=True)
        return out


def launch(name: str, argtypes: list, *args) -> None:
    """Call ``<name>_launch`` of ``csrc/<name>.cu`` (built and bound on first
    use; pointers and the stream as ``ctypes.c_void_p``) and raise if the
    cudaError_t it returns is not 0 (:class:`KernelError`)."""
    fn = getattr(load_library(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: cudaError {err}")
