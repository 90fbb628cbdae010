"""Build and load the port's native code: compiler -> shared library -> ``ctypes``.

Each ``csrc/<name>.cu`` (a CUDA kernel source) compiles, with every
``csrc/*.cuh`` it may include, into its own shared library with a plain
C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu

and each ``native/<name>.cpp`` (host C++, the CPU driver's hot loops)
likewise with ``g++``::

    g++ -O3 -shared -fPIC -std=c++17 -o _build/lib<name>-<digest>.so native/<name>.cpp

No PyTorch header is compiled, which keeps a build to seconds. The
library's name carries a digest of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded from ``_build/`` (which
git ignores). The host build leaves out ``-march=native``: a library
built on one host then runs on any x86-64 host that loads the same
checkout. The build happens at first use, never at import: a machine
without ``nvcc`` imports the package and runs its kernels' plain
versions on the CPU. A build that fails raises with the compiler's
output; nothing falls back.
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def host_sources() -> list[str]:
    """Names of the host C++ sources (``native/<name>.cpp``)."""
    return sorted(p.stem for p in NATIVE_DIR.glob("*.cpp"))


def _is_host(name: str) -> bool:
    return (NATIVE_DIR / f"{name}.cpp").exists()


def nvcc() -> str:
    """The ``nvcc`` on PATH, else the one under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def gxx() -> str:
    """The ``g++`` on PATH."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH: cannot build the host library")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    if _is_host(name):
        flags, deps = GXX_FLAGS, [NATIVE_DIR / f"{name}.cpp"]
    else:
        flags, deps = NVCC_FLAGS, [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    h.update(" ".join(flags).encode())
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    if _is_host(name):
        return [gxx(), *GXX_FLAGS, "-o", str(out), str(NATIVE_DIR / f"{name}.cpp")]
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source not yet built (default: every kernel
    source and every host source), one compiler per source, all started
    together. Returns seconds per source built; raises with the
    compiler's output if any build fails. Each build's output (with
    ``-Xptxas -v`` for a kernel) lands in ``_build/<name>.log``."""
    names = [*sources(), *host_sources()] if names is None else names
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[n] = (subprocess.Popen(_command(n, tmp), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: {Path(proc.args[0]).name} exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return seconds


def load_library(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``native/<name>.cpp``
    (built first if needed),
    with ``argtypes``/``restype`` set from ``signatures``
    (``{symbol: (argtypes, restype)}``)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for sym, (argtypes, restype) in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            _loaded[name] = lib
        return lib
