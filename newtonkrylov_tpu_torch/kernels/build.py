"""Build the package's native sources at first use and load them.

Each ``csrc/<name>.cu`` (CUDA, compiled by ``nvcc``) or ``csrc/<name>.cpp``
(host C++, compiled by the host compiler: ``$CXX``, else ``g++``) exposes a
plain C interface and is compiled into ``_build/lib<name>-<digest>.so``
inside the package (git-ignored), where ``<digest>`` hashes the source, the
shared ``csrc/*.cuh`` headers of a CUDA source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The library is
bound with :mod:`ctypes`; nothing here includes PyTorch's headers, which
keeps a build to seconds.  A build that fails raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "library_path", "BUILD_DIR", "NVCC_FLAGS", "CXX_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no multiply-add contraction, so the kernels round exactly as
# their plain PyTorch versions do.  -Xptxas -v reports registers and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Host C++: no fast-math, and -ffp-contract=off so that a target with FMA
# rounds as the NumPy versions the tests hold the library against.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")

_LOADED: dict = {}
BUILD_LOG: dict = {}  # name -> {"seconds": float, "log": str, "path": str}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found: put it on PATH or set CUDA_HOME; the CUDA "
            "kernels are built from source at first use")
    return path


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError(
            "no host C++ compiler found: put g++ on PATH or set CXX; the host "
            "sources are built from source at first use")
    return found


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    src = CSRC_DIR / f"{name}.cu"
    return src if src.exists() else CSRC_DIR / f"{name}.cpp"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` or ``.cpp`` is (or will be)
    built: the file name carries a digest of the source, the shared headers
    of a CUDA source (``csrc/*.cuh``) and the flags."""
    src = _source(name)
    if src.suffix == ".cu":
        headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        flags = NVCC_FLAGS
    else:
        headers, flags = b"", CXX_FLAGS
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu`` or ``.cpp``, built on
    first use."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    src = _source(name)
    out = library_path(name)
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        compiler = ([_nvcc(), *NVCC_FLAGS] if src.suffix == ".cu"
                    else [_cxx(), *CXX_FLAGS])
        proc = subprocess.run(
            [*compiler, "-o", str(tmp), str(src)],
            capture_output=True, text=True, check=False,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler[0])} failed on {src.name}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    lib = ctypes.CDLL(str(out))
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log,
                       "path": str(out)}
    _LOADED[name] = lib
    return lib
