"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``build/`` at the repository root, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads as is.
A source is built the first time its kernels are asked for. Nothing is
built from outside the repository; a failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(stem: str) -> tuple[pathlib.Path, str, float]:
    """Build csrc/<stem>.cu unless an up-to-date library exists. Returns the
    library's path, nvcc's output (the ptxas register and spill report) and
    the seconds nvcc took; "" and 0.0 when nothing was built."""
    src = CSRC_DIR / f"{stem}.cu"
    out = _target(src)
    if out.exists():
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out, proc.stdout, seconds


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs[stem] = ctypes.CDLL(str(build(stem)[0]))
    return lib
