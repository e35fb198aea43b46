"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``build/`` at the repository root, named by a hash of the source, of
every header it includes with ``#include "..."`` (``csrc/*.cuh``, followed
recursively) and of the flags, so an edited source or header rebuilds every
library that includes it and an unchanged one loads as is.
A source is built the first time its kernels are asked for. Nothing is
built from outside the repository; a failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: pathlib.Path) -> list[pathlib.Path]:
    """`src` and every file it includes with quotes, depth first, each once
    (paths relative to the including file, as nvcc resolves them)."""
    seen: list[pathlib.Path] = []
    stack = [src.resolve()]
    while stack:
        path = stack.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in reversed(_INCLUDE.findall(path.read_bytes())):
            stack.append((path.parent / name.decode()).resolve())
    return seen


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
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
