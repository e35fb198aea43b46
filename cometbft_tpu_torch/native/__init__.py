"""Native (C) host rungs of the port, built at first use with the system cc.

  hashvec.c   8-lane SIMD batch Keccak-f[1600], multi-buffer SHA-512 and
              Barrett reduction mod L (ops/hashvec.py's native rung)
  strobe.c    the STROBE-128 duplex and the batch schnorrkel challenge
              (crypto/sr25519_math.py's serial rung)

The port's own copies of cometbft_tpu/native/*.c. A library is compiled the
first time it is asked for, never at import, into the repository's
``build/`` (beside the CUDA kernels of ops/_build.py), named by a hash of
its source and of its compiler-flag ladder, and loaded with ctypes. The
ladder is read from the running host's /proc/cpuinfo, so a library built
for a wider ISA is never loaded on a narrower machine: that machine sees
another name and builds its own.

``load`` returns None when no flag set of the ladder compiles (no cc, a
read-only tree); ``build_error(name)`` then says why. The callers report
which rung they run (``hashvec.active_rung()``,
``sr25519_math.serial_rung()``), and a caller that forces the native rung
(``CBFT_HASHVEC=native``) raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_errors: dict[str, str] = {}


def _target(name: str, ladder: tuple) -> pathlib.Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.c").read_bytes() + repr(ladder).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, ladder: tuple, out: pathlib.Path) -> None:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (cc) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    errors = []
    try:
        for flags in ladder:
            proc = subprocess.run([cc, *flags, "-shared", "-fPIC", "-o", str(tmp),
                                   str(SRC_DIR / f"{name}.c")],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic against concurrent builds
                return
            errors.append(f"{' '.join(flags)}: {proc.stderr.strip()[-400:]}")
        raise RuntimeError(f"no flag set built {name}.c: " + " | ".join(errors))
    finally:
        if tmp.exists():
            tmp.unlink()


def load(name: str, cflags_ladder: tuple = (("-O2",),)) -> ctypes.CDLL | None:
    """The loaded library built from native/<name>.c, compiled with the
    first flag set of `cflags_ladder` that builds, or None (see
    build_error)."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        if name in _errors:
            return None
        try:
            out = _target(name, cflags_ladder)
            if not out.exists():
                _compile(name, cflags_ladder, out)
            lib = _loaded[name] = ctypes.CDLL(str(out))
            return lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _errors[name] = f"{type(exc).__name__}: {exc}"
            return None


def build_error(name: str) -> str | None:
    """Why native/<name>.c did not load, or None (loaded, or not tried)."""
    return _errors.get(name)


def isa_cflags() -> tuple:
    """Compiler-flag ladder for the SIMD cores, widest ISA first, from
    /proc/cpuinfo (not -march=native: virtualized hosts hide the model and
    gcc then picks a narrow baseline)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = line
                    break
    except OSError:
        pass
    ladder = []
    if " avx512f" in flags and " avx512dq" in flags:
        ladder.append(("-O3", "-mavx512f", "-mavx512dq"))
    if " avx2" in flags:
        ladder.append(("-O3", "-mavx2"))
    ladder.append(("-O3",))
    return tuple(ladder)
