"""The staging checksum and the reduced-fetch header: the wrappers of the
integrity kernel K6 (csrc/integrity.cu) and their plain PyTorch versions.

Source note. K6 replaces the XLA programs
``cometbft_tpu/ops/ed25519_kernel.py::_device_checksum_expr`` (:209),
``_integrity_parts_expr`` (:251) and ``_integrity_parts_arrs_expr`` (:271):

  checksum  position-weighted sum mod 2^32 of the staged arrays' uint32
            words in ravel order across the arrays, word idx weighted
            idx * 2654435761 + 1;
  header    [tok, ~tok], tok = checksum ^ (OK_MAGIC if every lane verified
            and the checksum equals the host's, else BAD_MAGIC): 8 bytes
            that prove a happy batch;
  payload   [mask, ~mask, checksum ok], (2B + 1,) bool, fetched only when
            the header is not happy.

The payload's mask and the all-ok word are the verify kernel's raw int32
verdicts (``verify_kernel.verify_ok_raw``), non-zero valid, as K1 writes
them: no elementwise launch sits between the verify kernel and K6.

It is bound by bytes (each staged word read once); the kernel is at most
one block an SM walking the arrays with 16-byte loads and one atomicAdd a
block, and the last block writes the header. On the verify path it is a
programmatic dependent launch (``overlap=True``): it checksums while the
verify kernel's blocks exit and waits for that grid before it reads the
verdicts (see the source). The host side, the expected checksum and the
header's verdicts, is ``host_checksum`` here and
``ed25519_kernel.decode_header`` / ``decode_payload``.

Each wrapper takes its plain version for tensors on the CPU and launches
K6 for tensors on a CUDA device; there is no other route. ``LAUNCHES``
counts kernel launches per entry.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from cometbft_tpu_torch.ops import _build

CHK_MULT = 2654435761  # Knuth's multiplicative-hash odd constant
OK_MAGIC = np.uint32(0x600DFA57)
BAD_MAGIC = np.uint32(~0x600DFA57 & 0xFFFFFFFF)
_M32 = 0xFFFFFFFF

LAUNCHES = {"integrity_parts": 0, "integrity_checksum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------- host


def host_checksum(*arrs: np.ndarray) -> int:
    """Position-weighted sum mod 2^32 over the arrays' uint32 views, in
    ravel order: what the device must find in what it received."""
    acc = 0
    off = 0
    for a in arrs:
        flat = np.ascontiguousarray(a).view(np.uint32).ravel().astype(np.uint64)
        idx = np.arange(off, off + flat.size, dtype=np.uint64)
        w = (idx * np.uint64(CHK_MULT) + np.uint64(1)) & np.uint64(_M32)
        acc = (acc + int(((flat * w) & np.uint64(_M32)).sum() & _M32)) & _M32
        off += flat.size
    return acc


# ------------------------------------------------------------ plain versions


def _u32(t: torch.Tensor) -> torch.Tensor:
    """An int32 tensor's uint32 bits as int64, flattened."""
    return t.reshape(-1).to(torch.int64) & _M32


def checksum_plain(*arrs: torch.Tensor) -> torch.Tensor:
    """The checksum of int32 tensors (the uint32 bits) as a 0-dim int64
    tensor in [0, 2^32). Products are split in 16-bit halves so that every
    step fits int64."""
    acc = torch.zeros((), dtype=torch.int64, device=arrs[0].device if arrs else "cpu")
    off = 0
    for a in arrs:
        v = _u32(a)
        idx = torch.arange(off, off + v.numel(), dtype=torch.int64, device=v.device)
        w = (idx * CHK_MULT + 1) & _M32
        prod = (v & 0xFFFF) * w + (((v >> 16) * w) & 0xFFFF) * 65536
        acc = (acc + (prod & _M32).sum()) & _M32
        off += v.numel()
    return acc


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def parts_plain(mask: torch.Tensor, allok: torch.Tensor, expected: int, *arrs: torch.Tensor):
    """-> ((2,) int32 header with the uint32 bits of [tok, ~tok], (2B + 1,)
    bool payload [mask, ~mask, checksum ok]). mask (B,) and all-ok (one
    element) are bool or the verify kernel's raw int32 (non-zero valid)."""
    chk = checksum_plain(*arrs)
    ok = chk == (int(expected) & _M32)
    magic = torch.where((allok.reshape(()) != 0) & ok, int(OK_MAGIC), int(BAD_MAGIC))
    tok = chk ^ magic
    header = to_int32(torch.stack([tok, tok ^ _M32]))
    valid = mask != 0
    payload = torch.cat([valid, ~valid, ok.reshape(1)])
    return header, payload


# ------------------------------------------------------------------ kernel

_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.library("integrity")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.integrity_parts.argtypes = [vp, ll, vp, ll, vp, ll, vp, vp, ci, ctypes.c_uint, vp,
                                        vp, vp, ci, vp]
        lib.integrity_parts.restype = ci
        lib.integrity_launch_shape.argtypes = [ll, ctypes.POINTER(ci)]
        lib.integrity_launch_shape.restype = ci
        _lib_cache.append(lib)
    return _lib_cache[0]


def _arrays(arrs, dev) -> list:
    if not 1 <= len(arrs) <= 3:
        raise ValueError(f"K6 checksums 1 to 3 arrays, got {len(arrs)}")
    out = []
    for i, a in enumerate(arrs):
        if a.device != dev or a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError(f"array {i} must be a contiguous int32 tensor on {dev}, got "
                             f"{a.dtype} on {a.device}")
        out += [a.data_ptr(), a.numel()]
    return out + [None, 0] * (3 - len(arrs))


_scratch: dict[tuple[torch.device, int], torch.Tensor] = {}
_scratch_lock = threading.Lock()


def _scratch_of(dev: torch.device, stream: int) -> torch.Tensor:
    """The two zeroed uint32 words K6's launches on `stream` share: each
    launch's last block zeroes them again, and the stream orders the
    launches (a programmatic launch touches them only after its wait)."""
    with _scratch_lock:
        t = _scratch.get((dev, stream))
        if t is None:
            t = _scratch[(dev, stream)] = torch.zeros(2, dtype=torch.int32, device=dev)
        return t


def _launch(args: list, dev: torch.device, entry: str, overlap: bool) -> None:
    with _build.on_device(dev):
        stream = _build.raw_stream(dev)
        err = _lib().integrity_parts(*args[:-2], _scratch_of(dev, stream).data_ptr(),
                                     *args[-2:], overlap, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
    LAUNCHES[entry] += 1


def integrity_parts(mask: torch.Tensor, allok: torch.Tensor, expected: int, *arrs: torch.Tensor,
                    overlap: bool = False):
    """The counterpart of _integrity_parts(_arrs): the verify kernel's raw
    (B,) int32 mask and (1,) int32 all-ok, the host's expected checksum, and
    1 to 3 checksummed int32 arrays -> ((2,) int32 header, (2B + 1,) bool
    payload). With `overlap` (the verify path) K6 is a programmatic
    dependent launch behind the kernel before it on the stream: that kernel
    may still be writing the verdicts, but must not write the arrays."""
    dev = mask.device
    if dev.type == "cpu":
        return parts_plain(mask, allok, expected, *arrs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if mask.dtype != torch.int32 or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous 1-d int32 tensor (the verify kernel's)")
    if allok.dtype != torch.int32 or allok.numel() != 1 or allok.device != dev:
        raise ValueError(f"all-ok must be one int32 word on {dev} (the verify kernel's)")
    b = mask.shape[0]
    header = torch.empty(2, dtype=torch.int32, device=dev)
    payload = torch.empty(2 * b + 1, dtype=torch.bool, device=dev)
    _launch(_arrays(arrs, dev) + [mask.data_ptr(), allok.data_ptr(), b,
                                  int(expected) & _M32, header.data_ptr(), payload.data_ptr()],
            dev, "integrity_parts", overlap)
    return header, payload


def device_checksum(*arrs: torch.Tensor) -> int:
    """The counterpart of _device_checksum: the checksum of 1 to 3 int32
    arrays where they lie, as a host int (the key-table uploads compare it
    with host_checksum). Launched in plain stream order: the arrays may be
    the output of the kernel before it."""
    dev = arrs[0].device
    if dev.type == "cpu":
        return int(checksum_plain(*arrs))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(1, dtype=torch.int32, device=dev)
    _launch(_arrays(arrs, dev) + [None, None, 0, 0, out.data_ptr(), None],
            dev, "integrity_checksum", False)
    return int(out[0]) & _M32


def launch_shape(work: int, dev: torch.device) -> dict[str, int]:
    """How K6 launches over `work` words on CUDA device `dev`: threads per
    block, blocks, resident blocks per SM, SMs, waves, local memory per
    thread and registers. Launches nothing."""
    out = (ctypes.c_int * 7)()
    with _build.on_device(dev):
        err = _lib().integrity_launch_shape(work, out)
    if err != 0:
        raise RuntimeError(f"integrity launch shape failed: cudaError_t {err}")
    _, blocks, threads, per_sm, sms, local_bytes, registers = out
    return {"blocks": blocks, "threads_per_block": threads, "blocks_per_sm": per_sm,
            "sms": sms, "waves": -(-blocks // (per_sm * sms)), "local_bytes": local_bytes,
            "registers": registers}


def decode_mask(payload: np.ndarray) -> tuple[np.ndarray, bool, bool]:
    """A fetched (2B + 1,) payload -> (mask (B,), checksum ok, echo ok)."""
    b = (payload.shape[0] - 1) // 2
    mask = payload[:b].copy()
    return mask, bool(payload[2 * b]), bool((mask != payload[b:2 * b]).all())
