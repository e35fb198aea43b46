"""How the verify path reaches the card: one dispatch stream and one
dispatch lock per process. The port's counterpart of the part of
cometbft_tpu/ops/dispatch.py that the verify path keeps (its
KERNEL_DISPATCH_LOCK); the supervisor, the circuit breaker, the watchdog
and the chaos sites are not ported: a CUDA fault raises. Nor is its
DoubleBuffer (pinned staging blocks, ``:445``): no caller stages one batch
while the card runs another, and pinned copies did not shorten a batch's
staging on the card (PERF.md), so a batch's arrays go up with plain
copies on the dispatch stream.

  dispatch stream  one torch.cuda.Stream per device. Every stage and launch
                   of a verify batch (ed25519_kernel.verify_batch_async) and
                   every fetch of its header (resolve_batches) runs on it,
                   from whichever thread dispatches: the scheduler's caller
                   threads and its deadline worker. The key tables
                   (ops/residency.py) and the prefix tables (ops/challenge.py)
                   are updated in place, so one stream is what orders a
                   delta upload after the kernels that still read a row.
  dispatch lock    stage + launch run under it; the fetch does not.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# stage + launch of one verify batch (re-entrant: verify_rows nests the
# async entry)
DISPATCH_LOCK = threading.RLock()

_streams: dict[torch.device, torch.cuda.Stream] = {}
_reg_lock = threading.Lock()


def _key(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def stream(dev: torch.device) -> torch.cuda.Stream | None:
    """The dispatch stream of CUDA device `dev` (None on the CPU)."""
    if dev.type != "cuda":
        return None
    dev = _key(dev)
    with _reg_lock:
        s = _streams.get(dev)
        if s is None:
            s = _streams[dev] = torch.cuda.Stream(device=dev)
        return s


def on_stream(dev: torch.device):
    """A context in which the dispatch stream of `dev` is the current
    stream (nothing on the CPU)."""
    s = stream(dev)
    return contextlib.nullcontext() if s is None else torch.cuda.stream(s)


@contextlib.contextmanager
def launching(dev: torch.device):
    """Stage and launch under the dispatch lock, on the dispatch stream."""
    with DISPATCH_LOCK, on_stream(dev):
        yield
