"""cometbft_tpu_torch — the PyTorch/CUDA port of cometbft_tpu's device layer.

The hot path of a BFT node is batch verification of Ed25519 vote
signatures behind the ``crypto.BatchVerifier`` plugin boundary. This
package runs it on an NVIDIA Hopper GPU: host staging in numpy and native C
rungs, the per-lane ZIP-215 verify ladder, pubkey decompression, the
challenge derivation and the integrity header as hand-written CUDA C++
kernels (``csrc/``), with plain PyTorch versions of the same arithmetic
beside each kernel for the CPU tests.

Package map:
  types/      sign bytes, commits, validator sets, and commit verification
              (validation.verify_commit*, the staged blocksync windows)
  sched/      the node-wide verify scheduler: continuous batching of all
              signature work on one card, or over the fault-domain mesh
  parallel/   the fault-domain verify mesh (VerifyMesh: per-domain streams,
              key tables, supervisors and breakers, redispatch) and the
              SPMD plane (sharded_verify_batch)
  crypto/     key types, the ZIP-215 host oracle, the batch-verifier registry
              and the scheduler's client, Merkle trees, tmhash
  ops/        limb packing, field/curve arithmetic (plain torch), the kernel
              wrappers and their nvcc build, host staging, the key tables,
              device challenges and the integrity header
  csrc/       CUDA C++ kernel sources, built for sm_90a at first use
  native/     C host hash rungs (SIMD SHA-512/Keccak/mod L, STROBE), built
              with cc at first use
  libs/       shared-prefix message rows (prefixrows.py), device-fault
              injection sites (chaos.py)
  utils/      the protobuf codec and canonical time

Entry points take an explicit ``device`` and default to ``cuda``; they
raise when no card is present unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and no
    card is present — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cometbft_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
