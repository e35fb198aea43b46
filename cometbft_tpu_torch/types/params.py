"""ConsensusParams (reference: types/params.go).

Consensus-critical limits agreed by the chain; hashed into Header
.ConsensusHash. The crypto section adds this framework's backend knob
surface at the *node* level only (config), never here — params must remain
chain-portable.

The port's copy of cometbft_tpu/types/params.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from cometbft_tpu_torch.utils import protobuf as pb

MAX_BLOCK_SIZE_BYTES = 104857600  # types/params.go MaxBlockSizeBytes
ABCI_PUB_KEY_TYPE_ED25519 = "ed25519"
ABCI_PUB_KEY_TYPE_SECP256K1 = "secp256k1"
ABCI_PUB_KEY_TYPE_SR25519 = "sr25519"
ABCI_PUB_KEY_TYPE_BLS12381 = "bls12381"


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21 MB default
    max_gas: int = -1

    def validate(self) -> None:
        if self.max_bytes == 0 or self.max_bytes < -1:
            raise ValueError(f"block.MaxBytes must be -1 or > 0. Got {self.max_bytes}")
        if self.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(f"block.MaxBytes is too big. {self.max_bytes} > {MAX_BLOCK_SIZE_BYTES}")
        if self.max_gas < -1:
            raise ValueError(f"block.MaxGas must be >= -1. Got {self.max_gas}")


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000  # 48h
    max_bytes: int = 1048576

    def validate(self, block_max_bytes: int) -> None:
        if self.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be greater than 0")
        if self.max_age_duration_ns <= 0:
            raise ValueError("evidence.MaxAgeDuration must be greater than 0")
        if self.max_bytes > block_max_bytes:
            raise ValueError("evidence.MaxBytes exceeds block.MaxBytes")
        if self.max_bytes < 0:
            raise ValueError("evidence.MaxBytes must be non negative")


@dataclass
class ValidatorParams:
    pub_key_types: list[str] = field(default_factory=lambda: [ABCI_PUB_KEY_TYPE_ED25519])

    def validate(self) -> None:
        if not self.pub_key_types:
            raise ValueError("len(Validator.PubKeyTypes) must be greater than 0")
        for t in self.pub_key_types:
            if t not in (
                ABCI_PUB_KEY_TYPE_ED25519,
                ABCI_PUB_KEY_TYPE_SECP256K1,
                ABCI_PUB_KEY_TYPE_SR25519,
                ABCI_PUB_KEY_TYPE_BLS12381,
            ):
                raise ValueError(f"unknown pubkey type {t}")


@dataclass
class VersionParams:
    app: int = 0


@dataclass
class ABCIParams:
    vote_extensions_enable_height: int = 0

    def vote_extensions_enabled(self, height: int) -> bool:
        if self.vote_extensions_enable_height == 0:
            return False
        return height >= self.vote_extensions_enable_height


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    abci: ABCIParams = field(default_factory=ABCIParams)

    def validate_basic(self) -> None:
        self.block.validate()
        self.evidence.validate(self.block.max_bytes)
        self.validator.validate()

    def hash(self) -> bytes:
        """types/params.go HashConsensusParams — SHA-256 of the proto of a
        HashedParams subset (BlockMaxBytes, BlockMaxGas)."""
        w = pb.Writer()
        w.varint_i64(1, self.block.max_bytes)
        w.varint_i64(2, self.block.max_gas)
        return hashlib.sha256(w.output()).digest()

    def update(self, updates: "ConsensusParamsUpdate | None") -> "ConsensusParams":
        if updates is None:
            return self
        import copy

        res = copy.deepcopy(self)
        if updates.block is not None:
            res.block = updates.block
        if updates.evidence is not None:
            res.evidence = updates.evidence
        if updates.validator is not None:
            res.validator = updates.validator
        if updates.version is not None:
            res.version = updates.version
        if updates.abci is not None:
            res.abci = updates.abci
        return res


@dataclass
class ConsensusParamsUpdate:
    block: BlockParams | None = None
    evidence: EvidenceParams | None = None
    validator: ValidatorParams | None = None
    version: VersionParams | None = None
    abci: ABCIParams | None = None


def default_consensus_params() -> ConsensusParams:
    return ConsensusParams()
