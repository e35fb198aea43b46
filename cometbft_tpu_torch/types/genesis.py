"""GenesisDoc (reference: types/genesis.go) — JSON-serialized chain origin.

The port's copy of cometbft_tpu/types/genesis.py.
"""

from __future__ import annotations

import base64
import hashlib
import json
from dataclasses import dataclass, field

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import bls12381, ed25519
from cometbft_tpu_torch.types.params import ConsensusParams, default_consensus_params
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.utils import cmttime

MAX_CHAIN_ID_LEN = 50

# JSON amino-style type tags per key scheme (genesis + priv_validator_key
# share the same registry; see privval/file_pv.py).
PUB_KEY_JSON_TYPES = {
    ed25519.KEY_TYPE: "tendermint/PubKeyEd25519",
    bls12381.KEY_TYPE: "cometbft/PubKeyBls12_381",
}
_PUB_KEY_DECODERS = {
    "tendermint/PubKeyEd25519": ed25519.PubKey,
    "cometbft/PubKeyBls12_381": bls12381.PubKey,
}


@dataclass
class GenesisValidator:
    address: bytes
    pub_key: crypto.PubKey
    power: int
    name: str = ""


@dataclass
class GenesisDoc:
    genesis_time: cmttime.Timestamp
    chain_id: str
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=default_consensus_params)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet(
            [Validator.new(v.pub_key, v.power) for v in self.validators]
        )

    def validate_and_complete(self) -> None:
        """genesis.go ValidateAndComplete."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max: {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate_basic()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(f"genesis file cannot contain validators with no voting power: {v}")
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(f"incorrect address for validator {i}")
            if not v.address:
                v.address = v.pub_key.address()
        if self.genesis_time.is_zero():
            self.genesis_time = cmttime.now()

    def hash(self) -> bytes:
        return hashlib.sha256(self.to_json().encode()).digest()

    def to_json(self) -> str:
        return json.dumps(
            {
                "genesis_time": self.genesis_time.rfc3339(),
                "chain_id": self.chain_id,
                "initial_height": str(self.initial_height),
                "consensus_params": {
                    "block": {
                        "max_bytes": str(self.consensus_params.block.max_bytes),
                        "max_gas": str(self.consensus_params.block.max_gas),
                    },
                    "evidence": {
                        "max_age_num_blocks": str(self.consensus_params.evidence.max_age_num_blocks),
                        "max_age_duration": str(self.consensus_params.evidence.max_age_duration_ns),
                        "max_bytes": str(self.consensus_params.evidence.max_bytes),
                    },
                    "validator": {
                        "pub_key_types": self.consensus_params.validator.pub_key_types
                    },
                    "version": {"app": str(self.consensus_params.version.app)},
                    "abci": {
                        "vote_extensions_enable_height": str(
                            self.consensus_params.abci.vote_extensions_enable_height
                        )
                    },
                },
                "validators": [
                    {
                        "address": v.address.hex().upper(),
                        "pub_key": {
                            "type": PUB_KEY_JSON_TYPES.get(
                                v.pub_key.type_(), "tendermint/PubKeyEd25519"
                            ),
                            "value": base64.b64encode(v.pub_key.bytes_()).decode(),
                        },
                        "power": str(v.power),
                        "name": v.name,
                    }
                    for v in self.validators
                ],
                "app_hash": self.app_hash.hex().upper(),
                "app_state": json.loads(self.app_state.decode() or "{}"),
            },
            indent=2,
            sort_keys=False,
        )

    @classmethod
    def from_json(cls, raw: str | bytes) -> "GenesisDoc":
        d = json.loads(raw)
        cp = default_consensus_params()
        if "consensus_params" in d and d["consensus_params"]:
            cpd = d["consensus_params"]
            if "block" in cpd:
                cp.block.max_bytes = int(cpd["block"].get("max_bytes", cp.block.max_bytes))
                cp.block.max_gas = int(cpd["block"].get("max_gas", cp.block.max_gas))
            if "evidence" in cpd:
                cp.evidence.max_age_num_blocks = int(
                    cpd["evidence"].get("max_age_num_blocks", cp.evidence.max_age_num_blocks)
                )
                cp.evidence.max_age_duration_ns = int(
                    cpd["evidence"].get("max_age_duration", cp.evidence.max_age_duration_ns)
                )
                cp.evidence.max_bytes = int(cpd["evidence"].get("max_bytes", cp.evidence.max_bytes))
            if "validator" in cpd:
                cp.validator.pub_key_types = list(
                    cpd["validator"].get("pub_key_types", cp.validator.pub_key_types)
                )
            if "abci" in cpd:
                cp.abci.vote_extensions_enable_height = int(
                    cpd["abci"].get("vote_extensions_enable_height", 0)
                )
        validators = []
        for vd in d.get("validators", []):
            ctor = _PUB_KEY_DECODERS.get(
                vd["pub_key"].get("type", "tendermint/PubKeyEd25519"), ed25519.PubKey
            )
            pub = ctor(base64.b64decode(vd["pub_key"]["value"]))
            validators.append(
                GenesisValidator(
                    address=bytes.fromhex(vd["address"]) if vd.get("address") else pub.address(),
                    pub_key=pub,
                    power=int(vd["power"]),
                    name=vd.get("name", ""),
                )
            )
        ts = cmttime.Timestamp.zero()
        if d.get("genesis_time"):
            # RFC3339 parse (nanosecond-truncating)
            from datetime import datetime

            raw_t = d["genesis_time"].replace("Z", "+00:00")
            frac_ns = 0
            if "." in raw_t:
                base_part, rest = raw_t.split(".", 1)
                frac, tz = rest[:-6], rest[-6:]
                frac_ns = int(frac.ljust(9, "0")[:9])
                raw_t = base_part + tz
            dt = datetime.fromisoformat(raw_t)
            ts = cmttime.Timestamp(int(dt.timestamp()), frac_ns)
        doc = cls(
            genesis_time=ts,
            chain_id=d["chain_id"],
            initial_height=int(d.get("initial_height", 1)),
            consensus_params=cp,
            validators=validators,
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=json.dumps(d.get("app_state", {})).encode(),
        )
        doc.validate_and_complete()
        return doc
