"""State — the committed-chain snapshot (reference: state/state.go).

Validator-set offsets (state/state.go:41-60): after applying block H,
`validators` is the set for H+1, `next_validators` for H+2, and
`last_validators` the set that signed H (used to verify H's LastCommit and
sent to the app as CommitInfo).

The port's copy of cometbft_tpu/state/state.py.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field, replace

from cometbft_tpu_torch.types.basic import BlockID
from cometbft_tpu_torch.types.block import BLOCK_PROTOCOL, Block, Consensus, Data, EvidenceData, Header
from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.params import ConsensusParams, default_consensus_params
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet, pub_key_from_proto, pub_key_to_proto
from cometbft_tpu_torch.utils import cmttime


@dataclass
class State:
    chain_id: str
    initial_height: int
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    validators: ValidatorSet | None = None
    next_validators: ValidatorSet | None = None
    last_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = field(default_factory=default_consensus_params)
    last_height_consensus_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""
    app_version: int = 0

    def copy(self) -> "State":
        return replace(
            self,
            validators=self.validators.copy() if self.validators else None,
            next_validators=self.next_validators.copy() if self.next_validators else None,
            last_validators=self.last_validators.copy() if self.last_validators else None,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    @classmethod
    def from_genesis(cls, gdoc: GenesisDoc) -> "State":
        """state/state.go MakeGenesisState."""
        val_set = gdoc.validator_set()
        next_vals = val_set.copy()
        next_vals.increment_proposer_priority(1)
        return cls(
            chain_id=gdoc.chain_id,
            initial_height=gdoc.initial_height,
            last_block_height=0,
            last_block_time=gdoc.genesis_time,
            validators=val_set,
            next_validators=next_vals,
            last_validators=ValidatorSet([]),
            last_height_validators_changed=gdoc.initial_height,
            consensus_params=gdoc.consensus_params,
            last_height_consensus_params_changed=gdoc.initial_height,
            app_hash=gdoc.app_hash,
        )

    # ------------------------------------------------------------ blocks

    def make_block(
        self,
        height: int,
        txs: list[bytes],
        last_commit: Commit,
        evidence: list,
        proposer_address: bytes,
        block_time: cmttime.Timestamp | None = None,
    ) -> Block:
        """state/state.go MakeBlock: header populated from this state."""
        header = Header(
            version=Consensus(block=BLOCK_PROTOCOL, app=self.app_version),
            chain_id=self.chain_id,
            height=height,
            time=block_time or cmttime.now(),
            last_block_id=self.last_block_id,
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            proposer_address=proposer_address,
        )
        block = Block(
            header=header,
            data=Data(txs=list(txs)),
            evidence=EvidenceData(evidence=list(evidence)),
            last_commit=last_commit,
        )
        block.fill_header()
        return block

    # ------------------------------------------------------ serialization

    def to_bytes(self) -> bytes:
        def valset(vs: ValidatorSet | None):
            if vs is None:
                return None
            return {
                "validators": [
                    {
                        "pub_key": base64.b64encode(pub_key_to_proto(v.pub_key)).decode(),
                        "power": v.voting_power,
                        "priority": v.proposer_priority,
                    }
                    for v in vs.validators
                ],
                "proposer": vs.proposer.address.hex() if vs.proposer else None,
            }

        doc = {
            "chain_id": self.chain_id,
            "initial_height": self.initial_height,
            "last_block_height": self.last_block_height,
            "last_block_id": base64.b64encode(self.last_block_id.to_proto()).decode(),
            "last_block_time": [self.last_block_time.seconds, self.last_block_time.nanos],
            "validators": valset(self.validators),
            "next_validators": valset(self.next_validators),
            "last_validators": valset(self.last_validators),
            "last_height_validators_changed": self.last_height_validators_changed,
            "consensus_params": {
                "block_max_bytes": self.consensus_params.block.max_bytes,
                "block_max_gas": self.consensus_params.block.max_gas,
                "evidence_max_age_num_blocks": self.consensus_params.evidence.max_age_num_blocks,
                "evidence_max_age_duration_ns": self.consensus_params.evidence.max_age_duration_ns,
                "evidence_max_bytes": self.consensus_params.evidence.max_bytes,
                "pub_key_types": self.consensus_params.validator.pub_key_types,
                "app_version": self.consensus_params.version.app,
                "vote_extensions_enable_height": self.consensus_params.abci.vote_extensions_enable_height,
            },
            "last_height_consensus_params_changed": self.last_height_consensus_params_changed,
            "last_results_hash": self.last_results_hash.hex(),
            "app_hash": self.app_hash.hex(),
            "app_version": self.app_version,
        }
        return json.dumps(doc, separators=(",", ":")).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "State":
        doc = json.loads(raw)

        def valset(d) -> ValidatorSet | None:
            if d is None:
                return None
            vs = ValidatorSet.__new__(ValidatorSet)
            vs.validators = []
            for vd in d["validators"]:
                pk = pub_key_from_proto(base64.b64decode(vd["pub_key"]))
                vs.validators.append(
                    Validator(
                        address=pk.address(),
                        pub_key=pk,
                        voting_power=vd["power"],
                        proposer_priority=vd["priority"],
                    )
                )
            vs._total_voting_power = None
            vs.proposer = None
            if d.get("proposer"):
                addr = bytes.fromhex(d["proposer"])
                for v in vs.validators:
                    if v.address == addr:
                        vs.proposer = v
                        break
            return vs

        cp = default_consensus_params()
        cpd = doc["consensus_params"]
        cp.block.max_bytes = cpd["block_max_bytes"]
        cp.block.max_gas = cpd["block_max_gas"]
        cp.evidence.max_age_num_blocks = cpd["evidence_max_age_num_blocks"]
        cp.evidence.max_age_duration_ns = cpd["evidence_max_age_duration_ns"]
        cp.evidence.max_bytes = cpd["evidence_max_bytes"]
        cp.validator.pub_key_types = cpd["pub_key_types"]
        cp.version.app = cpd["app_version"]
        cp.abci.vote_extensions_enable_height = cpd["vote_extensions_enable_height"]
        return cls(
            chain_id=doc["chain_id"],
            initial_height=doc["initial_height"],
            last_block_height=doc["last_block_height"],
            last_block_id=BlockID.from_proto(base64.b64decode(doc["last_block_id"])),
            last_block_time=cmttime.Timestamp(*doc["last_block_time"]),
            validators=valset(doc["validators"]),
            next_validators=valset(doc["next_validators"]),
            last_validators=valset(doc["last_validators"]),
            last_height_validators_changed=doc["last_height_validators_changed"],
            consensus_params=cp,
            last_height_consensus_params_changed=doc["last_height_consensus_params_changed"],
            last_results_hash=bytes.fromhex(doc["last_results_hash"]),
            app_hash=bytes.fromhex(doc["app_hash"]),
            app_version=doc.get("app_version", 0),
        )
