"""StateStore (reference: state/store.go:61-600).

Persists: the State snapshot, FinalizeBlock responses per height (for
replay/indexing/rpc), validator sets per height (evidence + light client
lookups), consensus params per height.

The port's copy of cometbft_tpu/state/store.py.
"""

from __future__ import annotations

import base64
import json

from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.store.db import KVStore
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet, pub_key_from_proto, pub_key_to_proto


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


class StateStore:
    def __init__(self, db: KVStore):
        self.db = db

    # -------------------------------------------------------------- state

    def save(self, state: State) -> None:
        """Persist the snapshot + per-height valset/params rows
        (state/store.go Save)."""
        pairs: list[tuple[bytes, bytes | None]] = [(b"state", state.to_bytes())]
        # validators at H+1 (state.Validators) and H+2 (NextValidators)
        next_h = state.last_block_height + 1
        pairs.append((_hkey(b"V:", next_h + 1), _valset_bytes(state.next_validators)))
        if state.last_block_height == 0:
            # genesis: also record the initial set at initial_height
            pairs.append((_hkey(b"V:", state.initial_height), _valset_bytes(state.validators)))
        else:
            pairs.append((_hkey(b"V:", next_h), _valset_bytes(state.validators)))
        pairs.append((_hkey(b"CP:", next_h), state.to_bytes()))
        self.db.batch_set(pairs)

    def load(self) -> State | None:
        raw = self.db.get(b"state")
        return State.from_bytes(raw) if raw is not None else None

    def bootstrap(self, state: State) -> None:
        """Out-of-band state injection (statesync; state/store.go Bootstrap)."""
        if state.last_block_height > 0 and state.last_validators is not None:
            self.db.set(_hkey(b"V:", state.last_block_height), _valset_bytes(state.last_validators))
        self.save(state)

    # -------------------------------------------------- finalize responses

    def save_finalize_block_response(self, height: int, resp) -> None:
        from cometbft_tpu_torch.abci import codec

        self.db.set(_hkey(b"FBR:", height), json.dumps(codec._to_jsonable(resp)).encode())

    def load_finalize_block_response(self, height: int):
        from cometbft_tpu_torch.abci import codec
        from cometbft_tpu_torch.abci.types import ResponseFinalizeBlock

        raw = self.db.get(_hkey(b"FBR:", height))
        if raw is None:
            return None
        return codec._from_jsonable(ResponseFinalizeBlock, json.loads(raw))

    # ---------------------------------------------------- consensus params

    def load_consensus_params(self, height: int):
        """Consensus params in effect AT `height` (state/store.go
        LoadConsensusParams). save() writes a CP: row per height holding the
        state snapshot whose params apply to that height."""
        raw = self.db.get(_hkey(b"CP:", height))
        if raw is None:
            return None
        return State.from_bytes(raw).consensus_params

    # --------------------------------------------------------- validators

    def load_validators(self, height: int) -> ValidatorSet | None:
        raw = self.db.get(_hkey(b"V:", height))
        return _valset_from_bytes(raw) if raw is not None else None

    def save_validators(self, height: int, vals: ValidatorSet) -> None:
        """Historical valset row (state/store.go saveValidatorsInfo) —
        blocksync/statesync backfill and test fixtures."""
        self.db.set(_hkey(b"V:", height), _valset_bytes(vals))

    # ----------------------------------------------------- retain heights
    # Persisted so the pruner service resumes where it left off across
    # restarts (state/pruner.go keys; monotonicity enforced by the pruner).

    def save_retain_height(self, which: str, height: int) -> None:
        self.db.set(b"RH:" + which.encode(), height.to_bytes(8, "big"))

    def load_retain_height(self, which: str) -> int:
        raw = self.db.get(b"RH:" + which.encode())
        return int.from_bytes(raw, "big") if raw is not None else 0

    # ------------------------------------------------------------- prune

    def prune_abci_responses(self, retain_height: int) -> int:
        """Delete FinalizeBlock responses below retain_height only (the
        ABCI-results retain height moves independently of state rows,
        state/pruner.go:201-222)."""
        pruned = 0
        pairs: list[tuple[bytes, bytes | None]] = []
        for k, _ in list(self.db.iterate(b"FBR:", _hkey(b"FBR:", retain_height))):
            pairs.append((k, None))
            pruned += 1
        self.db.batch_set(pairs)
        return pruned

    def prune_states(self, retain_height: int) -> int:
        """Valset + params rows below retain_height. FinalizeBlock
        responses are NOT touched here — they live under the independent
        ABCI-results retain height (prune_abci_responses)."""
        pruned = 0
        pairs: list[tuple[bytes, bytes | None]] = []
        for prefix in (b"V:", b"CP:"):
            for k, _ in list(self.db.iterate(prefix, _hkey(prefix, retain_height))):
                pairs.append((k, None))
                pruned += 1
        self.db.batch_set(pairs)
        return pruned


def _valset_bytes(vs: ValidatorSet | None) -> bytes:
    doc = {
        "validators": [
            {
                "pub_key": base64.b64encode(pub_key_to_proto(v.pub_key)).decode(),
                "power": v.voting_power,
                "priority": v.proposer_priority,
            }
            for v in (vs.validators if vs else [])
        ],
        "proposer": vs.proposer.address.hex() if vs and vs.proposer else None,
    }
    return json.dumps(doc, separators=(",", ":")).encode()


def _valset_from_bytes(raw: bytes) -> ValidatorSet:
    doc = json.loads(raw)
    vs = ValidatorSet.__new__(ValidatorSet)
    vs.validators = []
    for vd in doc["validators"]:
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
    if doc.get("proposer"):
        addr = bytes.fromhex(doc["proposer"])
        for v in vs.validators:
            if v.address == addr:
                vs.proposer = v
                break
    return vs
