"""In-process kvstore example application.

Functional mirror of the reference example app (abci/example/kvstore):
'key=value' txs stored in a map; 'val:BASE64PUBKEY!POWER' txs update the
validator set; AppHash commits to the state deterministically. Used by the
multi-validator consensus harness exactly as the reference uses its kvstore
in consensus tests (consensus/common_test.go).

The port's copy of cometbft_tpu/abci/kvstore.py.
"""

from __future__ import annotations

import base64
import hashlib
import json

from cometbft_tpu_torch.abci import types as abci

VALIDATOR_PREFIX = "val:"


class KVStoreApplication(abci.BaseApplication):
    def __init__(self):
        self.state: dict[str, str] = {}
        self.height = 0
        self.app_hash = b"\x00" * 8
        self.pending_updates: list[abci.ValidatorUpdate] = []
        self.validators: dict[bytes, int] = {}  # pubkey -> power
        self.staged: dict[str, str] | None = None
        self.staged_hash = b""
        self.tx_count = 0
        self.snapshot_interval = 0  # 0 = snapshots off
        self.snapshots: list[tuple[abci.Snapshot, list[bytes]]] = []
        self._restoring: tuple[abci.Snapshot, list[bytes]] | None = None

    # ------------------------------------------------------------ helpers

    def _is_validator_tx(self, tx: bytes) -> bool:
        return tx.startswith(VALIDATOR_PREFIX.encode())

    def _parse_validator_tx(self, tx: bytes) -> abci.ValidatorUpdate | None:
        try:
            body = tx.decode()[len(VALIDATOR_PREFIX):]
            pub_b64, power_s = body.split("!")
            return abci.ValidatorUpdate(
                pub_key_type="ed25519",
                pub_key_bytes=base64.b64decode(pub_b64),
                power=int(power_s),
            )
        except Exception:  # noqa: BLE001
            return None

    def _parse_kv(self, tx: bytes) -> tuple[str, str] | None:
        try:
            s = tx.decode()
        except UnicodeDecodeError:
            return None
        if "=" in s:
            k, v = s.split("=", 1)
            return k, v
        return s, s

    def _compute_hash(self, state: dict[str, str], height: int) -> bytes:
        blob = json.dumps(state, sort_keys=True).encode() + height.to_bytes(8, "big")
        return hashlib.sha256(blob).digest()

    # ------------------------------------------------------------- ABCI

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=json.dumps({"size": len(self.state)}),
            version="0.1.0",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash if self.height else b"",
        )

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        for vu in req.validators:
            self.validators[vu.pub_key_bytes] = vu.power
        # seed state from genesis app_state (reference kvstore app.go
        # InitChain: a JSON object of initial key/values)
        if req.app_state_bytes:
            try:
                seed = json.loads(req.app_state_bytes)
            except ValueError:  # covers JSONDecodeError AND UnicodeDecodeError
                seed = None
            if isinstance(seed, dict):
                for k, v in seed.items():
                    if isinstance(k, str) and isinstance(v, str):
                        self.state[k] = v
        return abci.ResponseInitChain(app_hash=self.app_hash)

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        if self._is_validator_tx(req.tx):
            if self._parse_validator_tx(req.tx) is None:
                return abci.ResponseCheckTx(code=1, log="invalid validator tx")
            return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)
        if self._parse_kv(req.tx) is None:
            return abci.ResponseCheckTx(code=1, log="tx must be utf-8 key=value")
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)

    def process_proposal(self, req: abci.RequestProcessProposal) -> abci.ResponseProcessProposal:
        for tx in req.txs:
            if self._is_validator_tx(tx):
                if self._parse_validator_tx(tx) is None:
                    return abci.ResponseProcessProposal(status=abci.ProposalStatus.REJECT)
            elif self._parse_kv(tx) is None:
                return abci.ResponseProcessProposal(status=abci.ProposalStatus.REJECT)
        return abci.ResponseProcessProposal(status=abci.ProposalStatus.ACCEPT)

    def finalize_block(self, req: abci.RequestFinalizeBlock) -> abci.ResponseFinalizeBlock:
        staged = dict(self.state)
        if req.misbehavior:
            # make Misbehavior deliveries app-observable (queryable via
            # abci_query) — deterministic: req.misbehavior comes from the
            # committed block, identical on every node
            prev = int(staged.get("__misbehavior_count__", "0"))
            staged["__misbehavior_count__"] = str(prev + len(req.misbehavior))
        results: list[abci.ExecTxResult] = []
        updates: list[abci.ValidatorUpdate] = []
        for tx in req.txs:
            if self._is_validator_tx(tx):
                vu = self._parse_validator_tx(tx)
                if vu is None:
                    results.append(abci.ExecTxResult(code=1, log="invalid validator tx"))
                    continue
                updates.append(vu)
                self.validators[vu.pub_key_bytes] = vu.power
                results.append(abci.ExecTxResult(code=abci.CODE_TYPE_OK))
                continue
            kv = self._parse_kv(tx)
            if kv is None:
                results.append(abci.ExecTxResult(code=1, log="invalid tx"))
                continue
            k, v = kv
            staged[k] = v
            self.tx_count += 1
            results.append(
                abci.ExecTxResult(
                    code=abci.CODE_TYPE_OK,
                    events=[
                        abci.Event(
                            type_="app",
                            attributes=[
                                abci.EventAttribute(key="key", value=k),
                                abci.EventAttribute(key="creator", value="kvstore"),
                            ],
                        )
                    ],
                )
            )
        self.staged = staged
        self.staged_hash = self._compute_hash(staged, req.height)
        self.pending_updates = updates
        return abci.ResponseFinalizeBlock(
            tx_results=results,
            validator_updates=updates,
            app_hash=self.staged_hash,
        )

    def commit(self, req: abci.RequestCommit) -> abci.ResponseCommit:
        if self.staged is not None:
            self.state = self.staged
            self.app_hash = self.staged_hash
            self.staged = None
            self.height += 1
        if self.snapshot_interval and self.height % self.snapshot_interval == 0:
            self._take_snapshot()
        return abci.ResponseCommit(retain_height=0)

    # ------------------------------------------------------- state sync
    # (reference shape: abci/example/kvstore has no snapshots; the e2e app
    # does — test/e2e/app/snapshots.go. Same JSON-chunks design here.)

    SNAPSHOT_FORMAT = 1
    SNAPSHOT_CHUNK_SIZE = 1 << 16

    def _take_snapshot(self) -> None:
        import hashlib

        payload = json.dumps(
            {"height": self.height, "app_hash": self.app_hash.hex(),
             "state": self.state, "tx_count": self.tx_count},
            sort_keys=True,
        ).encode()
        chunks = [
            payload[i:i + self.SNAPSHOT_CHUNK_SIZE]
            for i in range(0, max(len(payload), 1), self.SNAPSHOT_CHUNK_SIZE)
        ]
        snap = abci.Snapshot(
            height=self.height, format_=self.SNAPSHOT_FORMAT,
            chunks=len(chunks), hash=hashlib.sha256(payload).digest(),
        )
        self.snapshots.append((snap, chunks))
        del self.snapshots[:-5]  # keep the 5 newest

    def list_snapshots(self, req: abci.RequestListSnapshots) -> abci.ResponseListSnapshots:
        return abci.ResponseListSnapshots(snapshots=[s for s, _ in self.snapshots])

    def load_snapshot_chunk(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        for snap, chunks in self.snapshots:
            if (snap.height == req.height and snap.format_ == req.format_
                    and 0 <= req.chunk < len(chunks)):
                return abci.ResponseLoadSnapshotChunk(chunk=chunks[req.chunk])
        return abci.ResponseLoadSnapshotChunk()

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        s = req.snapshot
        if s is None or s.format_ != self.SNAPSHOT_FORMAT:
            return abci.ResponseOfferSnapshot(
                result=abci.OfferSnapshotResult.REJECT_FORMAT)
        self._restoring = (s, [])
        return abci.ResponseOfferSnapshot(result=abci.OfferSnapshotResult.ACCEPT)

    def apply_snapshot_chunk(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        import hashlib

        if self._restoring is None:
            return abci.ResponseApplySnapshotChunk(
                result=abci.ApplySnapshotChunkResult.ABORT)
        snap, got = self._restoring
        got.append(req.chunk)
        if len(got) < snap.chunks:
            return abci.ResponseApplySnapshotChunk(
                result=abci.ApplySnapshotChunkResult.ACCEPT)
        payload = b"".join(got)
        if hashlib.sha256(payload).digest() != snap.hash:
            self._restoring = None
            return abci.ResponseApplySnapshotChunk(
                result=abci.ApplySnapshotChunkResult.REJECT_SNAPSHOT)
        doc = json.loads(payload)
        self.state = doc["state"]
        self.height = doc["height"]
        self.app_hash = bytes.fromhex(doc["app_hash"])
        self.tx_count = doc.get("tx_count", 0)
        self._restoring = None
        return abci.ResponseApplySnapshotChunk(
            result=abci.ApplySnapshotChunkResult.ACCEPT)

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        key = req.data.decode()
        if req.path == "/store" or req.path == "":
            val = self.state.get(key)
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK,
                key=req.data,
                value=val.encode() if val is not None else b"",
                log="exists" if val is not None else "does not exist",
                height=self.height,
            )
        return abci.ResponseQuery(code=1, log=f"unknown path {req.path}")
