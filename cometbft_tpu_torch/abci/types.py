"""ABCI request/response types + the 17-method Application interface.

Reference: abci/types/application.go:9-35 (interface),
proto/tendermint/abci/types.proto (wire shapes). Python dataclasses carry
the same fields; the socket transport (client.py/server.py) maps them to the
wire via a compact tagged encoding.

The port's copy of cometbft_tpu/abci/types.py.
"""

from __future__ import annotations

import enum
from abc import ABC
from dataclasses import dataclass, field

from cometbft_tpu_torch.utils import cmttime

CODE_TYPE_OK = 0


class CheckTxType(enum.IntEnum):
    NEW = 0
    RECHECK = 1


class ProposalStatus(enum.IntEnum):
    """ResponseProcessProposal.Status."""

    UNKNOWN = 0
    ACCEPT = 1
    REJECT = 2


class VerifyStatus(enum.IntEnum):
    """ResponseVerifyVoteExtension.Status."""

    UNKNOWN = 0
    ACCEPT = 1
    REJECT = 2


class OfferSnapshotResult(enum.IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    REJECT = 3
    REJECT_FORMAT = 4
    REJECT_SENDER = 5


class ApplySnapshotChunkResult(enum.IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    RETRY = 3
    RETRY_SNAPSHOT = 4
    REJECT_SNAPSHOT = 5


# ---------------------------------------------------------------- common


@dataclass
class EventAttribute:
    key: str
    value: str
    index: bool = True


@dataclass
class Event:
    type_: str
    attributes: list[EventAttribute] = field(default_factory=list)


@dataclass
class ValidatorUpdate:
    pub_key_type: str
    pub_key_bytes: bytes
    power: int


@dataclass
class VoteInfo:
    validator_address: bytes
    validator_power: int
    block_id_flag: int  # types.BlockIDFlag


@dataclass
class ExtendedVoteInfo:
    validator_address: bytes
    validator_power: int
    block_id_flag: int
    vote_extension: bytes = b""
    extension_signature: bytes = b""


@dataclass
class CommitInfo:
    round_: int
    votes: list[VoteInfo] = field(default_factory=list)


@dataclass
class ExtendedCommitInfo:
    round_: int
    votes: list[ExtendedVoteInfo] = field(default_factory=list)


@dataclass
class Misbehavior:
    type_: str  # "DUPLICATE_VOTE" | "LIGHT_CLIENT_ATTACK"
    validator_address: bytes
    validator_power: int
    height: int
    time: cmttime.Timestamp
    total_voting_power: int


@dataclass
class Snapshot:
    height: int
    format_: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


# ---------------------------------------------------------------- requests


@dataclass
class RequestEcho:
    message: str = ""


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type_: CheckTxType = CheckTxType.NEW


@dataclass
class RequestInitChain:
    time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    chain_id: str = ""
    consensus_params: object | None = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class RequestPrepareProposal:
    max_tx_bytes: int = 0
    txs: list[bytes] = field(default_factory=list)
    local_last_commit: ExtendedCommitInfo = field(default_factory=lambda: ExtendedCommitInfo(0))
    misbehavior: list[Misbehavior] = field(default_factory=list)
    height: int = 0
    time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class RequestProcessProposal:
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=lambda: CommitInfo(0))
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class RequestFinalizeBlock:
    txs: list[bytes] = field(default_factory=list)
    decided_last_commit: CommitInfo = field(default_factory=lambda: CommitInfo(0))
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class RequestExtendVote:
    hash: bytes = b""
    height: int = 0
    round_: int = 0
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=lambda: CommitInfo(0))
    misbehavior: list[Misbehavior] = field(default_factory=list)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""
    time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)


@dataclass
class RequestVerifyVoteExtension:
    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""


@dataclass
class RequestCommit:
    pass


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class RequestOfferSnapshot:
    snapshot: Snapshot | None = None
    app_hash: bytes = b""


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format_: int = 0
    chunk: int = 0


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


@dataclass
class RequestFlush:
    pass


# ---------------------------------------------------------------- responses


@dataclass
class ResponseEcho:
    message: str = ""


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: list = field(default_factory=list)
    height: int = 0
    codespace: str = ""


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseInitChain:
    consensus_params: object | None = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class ResponsePrepareProposal:
    txs: list[bytes] = field(default_factory=list)


@dataclass
class ResponseProcessProposal:
    status: ProposalStatus = ProposalStatus.UNKNOWN

    def is_accepted(self) -> bool:
        return self.status == ProposalStatus.ACCEPT


@dataclass
class ExecTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def hash_bytes(self) -> bytes:
        """Deterministic encoding for LastResultsHash (reference:
        types/results.go ABCIResults.Hash — only Code/Data/GasWanted/GasUsed
        are hashed, deterministic fields)."""
        from cometbft_tpu_torch.utils import protobuf as pb

        w = pb.Writer()
        w.uvarint(1, self.code)
        w.bytes(2, self.data)
        w.varint_i64(5, self.gas_wanted)
        w.varint_i64(6, self.gas_used)
        return w.output()


@dataclass
class ResponseFinalizeBlock:
    events: list[Event] = field(default_factory=list)
    tx_results: list[ExecTxResult] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: object | None = None
    app_hash: bytes = b""


@dataclass
class ResponseExtendVote:
    vote_extension: bytes = b""


@dataclass
class ResponseVerifyVoteExtension:
    status: VerifyStatus = VerifyStatus.UNKNOWN

    def is_accepted(self) -> bool:
        return self.status == VerifyStatus.ACCEPT


@dataclass
class ResponseCommit:
    retain_height: int = 0


@dataclass
class ResponseListSnapshots:
    snapshots: list[Snapshot] = field(default_factory=list)


@dataclass
class ResponseOfferSnapshot:
    result: OfferSnapshotResult = OfferSnapshotResult.UNKNOWN


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


@dataclass
class ResponseApplySnapshotChunk:
    result: ApplySnapshotChunkResult = ApplySnapshotChunkResult.UNKNOWN
    refetch_chunks: list[int] = field(default_factory=list)
    reject_senders: list[str] = field(default_factory=list)


@dataclass
class ResponseFlush:
    pass


# ---------------------------------------------------------------- interface


class Application(ABC):
    """The 17-method ABCI 2.0 surface (abci/types/application.go:9-35),
    grouped by logical connection (proxy multiplexes 4 of them,
    proxy/app_conn.go:18-56)."""

    # Info/Query connection
    def info(self, req: RequestInfo) -> ResponseInfo: ...

    def query(self, req: RequestQuery) -> ResponseQuery: ...

    # Mempool connection
    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx: ...

    # Consensus connection
    def init_chain(self, req: RequestInitChain) -> ResponseInitChain: ...

    def prepare_proposal(self, req: RequestPrepareProposal) -> ResponsePrepareProposal: ...

    def process_proposal(self, req: RequestProcessProposal) -> ResponseProcessProposal: ...

    def finalize_block(self, req: RequestFinalizeBlock) -> ResponseFinalizeBlock: ...

    def extend_vote(self, req: RequestExtendVote) -> ResponseExtendVote: ...

    def verify_vote_extension(self, req: RequestVerifyVoteExtension) -> ResponseVerifyVoteExtension: ...

    def commit(self, req: RequestCommit) -> ResponseCommit: ...

    # State-sync connection
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots: ...

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot: ...

    def load_snapshot_chunk(self, req: RequestLoadSnapshotChunk) -> ResponseLoadSnapshotChunk: ...

    def apply_snapshot_chunk(self, req: RequestApplySnapshotChunk) -> ResponseApplySnapshotChunk: ...


class BaseApplication(Application):
    """No-op defaults (abci/types/application.go:40-110): accept every tx,
    accept every proposal, empty snapshots."""

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery(code=CODE_TYPE_OK)

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx(code=CODE_TYPE_OK)

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def prepare_proposal(self, req: RequestPrepareProposal) -> ResponsePrepareProposal:
        # default: pass txs through within the byte budget
        txs, total = [], 0
        for tx in req.txs:
            total += len(tx)
            if req.max_tx_bytes and total > req.max_tx_bytes:
                break
            txs.append(tx)
        return ResponsePrepareProposal(txs=txs)

    def process_proposal(self, req: RequestProcessProposal) -> ResponseProcessProposal:
        return ResponseProcessProposal(status=ProposalStatus.ACCEPT)

    def finalize_block(self, req: RequestFinalizeBlock) -> ResponseFinalizeBlock:
        return ResponseFinalizeBlock(
            tx_results=[ExecTxResult(code=CODE_TYPE_OK) for _ in req.txs]
        )

    def extend_vote(self, req: RequestExtendVote) -> ResponseExtendVote:
        return ResponseExtendVote()

    def verify_vote_extension(self, req: RequestVerifyVoteExtension) -> ResponseVerifyVoteExtension:
        return ResponseVerifyVoteExtension(status=VerifyStatus.ACCEPT)

    def commit(self, req: RequestCommit) -> ResponseCommit:
        return ResponseCommit()

    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot(result=OfferSnapshotResult.ABORT)

    def load_snapshot_chunk(self, req: RequestLoadSnapshotChunk) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req: RequestApplySnapshotChunk) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk(result=ApplySnapshotChunkResult.ABORT)
