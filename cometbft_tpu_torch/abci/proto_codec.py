"""gogoproto wire codec for the ABCI boundary — reference interop.

This is the protobuf analog of codec.py's framework-native JSON frames: the
exact varint-length-delimited `tendermint.abci.Request`/`Response` oneof
encoding the reference speaks on its ABCI socket
(abci/client/socket_client.go:1-60 + libs/protoio/writer.go:93), hand-rolled
over utils/protobuf. Field numbers and wire rules follow
proto/tendermint/abci/types.proto:43-60 (Request oneof), :199-221 (Response
oneof) and the embedded tendermint.types / tendermint.crypto messages;
gogoproto's non-nullable message fields (always emitted) and stdtime/
stdduration encodings are preserved so the bytes match the reference's
generated marshallers. With this codec the reference's own kvstore app (or
any existing ABCI app) can serve this node, and this framework's apps can
serve a reference node.

Byte-exactness is asserted in tests/test_abci_proto_wire.py against
python-protobuf bindings compiled at test time from an independently
authored schema with the same field numbers.

The port's copy of cometbft_tpu/abci/proto_codec.py.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.types.params import (
    ABCIParams,
    BlockParams,
    ConsensusParamsUpdate,
    EvidenceParams,
    ValidatorParams,
    VersionParams,
)
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb

MAX_MSG_SIZE = 64 * 1024 * 1024  # reference: abci/types/messages.go limits

# ---------------------------------------------------------------------------
# oneof tables (types.proto:43-60 / 199-221)
# ---------------------------------------------------------------------------

REQUEST_FIELDS = {
    "echo": 1, "flush": 2, "info": 3, "init_chain": 5, "query": 6,
    "check_tx": 8, "commit": 11, "list_snapshots": 12, "offer_snapshot": 13,
    "load_snapshot_chunk": 14, "apply_snapshot_chunk": 15,
    "prepare_proposal": 16, "process_proposal": 17, "extend_vote": 18,
    "verify_vote_extension": 19, "finalize_block": 20,
}
RESPONSE_FIELDS = {
    "exception": 1, "echo": 2, "flush": 3, "info": 4, "init_chain": 6,
    "query": 7, "check_tx": 9, "commit": 12, "list_snapshots": 13,
    "offer_snapshot": 14, "load_snapshot_chunk": 15,
    "apply_snapshot_chunk": 16, "prepare_proposal": 17,
    "process_proposal": 18, "extend_vote": 19, "verify_vote_extension": 20,
    "finalize_block": 21,
}
_REQ_BY_FIELD = {v: k for k, v in REQUEST_FIELDS.items()}
_RESP_BY_FIELD = {v: k for k, v in RESPONSE_FIELDS.items()}

_MISBEHAVIOR_TYPES = {"UNKNOWN": 0, "DUPLICATE_VOTE": 1, "LIGHT_CLIENT_ATTACK": 2}
_MISBEHAVIOR_NAMES = {v: k for k, v in _MISBEHAVIOR_TYPES.items()}

# tendermint.crypto.PublicKey oneof (crypto/keys.proto:9-17); sr25519 rides
# field 3 — a documented framework extension (the reference dropped sr25519
# from the oneof; interop peers that lack it reject such updates anyway)
_PUBKEY_FIELDS = {"ed25519": 1, "secp256k1": 2, "sr25519": 3}
_PUBKEY_NAMES = {v: k for k, v in _PUBKEY_FIELDS.items()}


# ---------------------------------------------------------------------------
# shared sub-messages
# ---------------------------------------------------------------------------


def _ts(t: cmttime.Timestamp | None) -> bytes:
    if t is None:
        return b""
    return pb.timestamp_bytes(t.seconds, t.nanos)


def _dec_ts(data: bytes) -> cmttime.Timestamp:
    r = pb.Reader(data)
    secs = nanos = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            secs = r.read_varint_i64()
        elif f == 2:
            nanos = r.read_varint_i64()
        else:
            r.skip(w)
    return cmttime.Timestamp(secs, nanos)


def _duration(ns: int) -> bytes:
    # truncation toward zero so seconds and nanos share a sign (gogoproto /
    # protobuf Duration rule: -1.5s is seconds=-1, nanos=-500000000, never
    # the mixed-sign pair Python floor division would produce)
    secs, nanos = divmod(abs(ns), 1_000_000_000)
    if ns < 0:
        secs, nanos = -secs, -nanos
    w = pb.Writer()
    w.varint_i64(1, secs)
    w.varint_i64(2, nanos)
    return w.output()


def _dec_duration(data: bytes) -> int:
    r = pb.Reader(data)
    secs = nanos = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            secs = r.read_varint_i64()
        elif f == 2:
            nanos = r.read_varint_i64()
        else:
            r.skip(w)
    return secs * 1_000_000_000 + nanos


def _enc_validator(address: bytes, power: int) -> bytes:
    w = pb.Writer()
    w.bytes(1, address)
    w.varint_i64(3, power)
    return w.output()


def _dec_validator(data: bytes) -> tuple[bytes, int]:
    r = pb.Reader(data)
    addr, power = b"", 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            addr = r.read_bytes()
        elif f == 3:
            power = r.read_varint_i64()
        else:
            r.skip(w)
    return addr, power


def _enc_vote_info(v: abci.VoteInfo) -> bytes:
    w = pb.Writer()
    w.message(1, _enc_validator(v.validator_address, v.validator_power),
              always=True)
    w.uvarint(3, int(v.block_id_flag))
    return w.output()


def _dec_vote_info(data: bytes) -> abci.VoteInfo:
    r = pb.Reader(data)
    addr, power, flag = b"", 0, 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            addr, power = _dec_validator(r.read_bytes())
        elif f == 3:
            flag = r.read_uvarint()
        else:
            r.skip(w)
    return abci.VoteInfo(validator_address=addr, validator_power=power,
                         block_id_flag=flag)


def _enc_ext_vote_info(v: abci.ExtendedVoteInfo) -> bytes:
    w = pb.Writer()
    w.message(1, _enc_validator(v.validator_address, v.validator_power),
              always=True)
    w.bytes(3, v.vote_extension)
    w.bytes(4, v.extension_signature)
    w.uvarint(5, int(v.block_id_flag))
    return w.output()


def _dec_ext_vote_info(data: bytes) -> abci.ExtendedVoteInfo:
    r = pb.Reader(data)
    addr, power, ext, sig, flag = b"", 0, b"", b"", 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            addr, power = _dec_validator(r.read_bytes())
        elif f == 3:
            ext = r.read_bytes()
        elif f == 4:
            sig = r.read_bytes()
        elif f == 5:
            flag = r.read_uvarint()
        else:
            r.skip(w)
    return abci.ExtendedVoteInfo(
        validator_address=addr, validator_power=power, block_id_flag=flag,
        vote_extension=ext, extension_signature=sig)


def _enc_commit_info(c: abci.CommitInfo) -> bytes:
    w = pb.Writer()
    w.varint_i64(1, c.round_)
    for v in c.votes:
        w.message(2, _enc_vote_info(v), always=True)
    return w.output()


def _dec_commit_info(data: bytes) -> abci.CommitInfo:
    r = pb.Reader(data)
    out = abci.CommitInfo(0)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.round_ = r.read_varint_i64()
        elif f == 2:
            out.votes.append(_dec_vote_info(r.read_bytes()))
        else:
            r.skip(w)
    return out


def _enc_ext_commit_info(c: abci.ExtendedCommitInfo) -> bytes:
    w = pb.Writer()
    w.varint_i64(1, c.round_)
    for v in c.votes:
        w.message(2, _enc_ext_vote_info(v), always=True)
    return w.output()


def _dec_ext_commit_info(data: bytes) -> abci.ExtendedCommitInfo:
    r = pb.Reader(data)
    out = abci.ExtendedCommitInfo(0)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.round_ = r.read_varint_i64()
        elif f == 2:
            out.votes.append(_dec_ext_vote_info(r.read_bytes()))
        else:
            r.skip(w)
    return out


def _enc_misbehavior(m: abci.Misbehavior) -> bytes:
    w = pb.Writer()
    w.uvarint(1, _MISBEHAVIOR_TYPES.get(m.type_, 0))
    w.message(2, _enc_validator(m.validator_address, m.validator_power),
              always=True)
    w.varint_i64(3, m.height)
    w.message(4, _ts(m.time), always=True)
    w.varint_i64(5, m.total_voting_power)
    return w.output()


def _dec_misbehavior(data: bytes) -> abci.Misbehavior:
    r = pb.Reader(data)
    kind, addr, power, height, t, tvp = 0, b"", 0, 0, cmttime.Timestamp.zero(), 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            kind = r.read_uvarint()
        elif f == 2:
            addr, power = _dec_validator(r.read_bytes())
        elif f == 3:
            height = r.read_varint_i64()
        elif f == 4:
            t = _dec_ts(r.read_bytes())
        elif f == 5:
            tvp = r.read_varint_i64()
        else:
            r.skip(w)
    return abci.Misbehavior(
        type_=_MISBEHAVIOR_NAMES.get(kind, "UNKNOWN"), validator_address=addr,
        validator_power=power, height=height, time=t, total_voting_power=tvp)


def _enc_snapshot(s: abci.Snapshot) -> bytes:
    w = pb.Writer()
    w.uvarint(1, s.height)
    w.uvarint(2, s.format_)
    w.uvarint(3, s.chunks)
    w.bytes(4, s.hash)
    w.bytes(5, s.metadata)
    return w.output()


def _dec_snapshot(data: bytes) -> abci.Snapshot:
    r = pb.Reader(data)
    s = abci.Snapshot(height=0, format_=0, chunks=0, hash=b"")
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            s.height = r.read_uvarint()
        elif f == 2:
            s.format_ = r.read_uvarint()
        elif f == 3:
            s.chunks = r.read_uvarint()
        elif f == 4:
            s.hash = r.read_bytes()
        elif f == 5:
            s.metadata = r.read_bytes()
        else:
            r.skip(w)
    return s


def _enc_validator_update(u: abci.ValidatorUpdate) -> bytes:
    pk = pb.Writer()
    pk.bytes(_PUBKEY_FIELDS.get(u.pub_key_type, 1), u.pub_key_bytes,
             always=True)
    w = pb.Writer()
    w.message(1, pk.output(), always=True)
    w.varint_i64(2, u.power)
    return w.output()


def _dec_validator_update(data: bytes) -> abci.ValidatorUpdate:
    r = pb.Reader(data)
    kt, kb, power = "ed25519", b"", 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            pk = pb.Reader(r.read_bytes())
            while not pk.at_end():
                pf, pw = pk.read_tag()
                if pf in _PUBKEY_NAMES:
                    kt = _PUBKEY_NAMES[pf]
                    kb = pk.read_bytes()
                else:
                    pk.skip(pw)
        elif f == 2:
            power = r.read_varint_i64()
        else:
            r.skip(w)
    return abci.ValidatorUpdate(pub_key_type=kt, pub_key_bytes=kb, power=power)


# -- tendermint.types.ConsensusParams (types/params.proto:13-18) ------------


def _enc_consensus_params(p) -> bytes | None:
    """Accepts ConsensusParams or ConsensusParamsUpdate (sections may be
    None); returns None for a nil params object."""
    if p is None:
        return None
    w = pb.Writer()
    b = getattr(p, "block", None)
    if b is not None:
        bw = pb.Writer()
        bw.varint_i64(1, b.max_bytes)
        bw.varint_i64(2, b.max_gas)
        w.message(1, bw.output(), always=True)
    e = getattr(p, "evidence", None)
    if e is not None:
        ew = pb.Writer()
        ew.varint_i64(1, e.max_age_num_blocks)
        ew.message(2, _duration(e.max_age_duration_ns), always=True)
        ew.varint_i64(3, e.max_bytes)
        w.message(2, ew.output(), always=True)
    v = getattr(p, "validator", None)
    if v is not None:
        vw = pb.Writer()
        for t in v.pub_key_types:
            vw.string(1, t, always=True)
        w.message(3, vw.output(), always=True)
    ver = getattr(p, "version", None)
    if ver is not None:
        vw = pb.Writer()
        vw.uvarint(1, ver.app)
        w.message(4, vw.output(), always=True)
    a = getattr(p, "abci", None)
    if a is not None:
        aw = pb.Writer()
        aw.varint_i64(1, a.vote_extensions_enable_height)
        w.message(5, aw.output(), always=True)
    return w.output()


def _dec_consensus_params(data: bytes) -> ConsensusParamsUpdate:
    out = ConsensusParamsUpdate()
    r = pb.Reader(data)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            b = pb.Reader(r.read_bytes())
            bp = BlockParams()
            while not b.at_end():
                bf, bw = b.read_tag()
                if bf == 1:
                    bp.max_bytes = b.read_varint_i64()
                elif bf == 2:
                    bp.max_gas = b.read_varint_i64()
                else:
                    b.skip(bw)
            out.block = bp
        elif f == 2:
            e = pb.Reader(r.read_bytes())
            ep = EvidenceParams()
            while not e.at_end():
                ef, ew = e.read_tag()
                if ef == 1:
                    ep.max_age_num_blocks = e.read_varint_i64()
                elif ef == 2:
                    ep.max_age_duration_ns = _dec_duration(e.read_bytes())
                elif ef == 3:
                    ep.max_bytes = e.read_varint_i64()
                else:
                    e.skip(ew)
            out.evidence = ep
        elif f == 3:
            v = pb.Reader(r.read_bytes())
            types = []
            while not v.at_end():
                vf, vw = v.read_tag()
                if vf == 1:
                    types.append(v.read_bytes().decode())
                else:
                    v.skip(vw)
            out.validator = ValidatorParams(pub_key_types=types)
        elif f == 4:
            v = pb.Reader(r.read_bytes())
            vp = VersionParams()
            while not v.at_end():
                vf, vw = v.read_tag()
                if vf == 1:
                    vp.app = v.read_uvarint()
                else:
                    v.skip(vw)
            out.version = vp
        elif f == 5:
            a = pb.Reader(r.read_bytes())
            ap = ABCIParams()
            while not a.at_end():
                af, aw = a.read_tag()
                if af == 1:
                    ap.vote_extensions_enable_height = a.read_varint_i64()
                else:
                    a.skip(aw)
            out.abci = ap
        else:
            r.skip(w)
    return out


def _enc_event(e: abci.Event) -> bytes:
    w = pb.Writer()
    w.string(1, e.type_)
    for a in e.attributes:
        aw = pb.Writer()
        aw.string(1, a.key)
        aw.string(2, a.value)
        aw.bool(3, a.index)
        w.message(2, aw.output(), always=True)
    return w.output()


def _dec_event(data: bytes) -> abci.Event:
    r = pb.Reader(data)
    out = abci.Event(type_="")
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.type_ = r.read_bytes().decode()
        elif f == 2:
            a = pb.Reader(r.read_bytes())
            attr = abci.EventAttribute(key="", value="", index=False)
            while not a.at_end():
                af, aw = a.read_tag()
                if af == 1:
                    attr.key = a.read_bytes().decode()
                elif af == 2:
                    attr.value = a.read_bytes().decode()
                elif af == 3:
                    attr.index = bool(a.read_uvarint())
                else:
                    a.skip(aw)
            out.attributes.append(attr)
        else:
            r.skip(w)
    return out


def _enc_tx_result_fields(w: pb.Writer, t) -> None:
    """Shared shape of ResponseCheckTx / ExecTxResult (fields 1-8)."""
    w.uvarint(1, t.code)
    w.bytes(2, t.data)
    w.string(3, t.log)
    w.string(4, t.info)
    w.varint_i64(5, t.gas_wanted)
    w.varint_i64(6, t.gas_used)
    for e in t.events:
        w.message(7, _enc_event(e), always=True)
    w.string(8, t.codespace)


def _dec_tx_result_fields(r: pb.Reader, out) -> None:
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.code = r.read_uvarint()
        elif f == 2:
            out.data = r.read_bytes()
        elif f == 3:
            out.log = r.read_bytes().decode()
        elif f == 4:
            out.info = r.read_bytes().decode()
        elif f == 5:
            out.gas_wanted = r.read_varint_i64()
        elif f == 6:
            out.gas_used = r.read_varint_i64()
        elif f == 7:
            out.events.append(_dec_event(r.read_bytes()))
        elif f == 8:
            out.codespace = r.read_bytes().decode()
        else:
            r.skip(w)


def _enc_proof_ops(ops: list) -> bytes | None:
    """tendermint.crypto.ProofOps: repeated ProofOp {type=1, key=2, data=3};
    elements may be objects with (type_, key, data) or 3-tuples."""
    if not ops:
        return None
    w = pb.Writer()
    for op in ops:
        if isinstance(op, tuple):
            t, k, d = op
        else:
            t, k, d = op.type_, op.key, op.data
        ow = pb.Writer()
        ow.string(1, t)
        ow.bytes(2, k)
        ow.bytes(3, d)
        w.message(1, ow.output(), always=True)
    return w.output()


def _dec_proof_ops(data: bytes) -> list:
    out = []
    r = pb.Reader(data)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            o = pb.Reader(r.read_bytes())
            t, k, d = "", b"", b""
            while not o.at_end():
                of, ow = o.read_tag()
                if of == 1:
                    t = o.read_bytes().decode()
                elif of == 2:
                    k = o.read_bytes()
                elif of == 3:
                    d = o.read_bytes()
                else:
                    o.skip(ow)
            out.append((t, k, d))
        else:
            r.skip(w)
    return out


# ---------------------------------------------------------------------------
# request bodies
# ---------------------------------------------------------------------------


def _enc_req_echo(q: abci.RequestEcho) -> bytes:
    return pb.Writer().string(1, q.message).output()


def _enc_req_flush(q) -> bytes:
    return b""


def _enc_req_info(q: abci.RequestInfo) -> bytes:
    w = pb.Writer()
    w.string(1, q.version)
    w.uvarint(2, q.block_version)
    w.uvarint(3, q.p2p_version)
    w.string(4, q.abci_version)
    return w.output()


def _enc_req_init_chain(q: abci.RequestInitChain) -> bytes:
    w = pb.Writer()
    w.message(1, _ts(q.time), always=True)
    w.string(2, q.chain_id)
    w.message(3, _enc_consensus_params(q.consensus_params))
    for u in q.validators:
        w.message(4, _enc_validator_update(u), always=True)
    w.bytes(5, q.app_state_bytes)
    w.varint_i64(6, q.initial_height)
    return w.output()


def _enc_req_query(q: abci.RequestQuery) -> bytes:
    w = pb.Writer()
    w.bytes(1, q.data)
    w.string(2, q.path)
    w.varint_i64(3, q.height)
    w.bool(4, q.prove)
    return w.output()


def _enc_req_check_tx(q: abci.RequestCheckTx) -> bytes:
    w = pb.Writer()
    w.bytes(1, q.tx)
    w.uvarint(2, int(q.type_))
    return w.output()


def _enc_req_offer_snapshot(q: abci.RequestOfferSnapshot) -> bytes:
    w = pb.Writer()
    if q.snapshot is not None:
        w.message(1, _enc_snapshot(q.snapshot), always=True)
    w.bytes(2, q.app_hash)
    return w.output()


def _enc_req_load_snapshot_chunk(q: abci.RequestLoadSnapshotChunk) -> bytes:
    w = pb.Writer()
    w.uvarint(1, q.height)
    w.uvarint(2, q.format_)
    w.uvarint(3, q.chunk)
    return w.output()


def _enc_req_apply_snapshot_chunk(q: abci.RequestApplySnapshotChunk) -> bytes:
    w = pb.Writer()
    w.uvarint(1, q.index)
    w.bytes(2, q.chunk)
    w.string(3, q.sender)
    return w.output()


def _enc_req_prepare_proposal(q: abci.RequestPrepareProposal) -> bytes:
    w = pb.Writer()
    w.varint_i64(1, q.max_tx_bytes)
    for tx in q.txs:
        w.bytes(2, tx, always=True)
    w.message(3, _enc_ext_commit_info(q.local_last_commit), always=True)
    for m in q.misbehavior:
        w.message(4, _enc_misbehavior(m), always=True)
    w.varint_i64(5, q.height)
    w.message(6, _ts(q.time), always=True)
    w.bytes(7, q.next_validators_hash)
    w.bytes(8, q.proposer_address)
    return w.output()


def _enc_req_process_proposal(q: abci.RequestProcessProposal) -> bytes:
    w = pb.Writer()
    for tx in q.txs:
        w.bytes(1, tx, always=True)
    w.message(2, _enc_commit_info(q.proposed_last_commit), always=True)
    for m in q.misbehavior:
        w.message(3, _enc_misbehavior(m), always=True)
    w.bytes(4, q.hash)
    w.varint_i64(5, q.height)
    w.message(6, _ts(q.time), always=True)
    w.bytes(7, q.next_validators_hash)
    w.bytes(8, q.proposer_address)
    return w.output()


def _enc_req_extend_vote(q: abci.RequestExtendVote) -> bytes:
    w = pb.Writer()
    w.bytes(1, q.hash)
    w.varint_i64(2, q.height)
    w.message(3, _ts(q.time), always=True)
    for tx in q.txs:
        w.bytes(4, tx, always=True)
    w.message(5, _enc_commit_info(q.proposed_last_commit), always=True)
    for m in q.misbehavior:
        w.message(6, _enc_misbehavior(m), always=True)
    w.bytes(7, q.next_validators_hash)
    w.bytes(8, q.proposer_address)
    return w.output()


def _enc_req_verify_vote_extension(q: abci.RequestVerifyVoteExtension) -> bytes:
    w = pb.Writer()
    w.bytes(1, q.hash)
    w.bytes(2, q.validator_address)
    w.varint_i64(3, q.height)
    w.bytes(4, q.vote_extension)
    return w.output()


def _enc_req_finalize_block(q: abci.RequestFinalizeBlock) -> bytes:
    w = pb.Writer()
    for tx in q.txs:
        w.bytes(1, tx, always=True)
    w.message(2, _enc_commit_info(q.decided_last_commit), always=True)
    for m in q.misbehavior:
        w.message(3, _enc_misbehavior(m), always=True)
    w.bytes(4, q.hash)
    w.varint_i64(5, q.height)
    w.message(6, _ts(q.time), always=True)
    w.bytes(7, q.next_validators_hash)
    w.bytes(8, q.proposer_address)
    return w.output()


_REQ_ENCODERS = {
    "echo": _enc_req_echo,
    "flush": _enc_req_flush,
    "info": _enc_req_info,
    "init_chain": _enc_req_init_chain,
    "query": _enc_req_query,
    "check_tx": _enc_req_check_tx,
    "commit": lambda q: b"",
    "list_snapshots": lambda q: b"",
    "offer_snapshot": _enc_req_offer_snapshot,
    "load_snapshot_chunk": _enc_req_load_snapshot_chunk,
    "apply_snapshot_chunk": _enc_req_apply_snapshot_chunk,
    "prepare_proposal": _enc_req_prepare_proposal,
    "process_proposal": _enc_req_process_proposal,
    "extend_vote": _enc_req_extend_vote,
    "verify_vote_extension": _enc_req_verify_vote_extension,
    "finalize_block": _enc_req_finalize_block,
}


def _dec_req_echo(data: bytes) -> abci.RequestEcho:
    r = pb.Reader(data)
    out = abci.RequestEcho()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.message = r.read_bytes().decode()
        else:
            r.skip(w)
    return out


def _dec_req_info(data: bytes) -> abci.RequestInfo:
    r = pb.Reader(data)
    out = abci.RequestInfo()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.version = r.read_bytes().decode()
        elif f == 2:
            out.block_version = r.read_uvarint()
        elif f == 3:
            out.p2p_version = r.read_uvarint()
        elif f == 4:
            out.abci_version = r.read_bytes().decode()
        else:
            r.skip(w)
    return out


def _dec_req_init_chain(data: bytes) -> abci.RequestInitChain:
    r = pb.Reader(data)
    out = abci.RequestInitChain(initial_height=0)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.time = _dec_ts(r.read_bytes())
        elif f == 2:
            out.chain_id = r.read_bytes().decode()
        elif f == 3:
            out.consensus_params = _dec_consensus_params(r.read_bytes())
        elif f == 4:
            out.validators.append(_dec_validator_update(r.read_bytes()))
        elif f == 5:
            out.app_state_bytes = r.read_bytes()
        elif f == 6:
            out.initial_height = r.read_varint_i64()
        else:
            r.skip(w)
    return out


def _dec_req_query(data: bytes) -> abci.RequestQuery:
    r = pb.Reader(data)
    out = abci.RequestQuery()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.data = r.read_bytes()
        elif f == 2:
            out.path = r.read_bytes().decode()
        elif f == 3:
            out.height = r.read_varint_i64()
        elif f == 4:
            out.prove = bool(r.read_uvarint())
        else:
            r.skip(w)
    return out


def _dec_req_check_tx(data: bytes) -> abci.RequestCheckTx:
    r = pb.Reader(data)
    out = abci.RequestCheckTx()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.tx = r.read_bytes()
        elif f == 2:
            out.type_ = abci.CheckTxType(r.read_uvarint())
        else:
            r.skip(w)
    return out


def _dec_req_offer_snapshot(data: bytes) -> abci.RequestOfferSnapshot:
    r = pb.Reader(data)
    out = abci.RequestOfferSnapshot()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.snapshot = _dec_snapshot(r.read_bytes())
        elif f == 2:
            out.app_hash = r.read_bytes()
        else:
            r.skip(w)
    return out


def _dec_req_load_snapshot_chunk(data: bytes) -> abci.RequestLoadSnapshotChunk:
    r = pb.Reader(data)
    out = abci.RequestLoadSnapshotChunk()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.height = r.read_uvarint()
        elif f == 2:
            out.format_ = r.read_uvarint()
        elif f == 3:
            out.chunk = r.read_uvarint()
        else:
            r.skip(w)
    return out


def _dec_req_apply_snapshot_chunk(data: bytes) -> abci.RequestApplySnapshotChunk:
    r = pb.Reader(data)
    out = abci.RequestApplySnapshotChunk()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.index = r.read_uvarint()
        elif f == 2:
            out.chunk = r.read_bytes()
        elif f == 3:
            out.sender = r.read_bytes().decode()
        else:
            r.skip(w)
    return out


def _dec_req_prepare_proposal(data: bytes) -> abci.RequestPrepareProposal:
    r = pb.Reader(data)
    out = abci.RequestPrepareProposal()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.max_tx_bytes = r.read_varint_i64()
        elif f == 2:
            out.txs.append(r.read_bytes())
        elif f == 3:
            out.local_last_commit = _dec_ext_commit_info(r.read_bytes())
        elif f == 4:
            out.misbehavior.append(_dec_misbehavior(r.read_bytes()))
        elif f == 5:
            out.height = r.read_varint_i64()
        elif f == 6:
            out.time = _dec_ts(r.read_bytes())
        elif f == 7:
            out.next_validators_hash = r.read_bytes()
        elif f == 8:
            out.proposer_address = r.read_bytes()
        else:
            r.skip(w)
    return out


def _dec_req_process_proposal(data: bytes) -> abci.RequestProcessProposal:
    r = pb.Reader(data)
    out = abci.RequestProcessProposal()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.txs.append(r.read_bytes())
        elif f == 2:
            out.proposed_last_commit = _dec_commit_info(r.read_bytes())
        elif f == 3:
            out.misbehavior.append(_dec_misbehavior(r.read_bytes()))
        elif f == 4:
            out.hash = r.read_bytes()
        elif f == 5:
            out.height = r.read_varint_i64()
        elif f == 6:
            out.time = _dec_ts(r.read_bytes())
        elif f == 7:
            out.next_validators_hash = r.read_bytes()
        elif f == 8:
            out.proposer_address = r.read_bytes()
        else:
            r.skip(w)
    return out


def _dec_req_extend_vote(data: bytes) -> abci.RequestExtendVote:
    r = pb.Reader(data)
    out = abci.RequestExtendVote()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.hash = r.read_bytes()
        elif f == 2:
            out.height = r.read_varint_i64()
        elif f == 3:
            out.time = _dec_ts(r.read_bytes())
        elif f == 4:
            out.txs.append(r.read_bytes())
        elif f == 5:
            out.proposed_last_commit = _dec_commit_info(r.read_bytes())
        elif f == 6:
            out.misbehavior.append(_dec_misbehavior(r.read_bytes()))
        elif f == 7:
            out.next_validators_hash = r.read_bytes()
        elif f == 8:
            out.proposer_address = r.read_bytes()
        else:
            r.skip(w)
    return out


def _dec_req_verify_vote_extension(data: bytes) -> abci.RequestVerifyVoteExtension:
    r = pb.Reader(data)
    out = abci.RequestVerifyVoteExtension()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.hash = r.read_bytes()
        elif f == 2:
            out.validator_address = r.read_bytes()
        elif f == 3:
            out.height = r.read_varint_i64()
        elif f == 4:
            out.vote_extension = r.read_bytes()
        else:
            r.skip(w)
    return out


def _dec_req_finalize_block(data: bytes) -> abci.RequestFinalizeBlock:
    r = pb.Reader(data)
    out = abci.RequestFinalizeBlock()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.txs.append(r.read_bytes())
        elif f == 2:
            out.decided_last_commit = _dec_commit_info(r.read_bytes())
        elif f == 3:
            out.misbehavior.append(_dec_misbehavior(r.read_bytes()))
        elif f == 4:
            out.hash = r.read_bytes()
        elif f == 5:
            out.height = r.read_varint_i64()
        elif f == 6:
            out.time = _dec_ts(r.read_bytes())
        elif f == 7:
            out.next_validators_hash = r.read_bytes()
        elif f == 8:
            out.proposer_address = r.read_bytes()
        else:
            r.skip(w)
    return out


_REQ_DECODERS = {
    "echo": _dec_req_echo,
    "flush": lambda d: abci.RequestFlush(),
    "info": _dec_req_info,
    "init_chain": _dec_req_init_chain,
    "query": _dec_req_query,
    "check_tx": _dec_req_check_tx,
    "commit": lambda d: abci.RequestCommit(),
    "list_snapshots": lambda d: abci.RequestListSnapshots(),
    "offer_snapshot": _dec_req_offer_snapshot,
    "load_snapshot_chunk": _dec_req_load_snapshot_chunk,
    "apply_snapshot_chunk": _dec_req_apply_snapshot_chunk,
    "prepare_proposal": _dec_req_prepare_proposal,
    "process_proposal": _dec_req_process_proposal,
    "extend_vote": _dec_req_extend_vote,
    "verify_vote_extension": _dec_req_verify_vote_extension,
    "finalize_block": _dec_req_finalize_block,
}


# ---------------------------------------------------------------------------
# response bodies
# ---------------------------------------------------------------------------


def _enc_resp_info(p: abci.ResponseInfo) -> bytes:
    w = pb.Writer()
    w.string(1, p.data)
    w.string(2, p.version)
    w.uvarint(3, p.app_version)
    w.varint_i64(4, p.last_block_height)
    w.bytes(5, p.last_block_app_hash)
    return w.output()


def _enc_resp_init_chain(p: abci.ResponseInitChain) -> bytes:
    w = pb.Writer()
    w.message(1, _enc_consensus_params(p.consensus_params))
    for u in p.validators:
        w.message(2, _enc_validator_update(u), always=True)
    w.bytes(3, p.app_hash)
    return w.output()


def _enc_resp_query(p: abci.ResponseQuery) -> bytes:
    w = pb.Writer()
    w.uvarint(1, p.code)
    w.string(3, p.log)
    w.string(4, p.info)
    w.varint_i64(5, p.index)
    w.bytes(6, p.key)
    w.bytes(7, p.value)
    w.message(8, _enc_proof_ops(p.proof_ops))
    w.varint_i64(9, p.height)
    w.string(10, p.codespace)
    return w.output()


def _enc_resp_check_tx(p: abci.ResponseCheckTx) -> bytes:
    w = pb.Writer()
    _enc_tx_result_fields(w, p)
    return w.output()


def _enc_resp_commit(p: abci.ResponseCommit) -> bytes:
    return pb.Writer().varint_i64(3, p.retain_height).output()


def _enc_resp_list_snapshots(p: abci.ResponseListSnapshots) -> bytes:
    w = pb.Writer()
    for s in p.snapshots:
        w.message(1, _enc_snapshot(s), always=True)
    return w.output()


def _enc_resp_apply_snapshot_chunk(p: abci.ResponseApplySnapshotChunk) -> bytes:
    w = pb.Writer()
    w.uvarint(1, int(p.result))
    if p.refetch_chunks:  # packed repeated uint32
        body = b"".join(pb.encode_uvarint(c) for c in p.refetch_chunks)
        w.bytes(2, body, always=True)
    for s in p.reject_senders:
        w.string(3, s, always=True)
    return w.output()


def _enc_resp_finalize_block(p: abci.ResponseFinalizeBlock) -> bytes:
    w = pb.Writer()
    for e in p.events:
        w.message(1, _enc_event(e), always=True)
    for t in p.tx_results:
        tw = pb.Writer()
        _enc_tx_result_fields(tw, t)
        w.message(2, tw.output(), always=True)
    for u in p.validator_updates:
        w.message(3, _enc_validator_update(u), always=True)
    w.message(4, _enc_consensus_params(p.consensus_param_updates))
    w.bytes(5, p.app_hash)
    return w.output()


_RESP_ENCODERS = {
    "exception": lambda p: pb.Writer().string(1, p if isinstance(p, str) else str(p)).output(),
    "echo": lambda p: pb.Writer().string(1, p.message).output(),
    "flush": lambda p: b"",
    "info": _enc_resp_info,
    "init_chain": _enc_resp_init_chain,
    "query": _enc_resp_query,
    "check_tx": _enc_resp_check_tx,
    "commit": _enc_resp_commit,
    "list_snapshots": _enc_resp_list_snapshots,
    "offer_snapshot": lambda p: pb.Writer().uvarint(1, int(p.result)).output(),
    "load_snapshot_chunk": lambda p: pb.Writer().bytes(1, p.chunk).output(),
    "apply_snapshot_chunk": _enc_resp_apply_snapshot_chunk,
    "prepare_proposal": lambda p: _enc_repeated_bytes(1, p.txs),
    "process_proposal": lambda p: pb.Writer().uvarint(1, int(p.status)).output(),
    "extend_vote": lambda p: pb.Writer().bytes(1, p.vote_extension).output(),
    "verify_vote_extension": lambda p: pb.Writer().uvarint(1, int(p.status)).output(),
    "finalize_block": _enc_resp_finalize_block,
}


def _enc_repeated_bytes(field: int, items: list[bytes]) -> bytes:
    w = pb.Writer()
    for b in items:
        w.bytes(field, b, always=True)
    return w.output()


def _dec_resp_info(data: bytes) -> abci.ResponseInfo:
    r = pb.Reader(data)
    out = abci.ResponseInfo()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.data = r.read_bytes().decode()
        elif f == 2:
            out.version = r.read_bytes().decode()
        elif f == 3:
            out.app_version = r.read_uvarint()
        elif f == 4:
            out.last_block_height = r.read_varint_i64()
        elif f == 5:
            out.last_block_app_hash = r.read_bytes()
        else:
            r.skip(w)
    return out


def _dec_resp_init_chain(data: bytes) -> abci.ResponseInitChain:
    r = pb.Reader(data)
    out = abci.ResponseInitChain()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.consensus_params = _dec_consensus_params(r.read_bytes())
        elif f == 2:
            out.validators.append(_dec_validator_update(r.read_bytes()))
        elif f == 3:
            out.app_hash = r.read_bytes()
        else:
            r.skip(w)
    return out


def _dec_resp_query(data: bytes) -> abci.ResponseQuery:
    r = pb.Reader(data)
    out = abci.ResponseQuery()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.code = r.read_uvarint()
        elif f == 3:
            out.log = r.read_bytes().decode()
        elif f == 4:
            out.info = r.read_bytes().decode()
        elif f == 5:
            out.index = r.read_varint_i64()
        elif f == 6:
            out.key = r.read_bytes()
        elif f == 7:
            out.value = r.read_bytes()
        elif f == 8:
            out.proof_ops = _dec_proof_ops(r.read_bytes())
        elif f == 9:
            out.height = r.read_varint_i64()
        elif f == 10:
            out.codespace = r.read_bytes().decode()
        else:
            r.skip(w)
    return out


def _dec_resp_check_tx(data: bytes) -> abci.ResponseCheckTx:
    out = abci.ResponseCheckTx()
    _dec_tx_result_fields(pb.Reader(data), out)
    return out


def _dec_resp_commit(data: bytes) -> abci.ResponseCommit:
    r = pb.Reader(data)
    out = abci.ResponseCommit()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 3:
            out.retain_height = r.read_varint_i64()
        else:
            r.skip(w)
    return out


def _dec_resp_list_snapshots(data: bytes) -> abci.ResponseListSnapshots:
    r = pb.Reader(data)
    out = abci.ResponseListSnapshots()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.snapshots.append(_dec_snapshot(r.read_bytes()))
        else:
            r.skip(w)
    return out


def _dec_resp_apply_snapshot_chunk(data: bytes) -> abci.ResponseApplySnapshotChunk:
    r = pb.Reader(data)
    out = abci.ResponseApplySnapshotChunk()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.result = abci.ApplySnapshotChunkResult(r.read_uvarint())
        elif f == 2:
            if w == 2:  # packed
                inner = pb.Reader(r.read_bytes())
                while not inner.at_end():
                    out.refetch_chunks.append(inner.read_uvarint())
            else:
                out.refetch_chunks.append(r.read_uvarint())
        elif f == 3:
            out.reject_senders.append(r.read_bytes().decode())
        else:
            r.skip(w)
    return out


def _dec_resp_prepare_proposal(data: bytes) -> abci.ResponsePrepareProposal:
    r = pb.Reader(data)
    out = abci.ResponsePrepareProposal()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.txs.append(r.read_bytes())
        else:
            r.skip(w)
    return out


def _dec_resp_finalize_block(data: bytes) -> abci.ResponseFinalizeBlock:
    r = pb.Reader(data)
    out = abci.ResponseFinalizeBlock()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.events.append(_dec_event(r.read_bytes()))
        elif f == 2:
            t = abci.ExecTxResult()
            _dec_tx_result_fields(pb.Reader(r.read_bytes()), t)
            out.tx_results.append(t)
        elif f == 3:
            out.validator_updates.append(_dec_validator_update(r.read_bytes()))
        elif f == 4:
            out.consensus_param_updates = _dec_consensus_params(r.read_bytes())
        elif f == 5:
            out.app_hash = r.read_bytes()
        else:
            r.skip(w)
    return out


_RESP_DECODERS = {
    "exception": lambda d: _dec_exception(d),
    "echo": lambda d: _dec_resp_echo(d),
    "flush": lambda d: abci.ResponseFlush(),
    "info": _dec_resp_info,
    "init_chain": _dec_resp_init_chain,
    "query": _dec_resp_query,
    "check_tx": _dec_resp_check_tx,
    "commit": _dec_resp_commit,
    "list_snapshots": _dec_resp_list_snapshots,
    "offer_snapshot": lambda d: abci.ResponseOfferSnapshot(
        result=abci.OfferSnapshotResult(_dec_single_uvarint(d, 1))),
    "load_snapshot_chunk": lambda d: abci.ResponseLoadSnapshotChunk(
        chunk=_dec_single_bytes(d, 1)),
    "apply_snapshot_chunk": _dec_resp_apply_snapshot_chunk,
    "prepare_proposal": _dec_resp_prepare_proposal,
    "process_proposal": lambda d: abci.ResponseProcessProposal(
        status=abci.ProposalStatus(_dec_single_uvarint(d, 1))),
    "extend_vote": lambda d: abci.ResponseExtendVote(
        vote_extension=_dec_single_bytes(d, 1)),
    "verify_vote_extension": lambda d: abci.ResponseVerifyVoteExtension(
        status=abci.VerifyStatus(_dec_single_uvarint(d, 1))),
    "finalize_block": _dec_resp_finalize_block,
}


def _dec_exception(data: bytes) -> str:
    r = pb.Reader(data)
    msg = ""
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            msg = r.read_bytes().decode()
        else:
            r.skip(w)
    return msg


def _dec_resp_echo(data: bytes) -> abci.ResponseEcho:
    r = pb.Reader(data)
    out = abci.ResponseEcho()
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            out.message = r.read_bytes().decode()
        else:
            r.skip(w)
    return out


def _dec_single_uvarint(data: bytes, field: int) -> int:
    r = pb.Reader(data)
    v = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == field:
            v = r.read_uvarint()
        else:
            r.skip(w)
    return v


def _dec_single_bytes(data: bytes, field: int) -> bytes:
    r = pb.Reader(data)
    v = b""
    while not r.at_end():
        f, w = r.read_tag()
        if f == field:
            v = r.read_bytes()
        else:
            r.skip(w)
    return v


# ---------------------------------------------------------------------------
# Request / Response oneof wrappers + varint-delimited framing
# ---------------------------------------------------------------------------


def encode_request(method: str, req) -> bytes:
    """-> varint-delimited `Request` (the reference's WriteMsg bytes)."""
    field = REQUEST_FIELDS.get(method)
    if field is None:
        raise ValueError(f"unknown ABCI method {method!r}")
    body = _REQ_ENCODERS[method](req)
    w = pb.Writer()
    w.bytes(field, body, always=True)
    return pb.marshal_delimited(w.output())


def encode_response(method: str, resp) -> bytes:
    field = RESPONSE_FIELDS.get(method)
    if field is None:
        raise ValueError(f"unknown ABCI response {method!r}")
    body = _RESP_ENCODERS[method](resp)
    w = pb.Writer()
    w.bytes(field, body, always=True)
    return pb.marshal_delimited(w.output())


def encode_exception(message: str) -> bytes:
    return encode_response("exception", message)


def _decode_oneof(data: bytes, by_field: dict, decoders: dict, kind: str):
    r = pb.Reader(data)
    if r.at_end():
        raise ValueError(f"empty ABCI {kind}")
    f, w = r.read_tag()
    method = by_field.get(f)
    if method is None:
        raise ValueError(f"unknown ABCI {kind} oneof field {f}")
    if w != 2:
        raise ValueError(f"bad wire type {w} for ABCI {kind} oneof")
    return method, decoders[method](r.read_bytes())


def decode_request_bytes(data: bytes):
    return _decode_oneof(data, _REQ_BY_FIELD, _REQ_DECODERS, "request")


def decode_response_bytes(data: bytes):
    return _decode_oneof(data, _RESP_BY_FIELD, _RESP_DECODERS, "response")


async def read_delimited_async(reader, first_byte: bytes = b"",
                               max_size: int = MAX_MSG_SIZE) -> bytes:
    """Read one varint-length-delimited message from any object with an
    async readexactly() (libs/protoio/reader.go semantics). first_byte: a
    prefix byte the caller already consumed (the server's wire
    autodetector). Shared by the ABCI socket and the p2p secret-connection
    handshake — the single implementation of this framing."""
    n = 0
    shift = 0
    pre = first_byte
    while True:
        if pre:
            b, pre = pre, b""
        else:
            b = await reader.readexactly(1)
        if shift == 63 and b[0] > 1:
            raise ValueError("varint length prefix overflows uint64")
        n |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("varint length prefix too long")
    if n > max_size:
        raise ValueError(f"message of {n} bytes exceeds {max_size}")
    return await reader.readexactly(n)


async def decode_request_async(reader):
    return decode_request_bytes(await read_delimited_async(reader))


async def decode_response_async(reader):
    return decode_response_bytes(await read_delimited_async(reader))
