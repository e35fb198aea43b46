"""Remote-signer privval over a socket (reference: privval/
signer_listener_endpoint.go:30, signer_dialer_endpoint.go,
signer_client.go, signer_server.go).

Topology mirrors the reference: the NODE LISTENS on
priv_validator_laddr; the SIGNER (the machine holding the key) DIALS IN —
the key holder initiates, so the node never needs credentials to reach the
HSM box. Once connected:

  node --(SignVoteRequest/SignProposalRequest/PubKeyRequest/Ping)--> signer
  signer --(Signed*Response | error)--> node

The consensus engine's PrivValidator interface is synchronous, so
SignerClient speaks blocking sockets with deadlines (signing is on the
consensus actor and sub-millisecond on the wire); SignerServer runs a
plain thread loop around a FilePV — the double-sign guard lives WITH the
key, exactly like the reference's remote signer.

Wire format: 4-byte big-endian length prefix + a oneof-tagged protobuf
message (proto/tendermint/privval/types.proto shape, hand-rolled like the
rest of the framework's codecs).

The port's copy of cometbft_tpu/privval/remote.py.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.privval.file_pv import ErrDoubleSign, PrivValidator
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.validator import pub_key_from_proto, pub_key_to_proto
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils import protobuf as pb

_PUBKEY_REQ = 1
_PUBKEY_RESP = 2
_SIGN_VOTE_REQ = 3
_SIGNED_VOTE_RESP = 4
_SIGN_PROPOSAL_REQ = 5
_SIGNED_PROPOSAL_RESP = 6
_PING_REQ = 7
_PING_RESP = 8

_MAX_MSG = 1 << 20


def _frame(tag: int, body: bytes) -> bytes:
    w = pb.Writer()
    w.message(tag, body, always=True)
    out = w.output()
    return struct.pack(">I", len(out)) + out


def _read_frame(sock: socket.socket) -> tuple[int, bytes]:
    hdr = _recv_exact(sock, 4)
    (ln,) = struct.unpack(">I", hdr)
    if ln > _MAX_MSG:
        raise ConnectionError(f"privval frame too large ({ln})")
    data = _recv_exact(sock, ln)
    r = pb.Reader(data)
    tag, _ = r.read_tag()
    return tag, r.read_bytes()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("privval connection closed")
        buf += part
    return buf


def _err_body(chain_id: str, payload: bytes, err: str,
              sign_extension: bool = False) -> bytes:
    w = pb.Writer()
    if payload:
        w.bytes(1, payload)
    w.string(2, err)
    w.string(3, chain_id)
    if sign_extension:
        w.uvarint(4, 1)
    return w.output()


def _parse_body(body: bytes) -> tuple[bytes, str, str, bool]:
    payload, err, chain_id, sign_ext = b"", "", "", False
    r = pb.Reader(body)
    while not r.at_end():
        f, wt = r.read_tag()
        if f == 1:
            payload = r.read_bytes()
        elif f == 2:
            err = r.read_string()
        elif f == 3:
            chain_id = r.read_string()
        elif f == 4:
            sign_ext = bool(r.read_uvarint())
        else:
            r.skip(wt)
    return payload, err, chain_id, sign_ext


class RemoteSignerError(Exception):
    pass


class SignerServer:
    """The key-holder side (signer_server.go + signer_dialer_endpoint.go):
    dials the node's priv_validator_laddr and answers sign requests from
    its local FilePV (double-sign guard enforced here, with the key)."""

    def __init__(self, pv: PrivValidator, addr: tuple[str, int],
                 logger: cmtlog.Logger | None = None,
                 retries: int = 10, retry_delay: float = 0.2):
        self.pv = pv
        self.addr = addr
        self.logger = logger or cmtlog.nop()
        self.retries = retries
        self.retry_delay = retry_delay
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="signer-server")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                # shutdown wakes the thread blocked in recv; close alone
                # does not
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _dial(self) -> socket.socket:
        import time

        last: Exception | None = None
        for _ in range(self.retries):
            if self._stop.is_set():
                raise ConnectionError("signer stopped")
            try:
                s = socket.create_connection(self.addr, timeout=3.0)
                s.settimeout(None)
                return s
            except OSError as e:
                last = e
                time.sleep(self.retry_delay)
        raise ConnectionError(f"signer could not reach node: {last}")

    def _run(self) -> None:
        try:
            self._sock = self._dial()
        except ConnectionError as e:
            self.logger.error("signer dial failed", err=str(e))
            return
        sock = self._sock
        while not self._stop.is_set():
            try:
                tag, body = _read_frame(sock)
            except (ConnectionError, OSError):
                return
            try:
                resp = self._handle(tag, body)
            except Exception as e:  # noqa: BLE001 - never kill the loop
                self.logger.error("signer request failed", err=str(e))
                resp = _frame(tag + 1, _err_body("", b"", str(e)))
            try:
                sock.sendall(resp)
            except (ConnectionError, OSError):
                return

    def _handle(self, tag: int, body: bytes) -> bytes:
        payload, _, chain_id, sign_ext = _parse_body(body)
        if tag == _PING_REQ:
            return _frame(_PING_RESP, b"")
        if tag == _PUBKEY_REQ:
            return _frame(_PUBKEY_RESP,
                          _err_body(chain_id, pub_key_to_proto(self.pv.get_pub_key()), ""))
        if tag == _SIGN_VOTE_REQ:
            vote = Vote.from_proto(payload)
            try:
                self.pv.sign_vote(chain_id, vote, sign_extension=sign_ext)
            except ErrDoubleSign as e:
                return _frame(_SIGNED_VOTE_RESP, _err_body(chain_id, b"", str(e)))
            return _frame(_SIGNED_VOTE_RESP, _err_body(chain_id, vote.to_proto(), ""))
        if tag == _SIGN_PROPOSAL_REQ:
            proposal = Proposal.from_proto(payload)
            try:
                self.pv.sign_proposal(chain_id, proposal)
            except ErrDoubleSign as e:
                return _frame(_SIGNED_PROPOSAL_RESP, _err_body(chain_id, b"", str(e)))
            return _frame(_SIGNED_PROPOSAL_RESP,
                          _err_body(chain_id, proposal.to_proto(), ""))
        raise RemoteSignerError(f"unknown privval request tag {tag}")


class SignerClient(PrivValidator):
    """The node side (signer_listener_endpoint.go:30 + signer_client.go):
    listen for the signer's dial-in, then satisfy the PrivValidator
    interface by round-tripping every signing request."""

    def __init__(self, laddr: tuple[str, int], timeout: float = 5.0,
                 accept_timeout: float = 15.0):
        self._listener = socket.create_server(laddr)
        self._listener.settimeout(accept_timeout)
        self.laddr = self._listener.getsockname()
        self.timeout = timeout
        self._conn: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._pub: Optional[crypto.PubKey] = None

    def accept(self) -> None:
        """Block until the remote signer dials in."""
        conn, _ = self._listener.accept()
        conn.settimeout(self.timeout)
        self._conn = conn

    def close(self) -> None:
        for s in (self._conn, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def _round_trip(self, tag: int, body: bytes) -> bytes:
        if self._conn is None:
            raise RemoteSignerError("no signer connected")
        with self._lock:
            self._conn.sendall(_frame(tag, body))
            resp_tag, resp_body = _read_frame(self._conn)
        if resp_tag != tag + 1:
            raise RemoteSignerError(
                f"privval response tag {resp_tag}, want {tag + 1}")
        payload, err, _, _ = _parse_body(resp_body)
        if err:
            if "conflicting data" in err or "double sign" in err:
                raise ErrDoubleSign(err)
            raise RemoteSignerError(err)
        return payload

    def ping(self) -> None:
        self._round_trip(_PING_REQ, b"")

    def get_pub_key(self) -> crypto.PubKey:
        if self._pub is None:
            payload = self._round_trip(_PUBKEY_REQ, _err_body("", b"", ""))
            self._pub = pub_key_from_proto(payload)
        return self._pub

    def sign_vote(self, chain_id: str, vote: Vote, sign_extension: bool = False) -> None:
        payload = self._round_trip(
            _SIGN_VOTE_REQ,
            _err_body(chain_id, vote.to_proto(), "", sign_extension=sign_extension))
        signed = Vote.from_proto(payload)
        vote.signature = signed.signature
        vote.timestamp = signed.timestamp
        vote.extension_signature = signed.extension_signature

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        payload = self._round_trip(
            _SIGN_PROPOSAL_REQ, _err_body(chain_id, proposal.to_proto(), ""))
        signed = Proposal.from_proto(payload)
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp
