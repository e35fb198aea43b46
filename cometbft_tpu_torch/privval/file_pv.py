"""FilePV — file-backed validator signer with double-sign protection.

Reference: privval/file.go. Key file holds the private key (written once);
state file tracks (height, round, step, signature, sign_bytes) and refuses
to sign conflicting messages at the same HRS (file.go:100 CheckHRS) —
signing twice at one HRS is the equivocation the evidence subsystem exists
to punish, so the signer is the last line of defense.

Step ordering within a round: propose(1) < prevote(2) < precommit(3).
Re-signing the SAME bytes at the same HRS returns the cached signature
(needed after a crash-restart mid-step); differing bytes that differ only
in timestamp also re-sign with the cached signature (file.go:280-320 —
the reference tolerates timestamp regeneration).

The port's copy of cometbft_tpu/privval/file_pv.py. Its key and sign-state
files are the reference's, byte for byte, so either package loads what the
other wrote. The sign-state rename runs through the `privval.save`
disk-chaos seam (libs/diskchaos).
"""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import bls12381, ed25519
from cometbft_tpu_torch.libs import diskio, fail
from cometbft_tpu_torch.types.basic import SignedMsgType
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils import protobuf as pb

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {
    SignedMsgType.PREVOTE: STEP_PREVOTE,
    SignedMsgType.PRECOMMIT: STEP_PRECOMMIT,
}


class ErrDoubleSign(Exception):
    pass


class PrivValidator:
    """The signing interface consensus programs against
    (types/priv_validator.go)."""

    def get_pub_key(self) -> crypto.PubKey:
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote: Vote, sign_extension: bool = False) -> None:
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        raise NotImplementedError


def _atomic_write(path: str, data: bytes, site: str | None = None) -> None:
    """FULL-grade durability: temp-file fsync AND directory fsync after
    the rename (libs/diskio.durable_replace). The sign-state is the one
    write whose loss enables a double-sign — a bare os.replace left the
    rename in the un-fsynced directory, where power loss could resurrect
    the OLD sign state with the new signature already on the wire."""
    diskio.atomic_write_durable(path, data, site=site)


@dataclass
class _LastSignState:
    height: int = 0
    round_: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """file.go:100-135: returns True if this exact HRS was signed before
        (caller may reuse); raises on regression."""
        if self.height > height:
            raise ErrDoubleSign(f"height regression. Got {height}, last height {self.height}")
        if self.height == height:
            if self.round_ > round_:
                raise ErrDoubleSign(f"round regression at height {height}. Got {round_}, last round {self.round_}")
            if self.round_ == round_:
                if self.step > step:
                    raise ErrDoubleSign(
                        f"step regression at height {height} round {round_}. Got {step}, last step {self.step}"
                    )
                if self.step == step:
                    if not self.sign_bytes:
                        raise ErrDoubleSign("no sign_bytes but HRS matches")
                    return True
        return False


class FilePV(PrivValidator):
    def __init__(self, priv_key: crypto.PrivKey, key_file: str = "", state_file: str = ""):
        self.priv_key = priv_key
        self.key_file = key_file
        self.state_file = state_file
        self.last_sign_state = _LastSignState()
        if state_file and os.path.exists(state_file):
            self._load_state()

    # --------------------------------------------------------- file I/O

    # Amino-style JSON tags per key scheme. Ed25519 persists only the
    # 32-byte seed (reference file format); BLS persists the scalar.
    _KEY_CODECS = {
        ed25519.KEY_TYPE: (
            "tendermint/PubKeyEd25519", "tendermint/PrivKeyEd25519",
            lambda priv: priv.bytes_()[:32],
        ),
        bls12381.KEY_TYPE: (
            "cometbft/PubKeyBls12_381", "cometbft/PrivKeyBls12_381",
            lambda priv: priv.bytes_(),
        ),
    }
    _PRIV_DECODERS = {
        "tendermint/PrivKeyEd25519": ed25519.PrivKey,
        "cometbft/PrivKeyBls12_381": bls12381.PrivKey,
    }

    @classmethod
    def generate(cls, key_file: str = "", state_file: str = "",
                 key_type: str = ed25519.KEY_TYPE) -> "FilePV":
        if key_type == bls12381.KEY_TYPE:
            priv: crypto.PrivKey = bls12381.gen_priv_key()
        elif key_type == ed25519.KEY_TYPE:
            priv = ed25519.gen_priv_key()
        else:
            raise ValueError(f"FilePV.generate: unsupported key type {key_type!r}")
        pv = cls(priv, key_file, state_file)
        if key_file:
            pv.save_key()
        return pv

    @classmethod
    def load(cls, key_file: str, state_file: str) -> "FilePV":
        with open(key_file) as f:
            doc = json.load(f)
        ctor = cls._PRIV_DECODERS.get(
            doc["priv_key"].get("type", "tendermint/PrivKeyEd25519"),
            ed25519.PrivKey,
        )
        priv = ctor(base64.b64decode(doc["priv_key"]["value"]))
        return cls(priv, key_file, state_file)

    @classmethod
    def load_or_generate(cls, key_file: str, state_file: str,
                         key_type: str = ed25519.KEY_TYPE) -> "FilePV":
        if os.path.exists(key_file):
            return cls.load(key_file, state_file)
        pv = cls.generate(key_file, state_file, key_type=key_type)
        return pv

    def save_key(self) -> None:
        pub = self.priv_key.pub_key()
        pub_tag, priv_tag, priv_enc = self._KEY_CODECS[self.priv_key.type_()]
        doc = {
            "address": pub.address().hex().upper(),
            "pub_key": {"type": pub_tag,
                        "value": base64.b64encode(pub.bytes_()).decode()},
            "priv_key": {"type": priv_tag,
                         "value": base64.b64encode(priv_enc(self.priv_key)).decode()},
        }
        _atomic_write(self.key_file, json.dumps(doc, indent=2).encode())

    def _save_state(self) -> None:
        if not self.state_file:
            return
        # crash window: signed in memory, nothing persisted, signature
        # NOT yet released to the caller — dying here must never enable
        # a double-sign (the restarted signer may legally re-sign)
        fail.fail_point("privval.save")
        st = self.last_sign_state
        doc = {
            "height": st.height,
            "round": st.round_,
            "step": st.step,
            "signature": base64.b64encode(st.signature).decode(),
            "signbytes": st.sign_bytes.hex(),
        }
        _atomic_write(self.state_file, json.dumps(doc, indent=2).encode(),
                      site="privval.save")

    def _load_state(self) -> None:
        with open(self.state_file) as f:
            doc = json.load(f)
        self.last_sign_state = _LastSignState(
            height=int(doc.get("height", 0)),
            round_=int(doc.get("round", 0)),
            step=int(doc.get("step", 0)),
            signature=base64.b64decode(doc.get("signature", "")),
            sign_bytes=bytes.fromhex(doc.get("signbytes", "")),
        )

    # --------------------------------------------------------- signing

    def get_pub_key(self) -> crypto.PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote, sign_extension: bool = False) -> None:
        """file.go signVote: HRS guard, timestamp-tolerant re-sign."""
        step = _VOTE_STEP.get(vote.type_)
        if step is None:
            raise ValueError(f"signVote: invalid vote type {vote.type_}")
        sign_bytes = vote.sign_bytes(chain_id)
        same_hrs = self.last_sign_state.check_hrs(vote.height, vote.round_, step)
        if same_hrs:
            st = self.last_sign_state
            if sign_bytes == st.sign_bytes:
                vote.signature = st.signature
            elif _vote_differs_only_by_timestamp(st.sign_bytes, sign_bytes):
                vote.signature = st.signature
                # keep the originally signed timestamp in the vote
                prev = _parse_canonical_vote_timestamp(st.sign_bytes)
                if prev is not None:
                    vote.timestamp = prev
            else:
                raise ErrDoubleSign("conflicting data: same HRS, different vote")
            if sign_extension and vote.type_ == SignedMsgType.PRECOMMIT and not vote.block_id.is_nil():
                vote.extension_signature = self.priv_key.sign(vote.extension_sign_bytes(chain_id))
            return
        sig = self.priv_key.sign(sign_bytes)
        self.last_sign_state = _LastSignState(
            height=vote.height, round_=vote.round_, step=step,
            signature=sig, sign_bytes=sign_bytes,
        )
        self._save_state()
        vote.signature = sig
        if sign_extension and vote.type_ == SignedMsgType.PRECOMMIT and not vote.block_id.is_nil():
            vote.extension_signature = self.priv_key.sign(vote.extension_sign_bytes(chain_id))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        sign_bytes = proposal.sign_bytes(chain_id)
        same_hrs = self.last_sign_state.check_hrs(proposal.height, proposal.round_, STEP_PROPOSE)
        if same_hrs:
            st = self.last_sign_state
            if sign_bytes == st.sign_bytes:
                proposal.signature = st.signature
            elif _proposal_differs_only_by_timestamp(st.sign_bytes, sign_bytes):
                proposal.signature = st.signature
            else:
                raise ErrDoubleSign("conflicting data: same HRS, different proposal")
            return
        sig = self.priv_key.sign(sign_bytes)
        self.last_sign_state = _LastSignState(
            height=proposal.height, round_=proposal.round_, step=STEP_PROPOSE,
            signature=sig, sign_bytes=sign_bytes,
        )
        self._save_state()
        proposal.signature = sig


def _strip_timestamp(sign_bytes: bytes, ts_field: int) -> bytes | None:
    """Remove the canonical timestamp field so two sign-bytes can be
    compared modulo timestamp (file.go checkVotesOnlyDifferByTimestamp)."""
    try:
        body, _ = pb.unmarshal_delimited(sign_bytes)
        r = pb.Reader(body)
        out = pb.Writer()
        while not r.at_end():
            start = r.pos
            f, w = r.read_tag()
            if f == ts_field and w == 2:
                r.skip(w)
                continue
            r.skip(w)
            out.buf += body[start:r.pos]
        return out.output()
    except ValueError:
        return None


def _vote_differs_only_by_timestamp(a: bytes, b: bytes) -> bool:
    sa, sb = _strip_timestamp(a, 5), _strip_timestamp(b, 5)
    return sa is not None and sa == sb


def _proposal_differs_only_by_timestamp(a: bytes, b: bytes) -> bool:
    sa, sb = _strip_timestamp(a, 6), _strip_timestamp(b, 6)
    return sa is not None and sa == sb


def _parse_canonical_vote_timestamp(sign_bytes: bytes):
    """Parse the canonical timestamp (field 5) back out of vote sign-bytes —
    used to re-sign with the originally signed timestamp after a restart."""
    from cometbft_tpu_torch.utils import cmttime

    try:
        body, _ = pb.unmarshal_delimited(sign_bytes)
        r = pb.Reader(body)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 5 and w == 2:
                secs, nanos = r.read_timestamp()
                return cmttime.Timestamp(secs, nanos)
            r.skip(w)
    except ValueError:
        pass
    return None
