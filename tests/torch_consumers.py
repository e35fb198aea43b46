"""Seeded inputs of the consumers' tests (VoteSet, the light client,
certificates, evidence), made once with the JAX package's types, whose
signing is fast, and carried into the port through their proto bytes: the
same validator sets, votes, commits and light blocks in both packages.

Keys come from fixed secrets, timestamps from fixed bases, block hashes
from SHA-256 of fixed tags: every input is the same on every run.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from cometbft_tpu import sched as jsched
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.types.basic import BlockID, BlockIDFlag, PartSetHeader, SignedMsgType
from cometbft_tpu.types.block import Header
from cometbft_tpu.types.commit import Commit, CommitSig
from cometbft_tpu.types.light import LightBlock, SignedHeader
from cometbft_tpu.types.validator import Validator, ValidatorSet
from cometbft_tpu.types.vote import Vote
from cometbft_tpu.utils import cmttime
from cometbft_tpu_torch import sched as tsched
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.ops import challenge as TC
from cometbft_tpu_torch.ops import residency as TR
from cometbft_tpu_torch.types import light as tlight
from cometbft_tpu_torch.types import validator as tvalidator

CHAIN = "consumers-chain"
BASE_S = 1_700_000_000
PERIOD_NS = 10**18  # a trusting period no test reaches


def priv(kind: str, tag: bytes, i: int):
    """The JAX package's key number i of `kind` under `tag`."""
    secret = b"consumers-%s-%s-%d" % (kind.encode(), tag, i)
    if kind == "ed25519":
        return jed.gen_priv_key_from_secret(secret)
    if kind == "sr25519":
        return jsr.gen_priv_key_from_secret(secret)
    if kind == "secp256k1":
        from cometbft_tpu.crypto import secp256k1

        return secp256k1.gen_priv_key_from_secret(secret)
    from cometbft_tpu.crypto import bls12381

    return bls12381.gen_priv_key_from_secret(secret)


def valset(privs, power: int = 10):
    """(ValidatorSet, privs sorted as the set sorts its validators)."""
    vs = ValidatorSet([Validator.new(p.pub_key(), power) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    return vs, [by_addr[v.address] for v in vs.validators]


def port_vals(jvals: ValidatorSet) -> tvalidator.ValidatorSet:
    return tvalidator.ValidatorSet.from_proto(jvals.to_proto())


def block_id(tag: bytes) -> BlockID:
    h = hashlib.sha256(b"block-" + tag).digest()
    return BlockID(h, PartSetHeader(1, hashlib.sha256(h).digest()))


def vote(privs, i: int, height: int, round_: int, bid: BlockID,
         msg_type: SignedMsgType = SignedMsgType.PRECOMMIT, extension: bytes = b"",
         chain: str = CHAIN) -> Vote:
    """Validator i's signed vote (its extension signed too when given)."""
    p = privs[i]
    v = Vote(type_=msg_type, height=height, round_=round_, block_id=bid,
             timestamp=cmttime.Timestamp(BASE_S + height, (1 << 28) + 1_000 * i),
             validator_address=p.pub_key().address(), validator_index=i)
    v.signature = p.sign(v.sign_bytes(chain))
    if extension:
        v.extension = extension
        v.extension_signature = p.sign(v.extension_sign_bytes(chain))
    return v


def signed_commit(privs, height: int, bid: BlockID, round_: int = 1,
                  absent: tuple = (), chain: str = CHAIN) -> Commit:
    """A commit of every validator but `absent` for `bid`."""
    sigs = []
    for i, p in enumerate(privs):
        if i in absent:
            sigs.append(CommitSig.absent())
            continue
        sigs.append(CommitSig(BlockIDFlag.COMMIT, p.pub_key().address(),
                              cmttime.Timestamp(BASE_S + height, (1 << 28) + 1_000 * i)))
    c = Commit(height, round_, bid, sigs)
    for i, cs in enumerate(sigs):
        if i not in absent:
            cs.signature = privs[i].sign(c.vote_sign_bytes(chain, i))
    return c


def tamper_commit(commit: Commit, i: int) -> Commit:
    """A copy of `commit` with one bit of signature i flipped."""
    sigs = [dataclasses.replace(cs) for cs in commit.signatures]
    s = bytearray(sigs[i].signature)
    s[40] ^= 1
    sigs[i].signature = bytes(s)
    return Commit(commit.height, commit.round_, commit.block_id, sigs)


class Chain:
    """A linked chain of LightBlocks, heights 1..n: version v = h //
    churn_every of the validator set is keys [v * replace, v * replace +
    n_vals) of one pool, so each version replaces `replace` validators of
    the last; header h carries the hashes of sets h and h + 1 and the block
    ID of h - 1; every validator signs each commit."""

    def __init__(self, n: int, n_vals: int = 4, churn_every: int = 0, replace: int = 0,
                 tag: bytes = b"chain", kind: str = "ed25519"):
        self.n, self.tag = n, tag
        versions = n // churn_every + 2 if churn_every else 1
        pool = [priv(kind, tag, i) for i in range(n_vals + replace * versions)]
        self._sets: dict[int, tuple] = {}
        self.churn_every, self.replace, self.n_vals, self.pool = churn_every, replace, n_vals, pool
        self.blocks: dict[int, LightBlock] = {}
        self.app_hash_lie_from = None
        last = BlockID()
        for h in range(1, n + 1):
            self.blocks[h] = self._block(h, last, app_hash=h.to_bytes(32, "big"))
            last = self.blocks[h].commit.block_id
        self._port: dict[int, tlight.LightBlock] = {}

    def vals(self, h: int):
        v = h // self.churn_every if self.churn_every else 0
        if v not in self._sets:
            start = v * self.replace
            self._sets[v] = valset(self.pool[start:start + self.n_vals])
        return self._sets[v]

    def _block(self, h: int, last: BlockID, app_hash: bytes) -> LightBlock:
        vs, privs = self.vals(h)
        header = Header(
            chain_id=CHAIN, height=h, time=cmttime.Timestamp(BASE_S + h, 0),
            last_block_id=last, validators_hash=vs.hash(),
            next_validators_hash=self.vals(h + 1)[0].hash(), consensus_hash=b"\x01" * 32,
            app_hash=app_hash, last_results_hash=b"\x02" * 32, data_hash=b"\x03" * 32,
            last_commit_hash=b"\x04" * 32, evidence_hash=b"\x05" * 32,
            proposer_address=vs.validators[0].address)
        bid = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(
            self.tag + b"-parts-%d" % h).digest()))
        return LightBlock(SignedHeader(header, signed_commit(privs, h, bid)), vs)

    def forked(self, fork: int) -> "Chain":
        """The same chain with a lying app hash from height `fork` on,
        signed by the same keys (a lunatic attack)."""
        other = object.__new__(Chain)
        other.__dict__.update(self.__dict__)
        other.blocks, other._port = dict(self.blocks), {}
        last = self.blocks[fork - 1].commit.block_id
        for h in range(fork, self.n + 1):
            other.blocks[h] = other._block(h, last, app_hash=b"\xee" * 32)
            last = other.blocks[h].commit.block_id
        return other

    def port(self, h: int) -> tlight.LightBlock:
        if h not in self._port:
            self._port[h] = tlight.LightBlock.from_proto(self.blocks[h].to_proto())
        return self._port[h]

    def port_blocks(self) -> dict:
        return {h: self.port(h) for h in self.blocks}


def now(chain: Chain) -> tuple:
    """The same `now`, past the chain's last header, in both packages."""
    from cometbft_tpu_torch.utils import cmttime as ttime

    s = BASE_S + chain.n + 100
    return cmttime.Timestamp(s, 0), ttime.Timestamp(s, 0)


def fresh_backends():
    """Both packages on their "cpu" backends with their schedulers on and
    fresh process-global state; the plain versions run on one torch
    thread. Use as a generator fixture body."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (TC, TR):
        m.reset()
    tsched.reset()
    jsched.reset()
    tsched.configure(enabled=True)
    tbatch.set_backend("cpu")
    jbatch.set_backend("cpu")
    try:
        yield
    finally:
        tsched.reset()
        jsched.reset()
        tbatch.set_backend("gpu")
        for m in (TC, TR):
            m.reset()
        torch.set_num_threads(n)


def first_line(e: BaseException) -> tuple[str, str]:
    """An exception's class name and the first line of its message."""
    return type(e).__name__, str(e).split("\n")[0]


def outcome(fn, *args, **kw) -> tuple:
    """("ok", result) or the exception's (class, first line)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return first_line(e)
