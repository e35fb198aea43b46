"""The port's certificate plane (cert/store.py, cert/plane.py) and the
block-sync certificate exchange against the JAX package's on the CPU.

- CertStore: the same certificates put, scanned, pruned and quarantined in
  either package give the same keys, bytes, heights and counters;
- CertPlane.certify_height over a 4-validator BLS light chain (its block
  and state stores stand in by the chain's commits and sets): the same
  verdicts, counters and certificate bytes, which are also the bytes
  build_certificate gives in either package; _realign_canonical rebuilds
  a certificate made from a seen commit once the canonical commit differs;
  the plane's service certifies a store's heights by its poll and backfill
  loops;
- a block sync proved by certificates: a 4-BLS-validator chain served by a
  harness node whose plane serves every height's certificate, the last
  synced height's mauled (a flipped aggregate byte). The syncing node proves
  every other height by its certificate, rejects and counts the mauled one
  (the reference's attests_commit refuses it too) and proves that height
  the classic way; its blocks and State are the chain's. The pairing-product
  checks are stubbed to accept (a plain BLS check takes ~10 s on the CPU;
  tests/test_torch_cert.py runs one real check): what is held here is the
  exchange and the reactor's verdicts, counters and applied chain.
"""

from __future__ import annotations

import asyncio
import dataclasses

import pytest

from cometbft_tpu import cert as jcert
from cometbft_tpu.cert.plane import CertPlane as JCertPlane
from cometbft_tpu.cert.store import CertStore as JCertStore
from cometbft_tpu.store.db import MemDB as JMemDB
from cometbft_tpu.types.block import Commit as JCommit
from cometbft_tpu_torch import cert as tcert
from cometbft_tpu_torch.cert.plane import CertPlane as TCertPlane
from cometbft_tpu_torch.cert.store import CertStore as TCertStore
from cometbft_tpu_torch.store import MemDB as TMemDB
from cometbft_tpu_torch.types import validation as tval
from tests import torch_net_harness as H
from tests import torch_tcp_harness as T
from tests.torch_consumers import CHAIN, Chain, fresh_backends

SIDES = {"jax": (jcert, JCertStore, JCertPlane, JMemDB),
         "port": (tcert, TCertStore, TCertPlane, TMemDB)}


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.fixture(scope="module")
def chain():
    """Seven heights of four BLS validators."""
    return Chain(7, n_vals=4, tag=b"certplane", kind="bls12381")


class _Stores:
    """The block and state stores a plane reads, over a light chain: the
    canonical commit of h (None until `canonical` names h), the seen commit
    of h and the set of h."""

    def __init__(self, commits: dict, vals: dict, canonical: set):
        self.commits, self.vals, self.canonical = commits, vals, canonical
        self.seen: dict = {}

    def load_block_commit(self, h):
        return self.commits.get(h) if h in self.canonical else None

    def load_seen_commit(self, h):
        return self.seen.get(h, self.commits.get(h))

    def load_validators(self, h):
        return self.vals.get(h)

    def height(self):
        return max(self.commits)

    def base(self):
        return 1


def _stores(side: str, chain, canonical=None) -> _Stores:
    blocks = chain.blocks if side == "jax" else chain.port_blocks()
    return _Stores({h: b.commit for h, b in blocks.items()},
                   {h: b.validator_set for h, b in blocks.items()},
                   set(blocks) if canonical is None else set(canonical))


def _built(side: str, chain) -> list:
    cert = SIDES[side][0]
    blocks = chain.blocks if side == "jax" else chain.port_blocks()
    return [cert.build_certificate(CHAIN, blocks[h].validator_set, blocks[h].commit)
            for h in sorted(blocks)]


# --------------------------------------------------------------- CertStore


def _store_script(side: str, chain) -> list:
    _, CertStore, _, MemDB = SIDES[side]
    db = MemDB()
    store = CertStore(db)
    certs = _built(side, chain)
    out = []
    for c in certs[::-1]:
        store.put(c)
    out.append(list(db.iterate(b"", None)))
    out.append((store.heights(), store.count(), store.has(3), store.has(9)))
    out.append([store.get_raw(h) for h in (1, 4, 9)])
    out.append([store.missing_in(1, 10, lim) for lim in (0, 2, 10)] + [store.missing_in(5, 4, 3)])
    db.set(b"cert:" + (4).to_bytes(8, "big"), b"\x01garbage")
    out.append((store.get(4), store.quarantined, store.has(4), store.heights()))
    out.append((store.prune(3), store.heights(), store.prune(1), store.count()))
    return out


def test_cert_store_keys_bytes_and_counters_are_the_reference_s(chain):
    got = _store_script("port", chain)
    assert got == _store_script("jax", chain)
    assert got[1][0] == list(range(1, 8)) and got[4][1] == 1


def test_certificate_bytes_are_the_reference_s(chain):
    t, j = _built("port", chain), _built("jax", chain)
    assert [c.encode() for c in t] == [c.encode() for c in j]
    assert all(tcert.CommitCertificate.decode(c.encode()).encode() == c.encode() for c in t)


# --------------------------------------------------------------- CertPlane


def _plane_run(side: str, chain) -> list:
    cert, CertStore, CertPlane, MemDB = SIDES[side]
    st = _stores(side, chain, canonical=range(1, 5))
    plane = CertPlane(CertStore(MemDB()), st, st, CHAIN)
    out = [[plane.certify_height(h) for h in (0, 1, 2, 2, 9)]]
    # a seen commit of height 5 without validator 1: certified as seen
    seen = st.commits[5]
    st.seen[5] = dataclasses.replace(seen, signatures=[
        type(cs).absent() if i == 1 else cs for i, cs in enumerate(seen.signatures)])
    out.append(plane.certify_height(5))
    out.append(plane.store.get_raw(5))
    # its canonical commit lands (every signer): the certificate is rebuilt
    st.canonical.add(5)
    plane._realign_canonical(5)
    plane._realign_canonical(5)  # idempotent once it matches
    out.append((plane.store.get_raw(5), plane.rebuilt))
    out.append(cert.matches_commit(plane.store.get(5), st.commits[5]))
    # a height whose canonical commit came first: certified from it
    for h in (6, 7):
        plane._on_new_height(h)
    out.append(plane.serve(6))
    out.append(plane.serve(99))
    plane.count_verified()
    plane.count_fallback()
    plane.count_verify_failure()
    out.append(plane.health())
    out.append(list(plane.store.db.iterate(b"", None)))
    return out


def test_certify_height_and_realign_are_the_reference_s(chain):
    got = _plane_run("port", chain)
    assert got == _plane_run("jax", chain)
    assert got[0] == [False, True, True, True, False] and got[3][1] == 1 and got[4]
    assert got[-2]["produced"] == 5 and got[-2]["served"] == 1


def test_plane_service_certifies_a_store_by_its_loops(chain):
    """No event bus: the poll loop certifies each new height and the
    backfill loop the rest; both packages end with the same store."""
    def run(side):
        _, CertStore, CertPlane, MemDB = SIDES[side]
        st = _stores(side, chain)

        async def main():
            plane = CertPlane(CertStore(MemDB()), st, st, CHAIN, poll_interval=0.02,
                              backfill_batch=2)
            await plane.start()
            try:
                async def full():
                    while plane.store.count() < 7:
                        await asyncio.sleep(0.01)

                await asyncio.wait_for(full(), 60.0)
            finally:
                await plane.stop()
            return list(plane.store.db.iterate(b"", None)), plane.poll_ticks > 0

        return asyncio.run(main())

    assert run("port") == run("jax")


# ------------------------------------------------ a block sync proved by certificates


def _bls_genesis(n: int):
    """n BLS validators with secrets sk0 + i (stepped_bls_signer's), power 10."""
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.crypto import bls12381_math as O
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    sk0 = 1_234_567_891
    secrets, vals = {}, []
    for i in range(n):
        pub = bls12381.PubKey(O.bls_g1_compress(O._ec_affine(
            O._FpOps, O._ec_mul(O._FpOps, sk0 + i, O._ec_from_affine(O.BLS_G1)))))
        secrets[pub.address()] = sk0 + i
        vals.append(GenesisValidator(address=pub.address(), pub_key=pub, power=10))
    gdoc = GenesisDoc(genesis_time=H.GENESIS_TIME, chain_id="torch-cert-sync", validators=vals)
    gdoc.validate_and_complete()
    return gdoc, secrets


def test_certificates_prove_a_block_sync_and_a_mauled_one_is_refused(monkeypatch):
    n_blocks = 6
    top = n_blocks - 1  # the tip waits for its successor's commit
    gdoc, secrets = _bls_genesis(4)
    chain = asyncio.run(T.build_chain(gdoc, n_blocks, T.stepped_bls_signer(secrets),
                                      shared_time=True))
    monkeypatch.setattr(tval, "_bls_aggregate_ok", lambda pubs, msgs, sigs: True)
    monkeypatch.setattr(tval, "_bls_aggregate_agg_ok", lambda pubs, msgs, agg: True)
    plane = TCertPlane(TCertStore(TMemDB()), chain.block_store, chain.state_store,
                       gdoc.chain_id)
    assert [plane.certify_height(h) for h in range(1, n_blocks + 1)] == [True] * n_blocks
    serve, mauled = plane.serve, {}

    def serve_mauling(height):
        raw = serve(height)
        if raw is not None and height == top:
            c = tcert.CommitCertificate.decode(raw)
            sig = bytearray(c.agg_sig)
            sig[40] ^= 1
            raw = mauled[height] = dataclasses.replace(c, agg_sig=bytes(sig)).encode()
        return raw

    plane.serve = serve_mauling

    async def run():
        hkey, htr, hsw = T.serve_node("cert-source", gdoc, chain.block_store, cert_plane=plane)
        node = await T.sync_node(gdoc, window=4, cert=True)
        haddr = await htr.listen("127.0.0.1:0")
        await node.transport.listen("127.0.0.1:0")
        for sw in (hsw, node.switch):
            await sw.start()
        try:
            await node.switch.dial_peers_async([f"{hkey.id()}@{haddr}"], persistent=True)

            async def synced():
                while node.block_store.height() < top or node.reactor.active:
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(synced(), 60.0)
        finally:
            for sw in (node.switch, hsw):
                await sw.stop()
            await node.conns.stop()
        return node

    node = asyncio.run(asyncio.wait_for(run(), 90.0))
    bcr = node.reactor
    assert list(mauled) == [top]
    assert (bcr.cert_heights, bcr.certs_rejected) == (top - 1, 1)
    assert bcr.certs_requested >= top and bcr.certs_received >= top - 1
    assert plane.served >= top
    for h in range(1, top + 1):
        assert node.block_store.load_block(h).hash() == chain.block_store.load_block(h).hash()
    assert node.state_store.load().to_bytes() == chain.states[top]
    # the reference refuses the mauled certificate for the same commit
    commit = chain.block_store.load_block_commit(top)
    jc = JCommit.from_proto(commit.to_proto())
    bad = mauled[top]
    assert tcert.attests_commit(tcert.CommitCertificate.decode(bad), commit) is False
    assert jcert.attests_commit(jcert.CommitCertificate.decode(bad), jc) is False
