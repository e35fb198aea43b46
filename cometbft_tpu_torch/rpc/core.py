"""RPC route handlers — the node's client-visible API surface.

Reference: rpc/core/ (routes.go:12-56 route table; env.go Environment).
Each handler reads node internals and returns a JSON-serializable dict,
matching the reference's response shapes (hex-encoded hashes, stringified
int64s, base64 txs) closely enough for familiarity without claiming
byte-compat.

The port's copy of cometbft_tpu/rpc/core.py. Every route of the reference's
table answers as the reference's does, the light fleet's (`light_verify`
and the websocket `light_subscribe`/`light_unsubscribe`, -32601 "light
fleet disabled" while light.fleet_enabled is off) and `commit_certificate`
(from the node's certificate plane) among them. `validators` also takes
CometBFT's `page`/`per_page` (ROADMAP Queue 3).
"""

from __future__ import annotations

import base64

from cometbft_tpu_torch.abci import types as abci

# rpc/core/env.go:32 genesisChunkSize (16 MB)
GENESIS_CHUNK_SIZE = 16 * 1024 * 1024

# rpc/core/env.go:25-26 defaultPerPage / maxPerPage
DEFAULT_PER_PAGE = 30
MAX_PER_PAGE = 100


def header_dict(h) -> dict:
    """Complete JSON header — every field, lossless. Shared by the node RPC
    and the light proxy (light/proxy.py)."""
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": str(h.time),
        "last_block_id": {
            "hash": _hex(h.last_block_id.hash),
            "parts": {"total": h.last_block_id.part_set_header.total,
                      "hash": _hex(h.last_block_id.part_set_header.hash)},
        },
        "last_commit_hash": _hex(h.last_commit_hash),
        "data_hash": _hex(h.data_hash),
        "validators_hash": _hex(h.validators_hash),
        "next_validators_hash": _hex(h.next_validators_hash),
        "consensus_hash": _hex(h.consensus_hash),
        "app_hash": _hex(h.app_hash),
        "last_results_hash": _hex(h.last_results_hash),
        "evidence_hash": _hex(h.evidence_hash),
        "proposer_address": _hex(h.proposer_address),
    }


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _hex(b: bytes) -> str:
    return b.hex().upper()


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: dict | None = None):
        super().__init__(message)
        self.code = code
        # machine-readable error detail (JSON-RPC 2.0 `error.data`): the
        # overload plane rides here — every -32005 shed carries
        # {"plane": ..., "retry_after_ms": ...} so clients back off
        # without parsing message text
        self.data = data


def _int_param(value, name: str) -> int:
    """Parse a client-supplied integer param: malformed input is the
    CLIENT's error (-32602 invalid params), never -32603 internal."""
    try:
        return int(value)
    except (TypeError, ValueError):
        raise RPCError(
            -32602, f"bad {name} param (want int): {value!r}") from None


def _hex_param(value, name: str) -> bytes:
    """Parse a client-supplied hex param the same way: -32602, not a
    raw ValueError surfacing as -32603."""
    if isinstance(value, str) and value[:2] in ("0x", "0X"):
        value = value[2:]
    try:
        return bytes.fromhex(value)
    except (TypeError, ValueError):
        raise RPCError(
            -32602, f"bad {name} param (want hex): {value!r}") from None


class QuotedStr(str):
    """A URI arg that arrived as a '"quoted"' string literal — for []byte
    params its UTF-8 bytes ARE the value (reference
    rpc/jsonrpc/server/http_uri_handler.go: quoted args are string
    literals, unquoted are hex/number)."""


class UriStr(str):
    """An unquoted URI arg — []byte params decode as hex (0x optional),
    matching the reference URI handler; JSON-body params (plain str) stay
    strictly base64 (proto3 JSON), so base64 payloads that merely look like
    hex are never misdecoded."""


def _ws_err(rid, code: int, message: str, data: dict | None = None) -> dict:
    err: dict = {"code": code, "message": message}
    if data is not None:
        err["data"] = data
    return {"jsonrpc": "2.0", "id": rid, "error": err}


class Environment:
    """rpc/core/env.go: the handlers' view of the node."""

    def __init__(self, node):
        self.node = node
        self._bg_tasks: set = set()
        self._gen_chunks: list[str] | None = None
        # lazily-built light-client fleet service (light/fleet.py) behind
        # the light_verify / light_subscribe routes
        self._light_fleet = None
        self._fleet_lock = None  # created on the serving loop
        self._fleet_head_sub = None  # NewBlock subscription feeding it

    def _shed_data(self, plane: str, retry_after_ms: int | None = None,
                   record: bool = False) -> dict:
        """Build the unified -32005 `error.data` payload; with `record`,
        also account the shed on the overload registry (every shed lands
        on /metrics with its plane label). `record=False` is for errors
        whose subsystem already counted itself (ErrMempoolIsFull)."""
        from cometbft_tpu_torch.libs import overload as _ovl

        reg = getattr(self.node, "overload", None)
        if reg is not None:
            if record:
                reg.shed(plane)
            if not retry_after_ms:
                retry_after_ms = reg.retry_after_ms(plane)
        if not retry_after_ms:
            retry_after_ms = _ovl.RETRY_AFTER_MS[_ovl.SATURATED]
        return {"plane": plane, "retry_after_ms": retry_after_ms}

    # ------------------------------------------------------------- info

    async def health(self, _params: dict) -> dict:
        """Errors (not an empty OK) once the consensus routine has died —
        a validator that stopped committing must not answer healthy
        (ref consensus/state.go:789-802 containment)."""
        cs = getattr(self.node, "consensus_state", None)
        if cs is not None and getattr(cs, "failed", False):
            raise RPCError(-32603, "consensus failure: receive routine dead")
        out: dict = {}
        # overload plane snapshot (libs/overload.py): per-plane watermark
        # level, utilization, and shed counts — saturated-but-alive is a
        # state operators page on, so it rides the liveness probe
        reg = getattr(self.node, "overload", None)
        if reg is not None:
            out["overload"] = reg.health()
        return out

    async def crypto_health(self, _params: dict) -> dict:
        """The device-fault resilience snapshot (no reference analog):
        active verify backend, breaker states, retry/failure counters,
        the verify scheduler's `verify_sched` section (batch fill,
        per-class queue depth, deadline misses — sched/scheduler.py),
        the multi-chip `mesh` section (live size, per-chip fault-domain
        breakers, eviction/readmission/redispatch churn —
        parallel/mesh.py) and any armed chaos schedule (ops/dispatch.py
        health_snapshot). Served in inspect mode too — a crashed node's
        disk plus the process-global device state remain examinable."""
        from cometbft_tpu_torch.ops import dispatch

        snap = dispatch.health_snapshot()
        # certificate-plane section (cert/plane.py): per-NODE production
        # and consumption counters, merged here because the rest of the
        # snapshot is process-global device state
        plane = getattr(self.node, "cert_plane", None)
        if plane is not None:
            snap["cert"] = plane.health()
        return snap

    async def storage_health(self, _params: dict) -> dict:
        """The storage-fault resilience snapshot (crypto_health's disk
        sibling): WAL fsync p50/p99 and truncation/repair counts, db
        write latency, CRC-guard corruption detections, per-(site,kind)
        injected-fault counters, the armed disk-chaos schedule, and the
        node's durability knobs. Served in inspect mode too — a crashed
        node's storage plane remains examinable."""
        from cometbft_tpu_torch.libs import diskchaos
        from cometbft_tpu_torch.libs import metrics as cmtmetrics

        snap = cmtmetrics.storage_metrics().health()
        snap["disk_chaos"] = diskchaos.snapshot()
        cfg = getattr(self.node, "config", None)
        if cfg is not None:
            snap["config"] = {
                "synchronous": cfg.storage.synchronous,
                "checksum": cfg.storage.checksum,
                "db_backend": cfg.base.db_backend,
            }
        return snap

    async def status(self, _params: dict) -> dict:
        """rpc/core/status.go."""
        n = self.node
        latest_height = n.block_store.height()
        meta = n.block_store.load_block_meta(latest_height) if latest_height else None
        earliest = n.block_store.base()
        emeta = n.block_store.load_block_meta(earliest) if earliest else None
        pub_key = n.priv_validator.get_pub_key() if n.priv_validator else None
        return {
            "node_info": {
                "id": n.node_key.id(),
                "listen_addr": n.node_info.listen_addr,
                "network": n.node_info.network,
                "version": n.node_info.version,
                "moniker": n.node_info.moniker,
            },
            "sync_info": {
                "latest_block_hash": _hex(meta.block_id.hash) if meta else "",
                "latest_app_hash": _hex(meta.header.app_hash) if meta else "",
                "latest_block_height": str(latest_height),
                "latest_block_time": str(meta.header.time) if meta else "",
                "earliest_block_height": str(earliest),
                "earliest_block_hash": _hex(emeta.block_id.hash) if emeta else "",
                "catching_up": n.consensus_reactor.wait_sync,
                "consensus_failed": bool(
                    getattr(n.consensus_state, "failed", False)),
            },
            "validator_info": {
                "address": _hex(pub_key.address()) if pub_key else "",
                "pub_key": {"type": pub_key.type_(), "value": _b64(pub_key.bytes_())}
                if pub_key else None,
                "voting_power": "0",
            },
            "versions": self._versions_block(),
        }

    def _versions_block(self) -> dict:
        """Build/version identity — mirrored as the cometbft_build_info
        gauge on /metrics so dashboards and RPC agree on what is running."""
        from cometbft_tpu_torch import version as _version

        cfg = getattr(self.node, "config", None)
        crypto_cfg = getattr(cfg, "crypto", None)
        schemes = ["ed25519", "secp256k1", "sr25519"]
        if crypto_cfg is None or getattr(crypto_cfg, "bls_enabled", True):
            schemes.append("bls12381")
        return {
            "version": _version.CMTSemVer,
            "abci": _version.ABCIVersion,
            "block_protocol": str(_version.BlockProtocol),
            "p2p_protocol": str(_version.P2PProtocol),
            "gpu_crypto_backend": str(_version.GPUCryptoBackend),
            "backend": getattr(crypto_cfg, "backend", "cpu"),
            "schemes": schemes,
        }

    async def net_info(self, _params: dict) -> dict:
        """rpc/core/net.go."""
        sw = self.node.switch
        return {
            "listening": True,
            "listeners": [self.node.node_info.listen_addr],
            "n_peers": str(sw.n_peers()),
            "peers": [
                {
                    "node_info": {
                        "id": p.id,
                        "moniker": p.node_info.moniker,
                        "listen_addr": p.node_info.listen_addr,
                    },
                    "is_outbound": p.outbound,
                    "connection_status": p.status(),
                }
                for p in sw.peers.values()
            ],
        }

    async def net_telemetry(self, _params: dict) -> dict:
        """Wire-plane telemetry (no reference analog): the full per-peer/
        per-channel network accounting rollup — bytes/msgs/packets both
        directions per channel per peer, send-queue depth + high-water,
        send-routine stall split, ping RTT EWMAs — plus the live link
        models (the host<->device tunnel estimate the kernels feed, and
        the aggregate p2p RTT view) and the armed net-chaos schedule.
        `cometbft netinfo` renders this across a fleet; the e2e runner
        snapshots it per node into the run report."""
        from cometbft_tpu_torch.libs import linkmodel
        from cometbft_tpu_torch.p2p import netchaos

        sw = getattr(self.node, "switch", None)
        # inspect mode serves a _NoSwitch stub: degrade to an empty rollup
        # (link models + chaos snapshot below are process-global and real)
        tele = getattr(sw, "net_telemetry", None)
        wire = tele() if tele is not None else {
            "n_peers": 0, "peers": [], "channels": {},
            "totals": {}, "peer_scores": {}}
        node_key = getattr(self.node, "node_key", None)
        node_info = getattr(self.node, "node_info", None)
        # gossip accounting (vote amplification as a measured number):
        # the consensus reactor's per-peer sent/needed rollup — absent in
        # inspect mode, where there is no live reactor
        cons = getattr(self.node, "consensus_reactor", None)
        acct = getattr(cons, "gossip_accounting", None)
        # discovery plane: the address book's hashed-bucket occupancy view
        # (per-source-group spread vs the geometric eclipse bound)
        book = getattr(self.node, "addr_book", None)
        return {
            "node_id": node_key.id() if node_key is not None else "",
            "moniker": node_info.moniker if node_info is not None else "",
            "listen_addr": (node_info.listen_addr
                            if node_info is not None else ""),
            **wire,
            "gossip": acct() if acct is not None else None,
            "discovery": book.stats() if book is not None else None,
            "tunnel": linkmodel.tunnel().snapshot(),
            "p2p_link": linkmodel.p2p().snapshot(),
            "net_chaos": netchaos.snapshot(),
        }

    async def genesis(self, _params: dict) -> dict:
        import json

        return {"genesis": json.loads(self.node.genesis_doc.to_json())}

    # ------------------------------------------------------------ blocks

    def _height_param(self, params: dict, default: int) -> int:
        h = params.get("height")
        if h is None or h == "":
            return default
        h = _int_param(h, "height")
        base, top = self.node.block_store.base(), self.node.block_store.height()
        if h < base or h > top:
            raise RPCError(-32603, f"height {h} is not available (range {base}-{top})")
        return h

    def _block_dict(self, block) -> dict:
        return {
            "header": {
                "chain_id": block.header.chain_id,
                "height": str(block.header.height),
                "time": str(block.header.time),
                "last_block_id": {"hash": _hex(block.header.last_block_id.hash)},
                "app_hash": _hex(block.header.app_hash),
                "data_hash": _hex(block.header.data_hash),
                "validators_hash": _hex(block.header.validators_hash),
                "proposer_address": _hex(block.header.proposer_address),
            },
            "data": {"txs": [_b64(tx) for tx in block.data.txs]},
            "evidence": {"evidence": [
                {
                    "type": type(ev).__name__,
                    "height": str(ev.height()),
                    "validator_addresses": [
                        d["validator_address"].hex().upper()
                        for d in ev.abci()],
                }
                for ev in block.evidence.evidence
            ]},
            "last_commit": {
                "height": str(block.last_commit.height),
                "round": block.last_commit.round_,
                "block_id": {"hash": _hex(block.last_commit.block_id.hash)},
                "signatures": [
                    {
                        "block_id_flag": int(cs.block_id_flag),
                        "validator_address": _hex(cs.validator_address),
                        "timestamp": str(cs.timestamp),
                        "signature": _b64(cs.signature) if cs.signature else None,
                    }
                    for cs in block.last_commit.signatures
                ],
            } if block.last_commit else None,
        }

    async def block(self, params: dict) -> dict:
        """rpc/core/blocks.go Block."""
        height = self._height_param(params, self.node.block_store.height())
        block = self.node.block_store.load_block(height)
        if block is None:
            raise RPCError(-32603, f"block at height {height} not found")
        return {
            "block_id": {"hash": _hex(block.hash())},
            "block": self._block_dict(block),
        }

    async def block_by_hash(self, params: dict) -> dict:
        h = _hex_param(params.get("hash"), "hash")
        block = self.node.block_store.load_block_by_hash(h)
        if block is None:
            raise RPCError(-32603, "block not found")
        return {"block_id": {"hash": _hex(block.hash())}, "block": self._block_dict(block)}

    async def blockchain(self, params: dict) -> dict:
        """rpc/core/blocks.go BlockchainInfo: metas for a height range."""
        top = self.node.block_store.height()
        base = self.node.block_store.base()
        max_h = min(_int_param(params.get("maxHeight") or top, "maxHeight"),
                    top)
        min_h = max(_int_param(params.get("minHeight")
                               or max(base, max_h - 19), "minHeight"), base)
        metas = []
        for h in range(max_h, min_h - 1, -1):
            m = self.node.block_store.load_block_meta(h)
            if m is not None:
                metas.append({
                    "block_id": {"hash": _hex(m.block_id.hash)},
                    "block_size": m.block_size,
                    "header": {
                        "height": str(m.header.height),
                        "time": str(m.header.time),
                        "app_hash": _hex(m.header.app_hash),
                        "proposer_address": _hex(m.header.proposer_address),
                    },
                    "num_txs": m.num_txs,
                })
        return {"last_height": str(top), "block_metas": metas}

    def _header_dict(self, h) -> dict:
        return header_dict(h)

    async def header(self, params: dict) -> dict:
        """rpc/core/blocks.go:176 Header."""
        height = self._height_param(params, self.node.block_store.height())
        meta = self.node.block_store.load_block_meta(height)
        if meta is None:
            raise RPCError(-32603, f"header at height {height} not found")
        return {"header": self._header_dict(meta.header)}

    async def header_by_hash(self, params: dict) -> dict:
        """rpc/core/blocks.go:205 HeaderByHash."""
        h = _hex_param(params.get("hash"), "hash")
        block = self.node.block_store.load_block_by_hash(h)
        if block is None:
            raise RPCError(-32603, "header not found")
        return {"header": self._header_dict(block.header)}

    async def block_results(self, params: dict) -> dict:
        """rpc/core/blocks.go:244 BlockResults: the persisted
        FinalizeBlock response for a committed height — tx results, events,
        validator and consensus-param updates, app hash."""
        from cometbft_tpu_torch.abci import codec as abci_codec

        height = self._height_param(params, self.node.block_store.height())
        resp = self.node.state_store.load_finalize_block_response(height)
        if resp is None:
            raise RPCError(
                -32603, f"block results at height {height} not found")
        return {
            "height": str(height),
            "txs_results": [abci_codec._to_jsonable(r) for r in resp.tx_results],
            "finalize_block_events": [
                abci_codec._to_jsonable(e) for e in resp.events],
            "validator_updates": [
                abci_codec._to_jsonable(u) for u in resp.validator_updates],
            "consensus_param_updates": (
                abci_codec._to_jsonable(resp.consensus_param_updates)
                if resp.consensus_param_updates is not None else None),
            "app_hash": _hex(resp.app_hash),
        }

    async def consensus_params(self, params: dict) -> dict:
        """rpc/core/consensus.go:99 ConsensusParams: params in effect at a
        height (default: latest uncommitted = store top + 1, and explicit
        heights up to top + 1 are valid — like validators)."""
        top = self.node.block_store.height()
        h = params.get("height")
        if h in (None, ""):
            height = top + 1
        else:
            height = _int_param(h, "height")
            base = self.node.block_store.base()
            if height < base or height > top + 1:
                raise RPCError(
                    -32603,
                    f"height {height} is not available (range {base}-{top + 1})")
        cp = self.node.state_store.load_consensus_params(height)
        if cp is None:
            raise RPCError(
                -32603, f"consensus params at height {height} not found")
        return {
            "block_height": str(height),
            "consensus_params": {
                "block": {
                    "max_bytes": str(cp.block.max_bytes),
                    "max_gas": str(cp.block.max_gas),
                },
                "evidence": {
                    "max_age_num_blocks": str(cp.evidence.max_age_num_blocks),
                    "max_age_duration": str(cp.evidence.max_age_duration_ns),
                    "max_bytes": str(cp.evidence.max_bytes),
                },
                "validator": {"pub_key_types": cp.validator.pub_key_types},
                "version": {"app": str(cp.version.app)},
                "abci": {
                    "vote_extensions_enable_height": str(
                        cp.abci.vote_extensions_enable_height),
                },
            },
        }

    async def dump_consensus_state(self, _params: dict) -> dict:
        """rpc/core/consensus.go:56 DumpConsensusState: own round state
        plus every peer's tracked consensus round state."""
        from cometbft_tpu_torch.consensus.reactor import PEER_STATE_KEY

        own = await self.consensus_state({})
        peer_states = []
        sw = self.node.switch
        for p in (list(sw.peers.values()) if sw is not None else []):
            ps = p.get(PEER_STATE_KEY)
            if ps is None:
                continue
            prs = ps.prs
            peer_states.append({
                "node_address": f"{p.id}@{p.node_info.listen_addr}",
                "peer_state": {
                    "round_state": {
                        "height": str(prs.height),
                        "round": prs.round_,
                        "step": int(prs.step),
                        "proposal": prs.proposal,
                        "catchup_commit_round": prs.catchup_commit_round,
                        "last_commit_round": prs.last_commit_round,
                    },
                },
            })
        return {"round_state": own["round_state"], "peers": peer_states}

    async def check_tx(self, params: dict) -> dict:
        """rpc/core/mempool.go:188 CheckTx: run the app's CheckTx WITHOUT
        adding to the mempool."""
        from cometbft_tpu_torch.abci import codec as abci_codec

        tx = self._tx_param(params)
        res = await self.node.proxy_app.mempool.check_tx(
            abci.RequestCheckTx(tx=tx))
        return abci_codec._to_jsonable(res)

    async def genesis_chunked(self, params: dict) -> dict:
        """rpc/core/net.go:107 GenesisChunked: base64 chunks of the genesis
        document for payloads too large for one response."""
        chunks = self._genesis_chunks()
        if not chunks:
            raise RPCError(-32603, "genesis chunks are not initialized")
        cid = _int_param(params.get("chunk") or 0, "chunk")
        if cid < 0 or cid >= len(chunks):
            raise RPCError(
                -32602,
                f"there are {len(chunks)} chunks, {cid} is invalid")
        return {
            "chunk": str(cid),
            "total": str(len(chunks)),
            "data": chunks[cid],
        }

    def _genesis_chunks(self) -> list[str]:
        if self._gen_chunks is None:
            data = self.node.genesis_doc.to_json().encode()
            size = GENESIS_CHUNK_SIZE
            self._gen_chunks = [
                _b64(data[i:i + size]) for i in range(0, len(data), size)
            ]
        return self._gen_chunks

    async def commit(self, params: dict) -> dict:
        """rpc/core/blocks.go Commit: the COMPLETE signed header — every
        header field and every commit signature — so a light client can
        verify it (lossless, unlike a summary view)."""
        height = self._height_param(params, self.node.block_store.height())
        commit = self.node.block_store.load_block_commit(height)
        meta = self.node.block_store.load_block_meta(height)
        if commit is None or meta is None:
            raise RPCError(-32603, f"commit at height {height} not found")
        return {
            "canonical": True,
            "signed_header": {
                "header": self._header_dict(meta.header),
                "commit": {
                    "height": str(commit.height),
                    "round": commit.round_,
                    "block_id": {
                        "hash": _hex(commit.block_id.hash),
                        "parts": {"total": commit.block_id.part_set_header.total,
                                  "hash": _hex(commit.block_id.part_set_header.hash)},
                    },
                    "signatures": [
                        {
                            "block_id_flag": int(cs.block_id_flag),
                            "validator_address": _hex(cs.validator_address),
                            "timestamp": str(cs.timestamp),
                            "signature": _b64(cs.signature),
                        }
                        for cs in commit.signatures
                    ],
                },
            },
        }

    async def light_block(self, params: dict) -> dict:
        """Framework extension: the wire-exact LightBlock proto (base64) at
        a height — SignedHeader from the stores + the valset whose hash the
        header carries. The RPC light provider (light/rpc_provider.py) and
        statesync bootstrap consume this; a JSON rebuild of a commit can
        never be trusted to be byte-exact, the proto is."""
        top = self.node.block_store.height()
        try:
            height = self._height_param(params, top)
        except RPCError as e:
            raise RPCError(-32001, str(e)) from e  # out of range = no material
        meta = self.node.block_store.load_block_meta(height)
        # canonical commit lands with block height+1; the head falls back to
        # the seen commit (rpc/core/blocks.go Commit canonical=false)
        commit = (self.node.block_store.load_block_commit(height)
                  or self.node.block_store.load_seen_commit(height))
        vals = self.node.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            # -32001: no block material at this height (distinct code so the
            # RPC light provider classifies without parsing message text)
            raise RPCError(-32001, f"light block at height {height} not available")
        from cometbft_tpu_torch.types.light import LightBlock, SignedHeader

        lb = LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )
        return {"height": str(height), "light_block": _b64(lb.to_proto())}

    async def commit_certificate(self, params: dict) -> dict:
        """Framework extension (cert/): the succinct finality certificate
        at a height — one aggregated BLS signature + signer bitmap,
        verified anywhere with ONE pairing check. -32001 when the height
        has no certificate (uncertifiable set, not yet produced, or
        quarantined): consumers fall back to per-vote verification over
        `light_block`, the same material-missing convention that route
        uses."""
        plane = getattr(self.node, "cert_plane", None)
        if plane is None:
            raise RPCError(
                -32601, "certificate plane disabled (set cert.enabled)")
        top = self.node.block_store.height()
        try:
            height = self._height_param(params, top)
        except RPCError as e:
            raise RPCError(-32001, str(e)) from e  # out of range = no material
        raw = plane.serve(height)
        if raw is None:
            raise RPCError(
                -32001, f"no commit certificate at height {height}")
        from cometbft_tpu_torch.cert import CommitCertificate

        out = {"height": str(height), "certificate": _b64(raw)}
        try:
            out["summary"] = CommitCertificate.decode(raw).summary()
        except ValueError:
            pass  # raw bytes still served; consumers verify anyway
        return out

    # ------------------------------------------------------- light fleet
    # The serving plane (light/fleet.py): coalesced skipping
    # verification + checkpoint skip-list cache behind `light_verify`,
    # streaming verified headers behind the WS `light_subscribe` route
    # (rpc/server.py hands that one to ws_light_subscribe below).

    async def _ensure_fleet(self):
        import asyncio

        from cometbft_tpu_torch.light.fleet import LightFleet

        cfg = getattr(self.node, "config", None)
        lc = getattr(cfg, "light", None)
        if lc is None or not lc.fleet_enabled:
            raise RPCError(
                -32601, "light fleet disabled (set light.fleet_enabled)")
        if self._fleet_lock is None:
            self._fleet_lock = asyncio.Lock()
        async with self._fleet_lock:
            if self._light_fleet is not None:
                return self._light_fleet
            from cometbft_tpu_torch.light.client import TrustOptions
            from cometbft_tpu_torch.light.provider import NodeBackedProvider
            from cometbft_tpu_torch.light.rpc_provider import RPCProvider

            chain_id = self.node.genesis_doc.chain_id
            provider = NodeBackedProvider(self.node)
            base = self.node.block_store.base() or 1
            try:
                root = await provider.light_block(base)
            except Exception as e:  # noqa: BLE001 - no material yet
                raise RPCError(
                    -32001, f"no light-block material to anchor the "
                            f"fleet yet: {e}") from e
            period_ns = int(lc.fleet_trust_period * 1e9)
            witnesses = [
                RPCProvider(chain_id, u.strip())
                for u in lc.fleet_witnesses.split(",") if u.strip()
            ]
            from cometbft_tpu_torch.light.fleet import shared_cache

            fleet = LightFleet(
                chain_id, provider,
                TrustOptions(period_ns=period_ns, height=root.height,
                             hash_=root.hash()),
                witnesses=witnesses or None,
                # the per-chain shared cache: statesync seeds it before
                # the fleet exists, the fleet keeps it warm afterwards
                cache=shared_cache(
                    chain_id, capacity=lc.fleet_cache_capacity,
                    trust_period_ns=period_ns,
                    skip_base=lc.fleet_skip_base),
                cache_capacity=lc.fleet_cache_capacity,
                skip_base=lc.fleet_skip_base,
                trust_period_ns=period_ns,
                max_inflight=lc.fleet_max_inflight,
                subscriber_queue=lc.fleet_subscriber_queue,
                send_budget=lc.fleet_send_budget,
                max_subscribers=lc.fleet_max_subscribers,
                poll_interval=lc.fleet_poll_interval,
                logger=getattr(self.node, "logger", None),
            )
            await fleet.initialize()
            self._attach_head_events(fleet)
            self._light_fleet = fleet
            return fleet

    def _attach_head_events(self, fleet) -> None:
        """Event-driven head publishing: bridge the
        node's NewBlock events into fleet.notify_height so the head
        watcher wakes on commit instead of sleeping out a poll interval.
        Best-effort — a node without an event bus (inspect shims, tests)
        just leaves the fleet on the poll fallback."""
        import asyncio

        bus = getattr(self.node, "event_bus", None)
        if bus is None:
            return
        from cometbft_tpu_torch.types import event_bus as eb

        try:
            sub = bus.subscribe("light-fleet-head", eb.QUERY_NEW_BLOCK)
        except Exception:  # noqa: BLE001 - already subscribed / no server
            return
        self._fleet_head_sub = sub

        async def _pump() -> None:
            while True:
                msg = await sub.out.get()
                if msg is None:  # cancellation wake-up
                    if sub.canceled is not None:
                        return
                    continue
                block = getattr(msg.data, "block", None)
                header = getattr(block, "header", None)
                height = getattr(header, "height", None)
                if height:
                    fleet.notify_height(int(height))

        task = asyncio.get_running_loop().create_task(
            _pump(), name="light-fleet-head-events")
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def light_verify(self, params: dict) -> dict:
        """Fleet-served skipping verification (no reference analog): the
        header at `height` verified through the shared checkpoint cache
        and coalesced in-flight bisections — thousands of concurrent
        clients asking for overlapping ranges cost one verification per
        unique height. Returns the wire-exact LightBlock proto (base64)
        plus a fleet accounting snapshot."""
        from cometbft_tpu_torch.light.errors import LightClientError
        from cometbft_tpu_torch.light.fleet import FleetSaturated

        fleet = await self._ensure_fleet()
        try:
            height = int(params.get("height") or 0)
        except (TypeError, ValueError) as e:
            raise RPCError(-32602, f"bad height param: {e}") from e
        if height <= 0:
            height = self.node.block_store.height()
        # optional client pin: hex hash of the validator set the client
        # expects at that height — a mismatch errors instead of serving
        pin = params.get("valset_hash") or ""
        try:
            pin_bytes = bytes.fromhex(pin) if pin else b""
        except ValueError as e:
            raise RPCError(-32602, f"bad valset_hash param (want hex): "
                                   f"{e}") from e
        try:
            lb = await fleet.verify_height(height, pin_bytes)
        except FleetSaturated as e:
            raise RPCError(-32005, str(e),
                           data=self._shed_data("light", record=True)) from e
        except LightClientError as e:
            raise RPCError(-32001, f"light verification failed: {e}") from e
        # counters() not health(): the response's accounting block must
        # be O(1) — health() sorts the latency sample buffer, which a
        # cache-hit-heavy serving load would pay on EVERY request
        return {
            "height": str(lb.height),
            "light_block": _b64(lb.to_proto()),
            "fleet": fleet.counters(),
        }

    async def ws_light_subscribe(self, req: dict, client_id: str, tasks,
                                 send_json) -> None:
        """WS half of the serving plane (rpc/server.py dispatches the
        `light_subscribe` method here): register the client with the
        fleet and pump verified headers at it until it falls behind
        (backpressure drop), spends its send budget, or disconnects."""
        from cometbft_tpu_torch.light.fleet import FleetSaturated

        rid = req.get("id", -1)
        params = req.get("params") or {}
        try:
            fleet = await self._ensure_fleet()
        except RPCError as e:
            await send_json(_ws_err(rid, e.code, str(e)))
            return
        try:
            from_height = _int_param(params.get("from_height") or 0,
                                     "from_height")
        except RPCError as e:
            await send_json(_ws_err(rid, e.code, str(e)))
            return
        try:
            sub = fleet.subscribe(client_id, from_height)
        except FleetSaturated as e:
            await send_json(_ws_err(rid, -32005, str(e),
                                    data=self._shed_data("light",
                                                         record=True)))
            return
        tasks.spawn(self._pump_light(sub, rid, send_json),
                    name=f"light-sub-{client_id}")
        await send_json({"jsonrpc": "2.0", "id": rid, "result": {}})

    async def ws_light_unsubscribe(self, req: dict, client_id: str, _tasks,
                                   send_json) -> None:
        if self._light_fleet is not None:
            self._light_fleet.unsubscribe(client_id)
        await send_json({"jsonrpc": "2.0", "id": req.get("id", -1),
                         "result": {}})

    async def _pump_light(self, sub, rid, send_json) -> None:
        """Drain one subscription's queue onto the socket. The close
        reason is sent before the stream goes quiet (the ws_handler.go
        cancellation-notice convention)."""
        import asyncio as _aio

        from cometbft_tpu_torch.light.fleet import SubscriptionClosed

        while True:
            try:
                lb = await sub.next()
            except SubscriptionClosed as e:
                try:
                    await send_json(_ws_err(
                        f"{rid}#header", -32000,
                        f"light subscription closed: {e.reason}"))
                except (ConnectionError, _aio.IncompleteReadError, OSError):
                    pass
                return
            await send_json({
                "jsonrpc": "2.0",
                "id": f"{rid}#header",
                "result": {
                    "height": str(lb.height),
                    "light_block": _b64(lb.to_proto()),
                },
            })

    async def ws_client_closed(self, client_id: str) -> None:
        """rpc/server.py calls this when a WS connection dies: release
        the client's fleet subscription alongside its event-bus subs."""
        if self._light_fleet is not None:
            self._light_fleet.unsubscribe(client_id)

    async def close(self) -> None:
        """Server shutdown hook: stop the fleet's head watcher (and the
        event-bus pump feeding it) so no task outlives the RPC plane."""
        if self._fleet_head_sub is not None:
            self._fleet_head_sub.cancel("rpc environment closed")
            self._fleet_head_sub = None
        if self._light_fleet is not None:
            await self._light_fleet.stop()

    async def validators(self, params: dict) -> dict:
        """rpc/core/consensus.go Validators. Unlike block queries, validator
        sets are known one block ahead (state store holds V at H+1), so an
        explicit height up to store-top+1 is valid."""
        height = None
        if params.get("height"):
            height = _int_param(params["height"], "height")
            base, top = self.node.block_store.base(), self.node.block_store.height()
            if height < base or height > top + 1:
                raise RPCError(
                    -32603, f"height {height} is not available (range {base}-{top + 1})")
        if height is None:
            vals = self.node.consensus_state.rs.validators
        else:
            vals = self.node.state_store.load_validators(height)
        if vals is None:
            raise RPCError(-32603, "validator set not available")
        page = self._page(params, len(vals.validators))
        return {
            "block_height": str(height or self.node.block_store.height()),
            "validators": [
                {
                    "address": _hex(v.address),
                    "pub_key": {"type": v.pub_key.type_(), "value": _b64(v.pub_key.bytes_())},
                    "voting_power": str(v.voting_power),
                    "proposer_priority": str(v.proposer_priority),
                }
                for v in vals.validators[page]
            ],
            "count": str(len(vals.validators[page])),
            "total": str(len(vals.validators)),
        }

    @staticmethod
    def _page(params: dict, total: int) -> slice:
        """rpc/core/env.go validatePage/validatePerPage: the slice of a
        list that `page` (1-based) and `per_page` (default 30, at most 100)
        name; the whole list when neither is given."""
        if params.get("page") in (None, "") and params.get("per_page") in (None, ""):
            return slice(None)
        per_page = _int_param(params.get("per_page") or DEFAULT_PER_PAGE, "per_page")
        per_page = DEFAULT_PER_PAGE if per_page < 1 else min(per_page, MAX_PER_PAGE)
        pages = max(1, -(-total // per_page))
        page = _int_param(params.get("page") or 1, "page")
        if page < 1 or page > pages:
            raise RPCError(-32602, f"page should be within [1, {pages}] range, given {page}")
        return slice((page - 1) * per_page, page * per_page)

    async def consensus_state(self, _params: dict) -> dict:
        rs = self.node.consensus_state.rs
        return {"round_state": {
            "height/round/step": rs.height_round_step(),
            "height": str(rs.height), "round": rs.round_, "step": int(rs.step),
            "proposal_block_hash": _hex(rs.proposal_block.hash()) if rs.proposal_block else "",
            "locked_block_hash": _hex(rs.locked_block.hash()) if rs.locked_block else "",
            "valid_block_hash": _hex(rs.valid_block.hash()) if rs.valid_block else "",
        }}

    # ------------------------------------------------------------- abci

    async def abci_info(self, _params: dict) -> dict:
        res = await self.node.proxy_app.query.info(abci.RequestInfo())
        return {"response": {
            "data": res.data, "version": res.version,
            "app_version": str(res.app_version),
            "last_block_height": str(res.last_block_height),
            "last_block_app_hash": _b64(res.last_block_app_hash),
        }}

    async def abci_query(self, params: dict) -> dict:
        data = params.get("data", "")
        req = abci.RequestQuery(
            data=_hex_param(data, "data") if data else b"",
            path=params.get("path", ""),
            height=_int_param(params.get("height") or 0, "height"),
            prove=bool(params.get("prove", False)),
        )
        res = await self.node.proxy_app.query.query(req)
        return {"response": {
            "code": res.code, "log": res.log, "info": res.info,
            "key": _b64(res.key), "value": _b64(res.value),
            "height": str(res.height),
        }}

    # ---------------------------------------------------------- mempool

    def _tx_param(self, params: dict) -> bytes:
        tx = params.get("tx")
        if tx is None:
            raise RPCError(-32602, "missing tx param")
        if isinstance(tx, QuotedStr):
            return tx.encode()  # URI string literal: raw bytes
        if isinstance(tx, UriStr):
            return _hex_param(tx, "tx")
        try:
            # JSON body: proto3 base64
            return base64.b64decode(tx, validate=True)
        except (TypeError, ValueError):
            raise RPCError(
                -32602, "bad tx param (want base64)") from None

    async def broadcast_tx_async(self, params: dict) -> dict:
        """rpc/core/mempool.go:27: fire and forget."""
        tx = self._tx_param(params)
        import asyncio

        task = asyncio.get_running_loop().create_task(self._checktx_quiet(tx))
        # strong ref: an un-referenced task can be GC'd before it runs
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        from cometbft_tpu_torch.mempool.mempool import tx_hash

        return {"code": 0, "data": "", "log": "", "hash": _hex(tx_hash(tx))}

    async def _checktx_quiet(self, tx: bytes) -> None:
        try:
            await self.node.mempool.check_tx(tx)
        except Exception:  # noqa: BLE001
            pass

    async def broadcast_tx_sync(self, params: dict) -> dict:
        """rpc/core/mempool.go:48: wait for CheckTx — except under
        mempool pressure, where holding the connection open across the
        ABCI round-trip is exactly the work to shed: at the elevated
        watermark the route downgrades to fire-and-forget (async
        semantics, `"deferred": true` in the result) so admission keeps
        flowing without a sync caller's latency tail."""
        import asyncio

        tx = self._tx_param(params)
        from cometbft_tpu_torch.libs import overload as _ovl
        from cometbft_tpu_torch.mempool.mempool import (ErrMempoolIsFull,
                                                  ErrTxInCache, tx_hash)

        reg = getattr(self.node, "overload", None)
        if reg is not None and reg.level("mempool") >= _ovl.ELEVATED:
            task = asyncio.get_running_loop().create_task(
                self._checktx_quiet(tx))
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)
            return {"code": 0, "data": "",
                    "log": "mempool pressure: sync downgraded to async",
                    "deferred": True, "hash": _hex(tx_hash(tx))}
        try:
            res = await self.node.mempool.check_tx(tx)
        except ErrTxInCache:
            return {"code": 0, "data": "", "log": "tx already in cache",
                    "hash": _hex(tx_hash(tx))}
        except ErrMempoolIsFull as e:
            raise RPCError(
                -32005, str(e),
                data=self._shed_data(e.plane, e.retry_after_ms)) from e
        except Exception as e:  # noqa: BLE001
            raise RPCError(-32603, f"tx rejected: {e}") from e
        return {"code": res.code, "data": _b64(res.data), "log": res.log,
                "hash": _hex(tx_hash(tx))}

    async def broadcast_tx_commit(self, params: dict) -> dict:
        """rpc/core/mempool.go:69 BroadcastTxCommit: subscribe to the tx's
        inclusion event BEFORE CheckTx, then wait for DeliverTx (bounded by
        timeout_broadcast_tx_commit)."""
        import asyncio

        from cometbft_tpu_torch.abci import codec as abci_codec
        from cometbft_tpu_torch.mempool.mempool import (ErrMempoolIsFull,
                                                  ErrTxInCache, tx_hash)
        from cometbft_tpu_torch.types import event_bus as eb

        tx = self._tx_param(params)
        h = tx_hash(tx)
        bus = self.node.event_bus
        client = f"btc-{h.hex()[:16]}-{id(params)}"
        query = f"{eb.EVENT_TYPE_KEY} = '{eb.EVENT_TX}' AND {eb.TX_HASH_KEY} = '{h.hex().upper()}'"
        sub = bus.subscribe(client, query, capacity=1)
        try:
            try:
                check = await self.node.mempool.check_tx(tx)
            except ErrTxInCache:
                raise RPCError(-32603, "tx already exists in cache") from None
            except ErrMempoolIsFull as e:
                raise RPCError(
                    -32005, str(e),
                    data=self._shed_data(e.plane, e.retry_after_ms)) from e
            except Exception as e:  # noqa: BLE001
                raise RPCError(-32603, f"error on broadcastTxCommit: {e}") from e
            check_dict = {"code": check.code, "data": _b64(check.data),
                          "log": check.log}
            if check.code != 0:
                return {"check_tx": check_dict, "tx_result": {},
                        "hash": _hex(h), "height": "0"}
            timeout = self.node.config.rpc.timeout_broadcast_tx_commit
            try:
                msg = await asyncio.wait_for(sub.out.get(), timeout)
            except asyncio.TimeoutError:
                raise RPCError(
                    -32603, "timed out waiting for tx to be included in a block"
                ) from None
            if msg is None:
                raise RPCError(-32603, f"subscription canceled: {sub.canceled}")
            d = msg.data  # EventDataTx
            return {
                "check_tx": check_dict,
                "tx_result": abci_codec._to_jsonable(d.result),
                "hash": _hex(h),
                "height": str(d.height),
            }
        finally:
            try:
                bus.unsubscribe_all(client)
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------ tx query

    async def tx(self, params: dict) -> dict:
        """rpc/core/tx.go Tx: look up a committed tx by hash."""
        from cometbft_tpu_torch.abci import codec as abci_codec

        h = params.get("hash", "")
        raw = _hex_param(h, "hash") if isinstance(h, str) else h
        res = self.node.tx_indexer.get(raw)
        if res is None:
            raise RPCError(-32603, f"tx ({h}) not found")
        return {
            "hash": _hex(raw), "height": str(res.height), "index": res.index,
            "tx_result": abci_codec._to_jsonable(res.result), "tx": _b64(res.tx),
        }

    async def tx_search(self, params: dict) -> dict:
        """rpc/core/tx.go TxSearch over the KV indexer."""
        from cometbft_tpu_torch.abci import codec as abci_codec
        from cometbft_tpu_torch.types.block import tx_hash

        query = params.get("query", "")
        if not query:
            raise RPCError(-32602, "missing query param")
        limit = _int_param(params.get("per_page") or 30, "per_page")
        try:
            results = self.node.tx_indexer.search(query, limit=limit)
        except Exception as e:  # noqa: BLE001
            raise RPCError(-32602, f"bad query: {e}") from e
        return {
            "txs": [
                {"hash": _hex(tx_hash(r.tx)), "height": str(r.height),
                 "index": r.index, "tx_result": abci_codec._to_jsonable(r.result),
                 "tx": _b64(r.tx)}
                for r in results
            ],
            "total_count": str(len(results)),
        }

    async def block_search(self, params: dict) -> dict:
        """rpc/core/blocks.go BlockSearch over the block indexer."""
        query = params.get("query", "")
        if not query:
            raise RPCError(-32602, "missing query param")
        if self.node.block_indexer is None:
            raise RPCError(-32603, "block indexing disabled")
        try:
            heights = self.node.block_indexer.search(
                query, limit=_int_param(params.get("per_page") or 30,
                                        "per_page"))
        except Exception as e:  # noqa: BLE001
            raise RPCError(-32602, f"bad query: {e}") from e
        blocks = []
        for h in heights:
            blk = self.node.block_store.load_block(h)
            if blk is not None:
                blocks.append({"block_id": {"hash": _hex(blk.hash())},
                               "block": self._block_dict(blk)})
        return {"blocks": blocks, "total_count": str(len(blocks))}

    async def unconfirmed_txs(self, params: dict) -> dict:
        limit = _int_param(params.get("limit") or 30, "limit")
        txs = self.node.mempool.reap_max_txs(limit)
        return {
            "n_txs": str(len(txs)),
            "total": str(self.node.mempool.size()),
            "total_bytes": str(self.node.mempool.size_bytes()),
            "txs": [_b64(tx) for tx in txs],
        }

    async def num_unconfirmed_txs(self, _params: dict) -> dict:
        return {
            "n_txs": str(self.node.mempool.size()),
            "total": str(self.node.mempool.size()),
            "total_bytes": str(self.node.mempool.size_bytes()),
        }

    # --------------------------------------------------------- evidence

    async def broadcast_evidence(self, params: dict) -> dict:
        from cometbft_tpu_torch.types.evidence import evidence_list_from_proto

        evs = evidence_list_from_proto(
            _hex_param(params.get("evidence"), "evidence"))
        for ev in evs:
            self.node.evidence_pool.add_evidence(ev)
        return {"hash": _hex(evs[0].hash()) if evs else ""}

    async def trace_dump(self, params: dict) -> dict:
        """Flight-recorder dump (libs/trace.py, no reference analog):
        the verify-plane span ring as Chrome trace-event JSON — save the
        `chrome_trace` value to a file and load it at ui.perfetto.dev —
        plus the rolling wall-time attribution. `format=spans` returns
        the raw span records instead (the attribution-model input);
        `slow=true` appends the slow-batch capture ring (full span trees
        of batches/heights that blew the latency budget). Served in
        inspect mode too: the tracer is process-global, so a post-mortem
        over a crashed node's home can still read what the dying process
        wrote if inspect runs in-process (e.g. tests)."""
        import asyncio

        from cometbft_tpu_torch.libs import trace

        fmt = str(params.get("format", "chrome") or "chrome")
        out: dict = {
            "enabled": trace.enabled(),
            "spans_dropped": trace.dropped(),
            "attribution": trace.attribution(),
        }
        # rendering a full 64k-span ring to dicts costs tens of ms —
        # push it off the event loop consensus coroutines share, so
        # pulling a dump doesn't inject the latency spike being debugged
        loop = asyncio.get_running_loop()
        if fmt == "spans":
            out["spans"] = await loop.run_in_executor(None, trace.snapshot)
        elif fmt == "chrome":
            out["chrome_trace"] = await loop.run_in_executor(
                None, trace.chrome_trace)
        else:
            raise RPCError(-32602, f"unknown trace_dump format {fmt!r}"
                                   " (want chrome|spans)")
        if self._bool_param(params.get("slow", False)):
            out["slow_captures"] = await loop.run_in_executor(
                None, trace.slow_captures)
        return out

    async def consensus_timeline(self, params: dict) -> dict:
        """Per-height consensus phase timeline (no reference analog):
        the node's bounded heightline ring — one record per recent height
        with mono+wall timestamps for every critical-path event (proposal
        sent/received, first block part, proposal complete, prevote
        first/⅓/⅔, precommit quorum, commit, ABCI apply done) plus
        per-peer vote-arrival lag — and the per-peer clock-skew estimates
        needed to align timelines across nodes. `cometbft heightline`
        pulls this from a fleet and renders skew-corrected per-height
        anatomy. `min_height`/`limit` bound the response."""
        from cometbft_tpu_torch.consensus import timeline
        from cometbft_tpu_torch.libs import linkmodel

        min_height = _int_param(params.get("min_height", 0) or 0, "min_height")
        limit = _int_param(params.get("limit", 0) or 0, "limit")
        cs = getattr(self.node, "consensus_state", None)
        rec = getattr(cs, "timeline", None)
        node_key = getattr(self.node, "node_key", None)
        node_info = getattr(self.node, "node_info", None)
        cfg = getattr(self.node, "config", None)
        inst = getattr(cfg, "instrumentation", None)
        import time as _time
        return {
            "node_id": node_key.id() if node_key is not None else "",
            "moniker": node_info.moniker if node_info is not None else "",
            "now_wall_ns": _time.time_ns(),
            "enabled": timeline.enabled(),
            "height_slow_ms": (getattr(inst, "height_slow_ms", 0.0)
                               if inst is not None else 0.0),
            "heights": (rec.snapshot(min_height=min_height, limit=limit)
                        if rec is not None else []),
            "skew": linkmodel.skew().snapshot(),
        }

    async def postmortems(self, params: dict) -> dict:
        """Slow-height postmortem bundles (no reference analog): heights
        whose wall time exceeded instrumentation.height_slow_ms each
        auto-captured one bounded bundle (timeline, span tree, gossip
        accounting, wire-counter deltas, scheduler/crypto health). No
        `height` param lists capture summaries; `height=N` returns the
        full bundle for that height or errors if none was captured."""
        cs = getattr(self.node, "consensus_state", None)
        rec = getattr(cs, "timeline", None)
        node_key = getattr(self.node, "node_key", None)
        out: dict = {
            "node_id": node_key.id() if node_key is not None else "",
            "captures": rec.postmortems() if rec is not None else [],
        }
        h = params.get("height")
        if h is not None:
            bundle = (rec.postmortem(_int_param(h, "height"))
                      if rec is not None else None)
            if bundle is None:
                raise RPCError(
                    -32603, f"no postmortem captured for height {h}")
            out["postmortem"] = bundle
        return out

    # ------------------------------------------------------ unsafe routes

    @staticmethod
    def _addr_list(value) -> list[str]:
        """JSON body sends a real list; the URI handler sends one string
        (comma-separated) — list() on a str would explode it into
        characters."""
        if isinstance(value, str):
            return [a for a in value.split(",") if a]
        return [str(a) for a in (value or [])]

    @staticmethod
    def _bool_param(value) -> bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "t", "yes")
        return bool(value)

    async def unsafe_dial_seeds(self, params: dict) -> dict:
        """rpc/core/net.go:42 UnsafeDialSeeds."""
        seeds = self._addr_list(params.get("seeds"))
        if not seeds:
            raise RPCError(-32602, "no seeds provided")
        await self.node.switch.dial_peers_async(seeds)
        return {"log": f"dialing seeds: {seeds}"}

    async def unsafe_dial_peers(self, params: dict) -> dict:
        """rpc/core/net.go:55 UnsafeDialPeers."""
        peers = self._addr_list(params.get("peers"))
        if not peers:
            raise RPCError(-32602, "no peers provided")
        persistent = self._bool_param(params.get("persistent", False))
        await self.node.switch.dial_peers_async(peers, persistent=persistent)
        return {"log": f"dialing peers: {peers}"}

    async def unsafe_flush_mempool(self, _params: dict) -> dict:
        await self.node.mempool.flush()
        return {}

    async def unsafe_disconnect_peers(self, _params: dict) -> dict:
        """Framework extension (the e2e 'disconnect' perturbation,
        test/e2e/runner/perturb.go:44-100 severs the container network;
        process-level nets sever here instead): drop every current peer
        conn. Persistent peers redial on their own backoff."""
        sw = self.node.switch
        peers = list(sw.peers.values())
        for p in peers:
            # operator action, not peer misbehavior: never score it
            await sw.stop_peer_for_error(p, "unsafe_disconnect_peers", score=0.0)
        return {"disconnected": len(peers)}

    async def unsafe_net_chaos(self, params: dict) -> dict:
        """Framework extension (the e2e 'partition' perturbation): arm or
        heal the process-global net-chaos registry at runtime. `spec` uses
        the CBFT_NET_CHAOS syntax (p2p/netchaos.py); `heal` clears the
        partition map (starting the heal clock); `clear` resets everything."""
        from cometbft_tpu_torch.p2p import netchaos

        if self._bool_param(params.get("clear", False)):
            netchaos.reset()
            return {"net_chaos": netchaos.snapshot()}
        spec = str(params.get("spec", "") or "")
        if spec:
            netchaos.arm_spec(spec)
        if self._bool_param(params.get("heal", False)):
            netchaos.clear_partition()
        return {"net_chaos": netchaos.snapshot()}

    async def unsafe_disk_chaos(self, params: dict) -> dict:
        """Framework extension (the e2e disk-fault perturbations): arm or
        clear the process-global disk-chaos registry at runtime. `spec`
        uses the CBFT_DISK_CHAOS syntax (libs/diskchaos.py); `clear`
        resets everything."""
        from cometbft_tpu_torch.libs import diskchaos

        if self._bool_param(params.get("clear", False)):
            diskchaos.reset()
            return {"disk_chaos": diskchaos.snapshot()}
        spec = str(params.get("spec", "") or "")
        if spec:
            try:
                diskchaos.arm_spec(spec)
            except ValueError as e:
                raise RPCError(-32602, str(e)) from None
        return {"disk_chaos": diskchaos.snapshot()}

    # ------------------------------------------------------------ table

    def routes(self) -> dict:
        """routes.go:12-56 (+ AddUnsafeRoutes when config.rpc.unsafe)."""
        table = self._routes_table()
        cfg = getattr(self.node, "config", None)
        if cfg is not None and getattr(cfg.rpc, "unsafe", False):
            table.update({
                "dial_seeds": self.unsafe_dial_seeds,
                "dial_peers": self.unsafe_dial_peers,
                "unsafe_flush_mempool": self.unsafe_flush_mempool,
                "unsafe_disconnect_peers": self.unsafe_disconnect_peers,
                "unsafe_net_chaos": self.unsafe_net_chaos,
                "unsafe_disk_chaos": self.unsafe_disk_chaos,
            })
        return table

    def _routes_table(self) -> dict:
        return {
            "health": self.health,
            "crypto_health": self.crypto_health,
            "storage_health": self.storage_health,
            "trace_dump": self.trace_dump,
            "consensus_timeline": self.consensus_timeline,
            "postmortems": self.postmortems,
            "status": self.status,
            "net_info": self.net_info,
            "net_telemetry": self.net_telemetry,
            "genesis": self.genesis,
            "block": self.block,
            "block_by_hash": self.block_by_hash,
            "block_results": self.block_results,
            "header": self.header,
            "header_by_hash": self.header_by_hash,
            "blockchain": self.blockchain,
            "commit": self.commit,
            "consensus_params": self.consensus_params,
            "dump_consensus_state": self.dump_consensus_state,
            "check_tx": self.check_tx,
            "genesis_chunked": self.genesis_chunked,
            "light_block": self.light_block,
            "light_verify": self.light_verify,
            "commit_certificate": self.commit_certificate,
            "validators": self.validators,
            "consensus_state": self.consensus_state,
            "abci_info": self.abci_info,
            "abci_query": self.abci_query,
            "broadcast_tx_async": self.broadcast_tx_async,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "tx": self.tx,
            "tx_search": self.tx_search,
            "block_search": self.block_search,
            "unconfirmed_txs": self.unconfirmed_txs,
            "num_unconfirmed_txs": self.num_unconfirmed_txs,
            "broadcast_evidence": self.broadcast_evidence,
        }
