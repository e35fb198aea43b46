"""Load generation + transaction-latency reporting.

Reference: test/loadtime — `load` stamps each generated transaction with
its creation time plus the load parameters (connections, rate, size) and
broadcasts it; `report` walks committed blocks and computes each stamped
tx's latency as block_time - tx_time, aggregating min/max/avg/stddev/
percentiles per experiment (test/loadtime/payload/payload.go,
test/loadtime/report/report.go:20-120).

Payload wire format here is JSON (prefix-tagged, zero-padded to the
requested size); the report accepts either a live RPC endpoint or a
BlockStore. The CLI surface is `cometbft_tpu_torch loadtime run|report`.

The port's copy of cometbft_tpu/loadtime.py (standard library only).
"""

from __future__ import annotations

import asyncio
import base64
import json
import secrets
import statistics
import time
import urllib.request
from dataclasses import dataclass, field

PREFIX = b"ldtm:"


def make_tx(experiment_id: str, seq: int, size: int, rate: float,
            connections: int) -> bytes:
    """payload.go NewBytes: stamp creation time + load parameters, pad to
    `size` bytes so tx bytes/block dynamics match the experiment."""
    doc = {
        "id": experiment_id,
        "seq": seq,
        "time_ns": time.time_ns(),
        "rate": rate,
        "conns": connections,
        "size": size,
    }
    body = PREFIX + json.dumps(doc, separators=(",", ":")).encode()
    if len(body) < size:
        pad = size - len(body) - 1
        body += b"/" + secrets.token_hex((pad + 1) // 2).encode()[:pad]
    return body


def parse_tx(tx: bytes) -> dict | None:
    if not tx.startswith(PREFIX):
        return None
    raw = tx[len(PREFIX):]
    end = raw.rfind(b"/")
    if end != -1:
        candidate = raw[:end]
    else:
        candidate = raw
    try:
        return json.loads(candidate)
    except ValueError:
        try:
            return json.loads(raw)
        except ValueError:
            return None


@dataclass
class LoadResult:
    sent: int = 0
    accepted: int = 0
    rejected: int = 0
    errors: int = 0


async def generate_load(
    endpoints: list[str],
    rate: float,
    duration: float,
    size: int = 256,
    experiment_id: str = "",
    method: str = "broadcast_tx_async",
) -> tuple[str, LoadResult]:
    """Drive `rate` tx/s across the endpoints for `duration` seconds
    (round-robin). Posts run CONCURRENTLY (bounded in-flight pool) so the
    achieved rate is not capped at 1/RTT — the reference's tm-load-test
    connections behave the same way."""
    if not endpoints:
        raise ValueError("loadtime: at least one RPC endpoint is required")
    experiment_id = experiment_id or secrets.token_hex(8)
    res = LoadResult()
    interval = 1.0 / rate if rate > 0 else 0.01
    deadline = time.monotonic() + duration
    seq = 0
    sem = asyncio.Semaphore(64)

    def post(url: str, tx: bytes) -> bool:
        body = json.dumps({
            "jsonrpc": "2.0", "id": 1, "method": method,
            "params": {"tx": base64.b64encode(tx).decode()},
        }).encode()
        req = urllib.request.Request(
            url + "/", data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.load(r)
        return "error" not in doc and int(doc["result"].get("code", 0)) == 0

    async def send_one(url: str, tx: bytes) -> None:
        async with sem:
            try:
                ok = await asyncio.to_thread(post, url, tx)
                if ok:
                    res.accepted += 1
                else:
                    res.rejected += 1
            except Exception:  # noqa: BLE001 - endpoint hiccups count as errors
                res.errors += 1

    tasks: list[asyncio.Task] = []
    next_at = time.monotonic()
    while time.monotonic() < deadline:
        tx = make_tx(experiment_id, seq, size, rate, len(endpoints))
        url = endpoints[seq % len(endpoints)]
        seq += 1
        res.sent += 1
        tasks.append(asyncio.create_task(send_one(url, tx)))
        next_at += interval
        delay = next_at - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
    await asyncio.gather(*tasks)
    return experiment_id, res


async def generate_saturation(
    submit,
    waves: int,
    wave_size: int,
    size: int = 256,
    experiment_id: str = "",
    interval: float = 0.0,
    rate_hint: float = 0.0,
    max_inflight: int = 0,
) -> tuple[str, LoadResult]:
    """Saturation-wave generator for the overload plane: where
    generate_load paces to a target rate, each wave here fires
    `wave_size` submissions CONCURRENTLY and waits them all out — the
    point is to exceed the admission ceiling, not to hold a rate. The
    `submit` callable (async, tx -> bool) abstracts the path: the
    in-proc soak harness hands mempool.check_tx, e2e hands
    rpc_submitter(). True = accepted, False = shed/rejected,
    raise = transport error.

    `max_inflight` bounds CONCURRENT submissions (0 = unbounded). The
    in-proc soak must set this: it calls mempool.check_tx directly,
    bypassing the RPC server's in-flight budget, and an unbounded wave
    of thousands of tasks on the shared event loop starves the very
    consensus coroutines the soak is grading — a failure mode the RPC
    guard makes impossible over the wire. Mirror the write budget
    (rpc config overload_write_inflight) here."""
    experiment_id = experiment_id or secrets.token_hex(8)
    res = LoadResult()
    seq = 0
    sem = asyncio.Semaphore(max_inflight) if max_inflight > 0 else None

    async def one(tx: bytes) -> None:
        try:
            if await submit(tx):
                res.accepted += 1
            else:
                res.rejected += 1
        except Exception:  # noqa: BLE001 - transport hiccups count as errors
            res.errors += 1
        finally:
            if sem is not None:
                sem.release()

    for _ in range(waves):
        tasks = []
        for _ in range(wave_size):
            tx = make_tx(experiment_id, seq, size, rate_hint, 1)
            seq += 1
            res.sent += 1
            if sem is not None:
                await sem.acquire()
            tasks.append(asyncio.create_task(one(tx)))
        await asyncio.gather(*tasks)
        if interval > 0:
            await asyncio.sleep(interval)
    return experiment_id, res


def rpc_submitter(endpoint: str, method: str = "broadcast_tx_sync"):
    """An HTTP `submit` callable for generate_saturation: POST one tx,
    classify any JSON-RPC error (the unified -32005 overload shed
    included) as a rejection, transport failures raise (counted as
    errors by the generator)."""

    def post(tx: bytes) -> bool:
        body = json.dumps({
            "jsonrpc": "2.0", "id": 1, "method": method,
            "params": {"tx": base64.b64encode(tx).decode()},
        }).encode()
        req = urllib.request.Request(
            endpoint + "/", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.load(r)
        if "error" in doc:
            return False
        return int(doc["result"].get("code", 0)) == 0

    async def submit(tx: bytes) -> bool:
        return await asyncio.to_thread(post, tx)

    return submit


# ---------------------------------------------------------------- report


@dataclass
class Report:
    """report.go:20-120 Report: latency stats for one experiment id."""

    experiment_id: str
    txs: int = 0
    negative: int = 0
    all_latencies_s: list[float] = field(default_factory=list)

    def add(self, latency_s: float) -> None:
        self.txs += 1
        if latency_s < 0:
            self.negative += 1
        self.all_latencies_s.append(latency_s)

    def stats(self) -> dict:
        lat = sorted(self.all_latencies_s)
        if not lat:
            return {"experiment_id": self.experiment_id, "txs": 0}

        def pct(q: float) -> float:
            # nearest-rank: ceil(n*q)-th smallest (1-indexed)
            import math

            return lat[max(0, math.ceil(len(lat) * q) - 1)]

        return {
            "experiment_id": self.experiment_id,
            "txs": self.txs,
            "negative_latencies": self.negative,
            "min_s": round(lat[0], 4),
            "max_s": round(lat[-1], 4),
            "avg_s": round(statistics.fmean(lat), 4),
            "stddev_s": round(statistics.pstdev(lat), 4) if len(lat) > 1 else 0.0,
            "p50_s": round(pct(0.50), 4),
            "p95_s": round(pct(0.95), 4),
            "p99_s": round(pct(0.99), 4),
        }


def report_from_blocks(blocks) -> dict[str, Report]:
    """blocks: iterable of (block_time_ns, [tx bytes]) — per-experiment
    latency = block time - stamped creation time (report.go Load)."""
    out: dict[str, Report] = {}
    for block_time_ns, txs in blocks:
        for tx in txs:
            doc = parse_tx(tx)
            if doc is None:
                continue
            rep = out.setdefault(str(doc.get("id")), Report(str(doc.get("id"))))
            rep.add((block_time_ns - int(doc["time_ns"])) / 1e9)
    return out


def blocks_from_store(block_store, from_height: int = 0, to_height: int = 0):
    base = max(block_store.base(), from_height or 1)
    top = min(block_store.height(), to_height or block_store.height())
    for h in range(base, top + 1):
        block = block_store.load_block(h)
        if block is not None:
            yield block.header.time.unix_ns(), list(block.data.txs)


def blocks_from_rpc(url: str, from_height: int = 0, to_height: int = 0):
    """Walk committed blocks over the RPC surface (report-without-disk),
    on ONE keep-alive connection — a conn-per-height walk over hundreds of
    heights churns sockets for no reason."""
    import http.client
    from urllib.parse import urlparse

    parsed = urlparse(url if "//" in url else "http://" + url)
    conn_box = [http.client.HTTPConnection(
        parsed.hostname, parsed.port, timeout=10)]

    def get(route):
        last = None
        for _ in range(3):  # reconnect retries: the node may be mid-commit
            try:
                conn_box[0].request("GET", "/" + route)
                resp = conn_box[0].getresponse()
                doc = json.loads(resp.read())
                # error replies (e.g. the height raced the pruner) are a
                # skip, not an abort
                return doc.get("result")
            except (OSError, http.client.HTTPException) as e:  # noqa: PERF203
                last = e
                conn_box[0].close()
                conn_box[0] = http.client.HTTPConnection(
                    parsed.hostname, parsed.port, timeout=10)
        raise last

    status = get("status")["sync_info"]
    base = max(int(status["earliest_block_height"]), from_height or 1)
    top = min(int(status["latest_block_height"]), to_height or 1 << 62)
    from datetime import datetime, timezone

    for h in range(base, top + 1):
        got = get(f"block?height={h}")
        if got is None:  # pruned/unavailable height: skip
            continue
        blk = got["block"]
        t = blk["header"]["time"]  # RFC3339Nano (cmttime.Timestamp.rfc3339)
        body, _, frac = t.rstrip("Z").partition(".")
        dt = datetime.strptime(body, "%Y-%m-%dT%H:%M:%S").replace(
            tzinfo=timezone.utc)
        ns = int(dt.timestamp()) * 10**9 + int((frac or "0").ljust(9, "0")[:9])
        yield ns, [base64.b64decode(x) for x in blk["data"]["txs"]]
