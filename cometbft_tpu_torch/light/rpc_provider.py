"""RPC-backed light-block provider.

Reference: light/provider/http (an RPC client fetching SignedHeader +
paginated validators). This variant: one `light_block` RPC returns
the wire-exact LightBlock proto (rpc/core.py light_block route) — no JSON
reassembly, no pagination, and the bytes that hash are the bytes verified.

The port's copy of cometbft_tpu/light/rpc_provider.py; its `light.fetch`
chaos site fires once an attempt.
"""

from __future__ import annotations

import asyncio
import base64
import json
import random
import socket
import urllib.error
import urllib.request

from cometbft_tpu_torch.types.light import LightBlock

from cometbft_tpu_torch.light.errors import (
    ErrBadLightBlock,
    ErrHeightTooHigh,
    ErrLightBlockNotFound,
)
from cometbft_tpu_torch.light.provider import Provider


def _transient(e: BaseException) -> bool:
    """Worth retrying? Timeouts, connection resets, and 5xx server
    errors are one flaky hop; 4xx, malformed bodies, and RPC-level
    errors are the provider's answer and retrying cannot change it.
    The chaos taxonomy maps the same way (libs/chaos.py): transient and
    timeout retry, permanent does not."""
    from cometbft_tpu_torch.libs import chaos as _chaos

    if isinstance(e, urllib.error.HTTPError):
        return 500 <= e.code < 600
    if isinstance(e, (_chaos.ChaosTransientError, _chaos.ChaosTimeout)):
        return True
    if isinstance(e, _chaos.ChaosPermanentError):
        return False
    return isinstance(e, (urllib.error.URLError, socket.timeout,
                          TimeoutError, ConnectionError, OSError))


def normalize_rpc_url(base_url: str) -> str:
    """tcp://host:port or bare host:port -> http URL (shared by the RPC
    provider and the light proxy's primary client)."""
    url = base_url.rstrip("/")
    if not url.startswith("http"):
        url = "http://" + url.removeprefix("tcp://")
    return url


class RPCProvider(Provider):
    """light/provider/http/http.go shape over the framework's JSON-RPC.

    Transient provider errors (timeouts, connection resets, 5xx) retry
    with capped exponential backoff + jitter instead of failing the
    whole bisection on one flaky witness hop — the dispatch supervisor's
    retry policy applied to the light provider seam. The `light.fetch`
    chaos site (libs/chaos.py) fires once per ATTEMPT, so a
    deterministic schedule (`light.fetch=transient:2`) exercises
    exactly two retries; netchaos-shaped real links exercise the same
    path through genuine socket timeouts."""

    def __init__(self, chain_id: str, base_url: str, timeout: float = 10.0,
                 retry_attempts: int = 3, backoff_base: float = 0.05,
                 backoff_cap: float = 1.0):
        self.chain_id = chain_id
        self.base_url = normalize_rpc_url(base_url)
        self.timeout = timeout
        self.retry_attempts = retry_attempts
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.retries = 0  # lifetime transient retries (test/health surface)

    def _get(self, route: str) -> dict:
        from cometbft_tpu_torch.libs import chaos as _chaos

        _chaos.fire("light.fetch")
        with urllib.request.urlopen(
                f"{self.base_url}/{route}", timeout=self.timeout) as r:
            return json.load(r)

    async def _get_retrying(self, route: str) -> dict:
        attempt = 0
        while True:
            try:
                return await asyncio.to_thread(self._get, route)
            except Exception as e:  # noqa: BLE001 - classified below
                if attempt >= self.retry_attempts or not _transient(e):
                    raise
                delay = min(self.backoff_base * (2 ** attempt),
                            self.backoff_cap)
                delay += random.uniform(0, delay)  # full jitter
                attempt += 1
                self.retries += 1
                await asyncio.sleep(delay)

    async def light_block(self, height: int) -> LightBlock:
        route = "light_block" + (f"?height={height}" if height else "")
        try:
            doc = await self._get_retrying(route)
        except Exception as e:  # noqa: BLE001 - network/HTTP failures
            raise ErrLightBlockNotFound(f"{self.base_url}: {e}") from e
        if "error" in doc:
            code = doc["error"].get("code", 0)
            msg = doc["error"].get("message", "")
            if code == -32001:  # no block material at that height
                raise ErrLightBlockNotFound(msg)
            raise ErrBadLightBlock(f"code {code}: {msg}")
        try:
            return LightBlock.from_proto(
                base64.b64decode(doc["result"]["light_block"]))
        except Exception as e:  # noqa: BLE001 - malformed proto is malicious
            raise ErrBadLightBlock(f"{self.base_url}: {e}") from e

    async def commit_certificate(self, height: int):
        """Fetch the node's commit certificate at height via the
        `commit_certificate` route, decoded, or None on ANY failure —
        certificates are an accept-only shortcut, so a missing/disabled
        route or malformed payload just means the classic path runs."""
        from cometbft_tpu_torch.cert import CommitCertificate

        try:
            doc = await self._get_retrying(
                f"commit_certificate?height={height}")
            if "error" in doc:
                return None
            return CommitCertificate.decode(
                base64.b64decode(doc["result"]["certificate"]))
        except Exception:  # noqa: BLE001 - no cert = classic verification
            return None

    async def report_evidence(self, ev) -> None:
        from cometbft_tpu_torch.types.evidence import evidence_list_to_proto

        hex_ev = evidence_list_to_proto([ev]).hex()
        try:
            await asyncio.to_thread(self._get, f"broadcast_evidence?evidence={hex_ev}")
        except Exception:  # noqa: BLE001 - best-effort (provider may be the liar)
            pass

    def id_(self) -> str:
        return self.base_url
