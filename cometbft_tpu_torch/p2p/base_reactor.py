"""Reactor interface.

Reference: p2p/base_reactor.go:15-44 — a reactor owns a set of channels and
gets peer lifecycle callbacks from the Switch. Receive is async (runs on the
peer's recv task); long work must be queued internally, mirroring the
reference rule that Receive must not block.

The port's copy of cometbft_tpu/p2p/base_reactor.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor

if TYPE_CHECKING:
    from cometbft_tpu_torch.p2p.peer import Peer
    from cometbft_tpu_torch.p2p.switch import Switch


@dataclass
class Envelope:
    """A routed message (reference p2p/types.go Envelope): raw bytes on a
    channel, plus the sender on receive."""

    channel_id: int
    message: bytes
    src: Optional["Peer"] = None


class Reactor:
    def __init__(self, name: str, logger: cmtlog.Logger | None = None):
        self.name = name
        self.logger = logger or cmtlog.nop()
        self.switch: Optional["Switch"] = None

    def set_switch(self, switch: "Switch") -> None:
        self.switch = switch

    def get_channels(self) -> list[ChannelDescriptor]:
        return []

    async def on_start(self) -> None:
        pass

    async def on_stop(self) -> None:
        pass

    def init_peer(self, peer: "Peer") -> None:
        """Called before the peer starts — attach per-peer state."""

    async def add_peer(self, peer: "Peer") -> None:
        """Called once the peer is running — start per-peer routines."""

    async def remove_peer(self, peer: "Peer", reason: object) -> None:
        """Called on disconnect — tear down per-peer routines."""

    async def receive(self, e: Envelope) -> None:
        """A complete message arrived on one of this reactor's channels."""
