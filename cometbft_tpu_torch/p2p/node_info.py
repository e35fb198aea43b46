"""Node handshake info.

Reference: p2p/node_info.go — exchanged over the SecretConnection right
after the crypto handshake; carries protocol versions, the claimed node ID
(must match the SecretConnection-authenticated pubkey), network (chain
id), and the channel list for reactor compatibility checks
(node_info.go:142 CompatibleWith). Wire: the tendermint.p2p
DefaultNodeInfo protobuf (proto/tendermint/p2p/types.proto:14-34),
varint-delimited — the reference's handshake message, byte for byte.

The port's copy of cometbft_tpu/p2p/node_info.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.utils import protobuf as pb


@dataclass
class ProtocolVersion:
    p2p: int = 8
    block: int = 11
    app: int = 0


@dataclass
class NodeInfo:
    node_id: str = ""
    listen_addr: str = ""
    network: str = ""  # chain id
    version: str = ""
    channels: bytes = b""
    moniker: str = ""
    protocol_version: ProtocolVersion = field(default_factory=ProtocolVersion)
    tx_index: str = "on"
    rpc_address: str = ""

    def validate(self) -> None:
        """node_info.go:173 Validate (subset: structural checks)."""
        if not self.node_id:
            raise ValueError("node info: empty node id")
        if len(self.channels) > 64:
            raise ValueError("node info: too many channels")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError("node info: duplicate channel ids")

    def compatible_with(self, other: "NodeInfo") -> None:
        """node_info.go:142: same block protocol + network, >=1 common
        channel."""
        if self.protocol_version.block != other.protocol_version.block:
            raise ValueError(
                f"incompatible block protocol: {self.protocol_version.block} vs "
                f"{other.protocol_version.block}"
            )
        if self.network != other.network:
            raise ValueError(f"different networks: {self.network!r} vs {other.network!r}")
        if self.channels and other.channels and not set(self.channels) & set(other.channels):
            raise ValueError("no common channels")

    # ------------------------------------------------------------- codec

    def encode(self) -> bytes:
        """tendermint.p2p.DefaultNodeInfo (types.proto:20-29)."""
        pv = pb.Writer()
        pv.uvarint(1, self.protocol_version.p2p)
        pv.uvarint(2, self.protocol_version.block)
        pv.uvarint(3, self.protocol_version.app)
        other = pb.Writer()
        other.string(1, self.tx_index)
        other.string(2, self.rpc_address)
        w = pb.Writer()
        w.message(1, pv.output(), always=True)
        w.string(2, self.node_id)
        w.string(3, self.listen_addr)
        w.string(4, self.network)
        w.string(5, self.version)
        w.bytes(6, self.channels)
        w.string(7, self.moniker)
        w.message(8, other.output(), always=True)
        return w.output()

    @classmethod
    def decode(cls, data: bytes) -> "NodeInfo":
        # proto3 zero values, NOT the dataclass defaults: an absent field
        # must decode to zero (a peer omitting protocol_version must not
        # inherit OUR version numbers and sneak past compatible_with)
        out = cls(protocol_version=ProtocolVersion(p2p=0, block=0, app=0),
                  tx_index="")
        r = pb.Reader(data)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                pvr = pb.Reader(r.read_bytes())
                pv = ProtocolVersion(p2p=0, block=0, app=0)
                while not pvr.at_end():
                    pf, pw = pvr.read_tag()
                    if pf == 1:
                        pv.p2p = pvr.read_uvarint()
                    elif pf == 2:
                        pv.block = pvr.read_uvarint()
                    elif pf == 3:
                        pv.app = pvr.read_uvarint()
                    else:
                        pvr.skip(pw)
                out.protocol_version = pv
            elif f == 2:
                out.node_id = r.read_string()
            elif f == 3:
                out.listen_addr = r.read_string()
            elif f == 4:
                out.network = r.read_string()
            elif f == 5:
                out.version = r.read_string()
            elif f == 6:
                out.channels = r.read_bytes()
            elif f == 7:
                out.moniker = r.read_string()
            elif f == 8:
                orr = pb.Reader(r.read_bytes())
                while not orr.at_end():
                    of, ow = orr.read_tag()
                    if of == 1:
                        out.tx_index = orr.read_string()
                    elif of == 2:
                        out.rpc_address = orr.read_string()
                    else:
                        orr.skip(ow)
            else:
                r.skip(w)
        return out
