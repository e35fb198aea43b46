"""Node identity key.

The port's copy of cometbft_tpu/p2p/key.py. Reference: p2p/key.go — every node has a persistent ed25519 keypair; the
node ID is the hex-encoded address (first 20 bytes of SHA-256 of the raw
public key), giving an authenticated identity the SecretConnection
handshake proves possession of.
"""

from __future__ import annotations

import json
import os

from cometbft_tpu_torch.crypto import ed25519


def node_id_from_pubkey(pub: ed25519.PubKey) -> str:
    """p2p/key.go:45 PubKeyToID: hex(address)."""
    return pub.address().hex()


class NodeKey:
    def __init__(self, priv_key: ed25519.PrivKey):
        self.priv_key = priv_key

    @property
    def pub_key(self) -> ed25519.PubKey:
        return self.priv_key.pub_key()

    def id(self) -> str:
        return node_id_from_pubkey(self.pub_key)

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = {
            "priv_key": {
                "type": "tendermint/PrivKeyEd25519",
                "value": self.priv_key.bytes_().hex(),
            }
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            doc = json.load(f)
        return cls(ed25519.PrivKey(bytes.fromhex(doc["priv_key"]["value"])))

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        """p2p/key.go:75 LoadOrGenNodeKey."""
        if os.path.exists(path):
            return cls.load(path)
        nk = cls(ed25519.PrivKey(os.urandom(ed25519.SEED_SIZE)))
        nk.save(path)
        return nk
