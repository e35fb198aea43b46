"""Peer exchange (reference: p2p/pex/). The port's copy of
cometbft_tpu/p2p/pex/.
"""

from cometbft_tpu_torch.p2p.pex.addrbook import AddrBook, NetAddress, group16
from cometbft_tpu_torch.p2p.pex.byzantine import ByzantinePexHarness
from cometbft_tpu_torch.p2p.pex.reactor import PEXReactor

__all__ = ["AddrBook", "ByzantinePexHarness", "NetAddress", "PEXReactor",
           "group16"]
