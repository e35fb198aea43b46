"""Version constants. The port's copy of cometbft_tpu/version.py.

Mirrors the reference's version package (version/version.go:1-21): a semver
core version plus protocol versions for the block and p2p wire formats and the
ABCI application interface. The block and p2p protocol versions are the
JAX package's, so the two packages' nodes agree on the wire and on block
headers.
"""

# Framework semver.
CMTSemVer = "0.1.0-gpu"

# ABCI application-protocol semver (reference: version/version.go ABCIVersion).
ABCIVersion = "2.0.0"

# Block protocol version (reference: version/version.go BlockProtocol = 11).
BlockProtocol = 11

# P2P protocol version (reference: version/version.go P2PProtocol = 8).
P2PProtocol = 8

# GPU crypto-backend version (new in this framework).
GPUCryptoBackend = 1
