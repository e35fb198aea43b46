"""Light client (reference: light/). The port's copy of
cometbft_tpu/light/__init__.py.

verifier — stateless VerifyAdjacent / VerifyNonAdjacent / Verify / backwards
           and the certificate hop (verify_with_certificate)
client   — trusted store + bisection + fork detection + attack evidence
provider — light-block sources (in-memory, node-backed; over RPC in
           rpc_provider.py)
store    — persisted trusted light blocks
fleet    — the serving plane (no reference analog): coalesced skipping
           verification, checkpoint skip-list cache, streaming
           verified-header subscriptions (light/fleet.py); proxy.py is
           the `light` command's verified RPC proxy
"""

from cometbft_tpu_torch.light import errors, verifier
from cometbft_tpu_torch.light.client import (
    SEQUENTIAL,
    SKIPPING,
    Client,
    TrustOptions,
    make_attack_evidence,
)
from cometbft_tpu_torch.light.fleet import (
    CheckpointCache,
    FleetSaturated,
    LightFleet,
    SubscriptionClosed,
)
from cometbft_tpu_torch.light.errors import (
    ErrInvalidHeader,
    ErrLightClientAttack,
    ErrNewValSetCantBeTrusted,
    ErrOldHeaderExpired,
    ErrVerificationFailed,
    LightClientError,
)
from cometbft_tpu_torch.light.provider import MemProvider, NodeBackedProvider, Provider
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.light.verifier import (
    DEFAULT_TRUST_LEVEL,
    header_expired,
    validate_trust_level,
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
    verify_with_certificate,
)

__all__ = [
    "errors", "verifier", "Client", "TrustOptions", "SEQUENTIAL", "SKIPPING",
    "CheckpointCache", "FleetSaturated", "LightFleet", "SubscriptionClosed",
    "make_attack_evidence", "MemProvider", "NodeBackedProvider", "Provider", "LightStore",
    "DEFAULT_TRUST_LEVEL", "header_expired", "validate_trust_level",
    "verify", "verify_adjacent", "verify_backwards", "verify_non_adjacent",
    "verify_with_certificate",
    "ErrInvalidHeader", "ErrLightClientAttack", "ErrNewValSetCantBeTrusted",
    "ErrOldHeaderExpired", "ErrVerificationFailed", "LightClientError",
]
