"""Evidence (reference: evidence/). The port's copies of
cometbft_tpu/evidence/verify.py and pool.py: verification, and the pool
that the consensus engine's equivocations fill and proposals reap. The
gossip reactor is evidence/reactor.py.
"""

from cometbft_tpu_torch.evidence.verify import (  # noqa: F401
    ErrInvalidEvidence,
    verify_duplicate_vote,
    verify_evidence,
    verify_light_client_attack,
)
from cometbft_tpu_torch.evidence.pool import EvidencePool  # noqa: F401
