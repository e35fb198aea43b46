"""Evidence verification (reference: evidence/verify.go). The port's copy
of cometbft_tpu/evidence/verify.py's entry points; the pool (pool.py) and
the gossip reactor (reactor.py) of the reference come with the node.
"""

from cometbft_tpu_torch.evidence.verify import (  # noqa: F401
    ErrInvalidEvidence,
    verify_duplicate_vote,
    verify_evidence,
    verify_light_client_attack,
)
