"""Commit certificates: succinct finality certificates. The port's copy of
cometbft_tpu/cert/__init__.py, the certificate's names only.

A CommitCertificate condenses an all-BLS commit into one aggregated G2
signature plus a signer bitmap, verified with ONE pairing-product check on
the card (ops/bls_kernel.aggregate_verify_agg: B1-B5). The production and
serving plane of the reference (cert/plane.py, cert/store.py) comes with
the node.
"""

from cometbft_tpu_torch.cert.certificate import (
    CommitCertificate,
    ErrCertInvalid,
    attests_commit,
    build_certificate,
    matches_commit,
    verify_certificate,
)

__all__ = [
    "CommitCertificate",
    "ErrCertInvalid",
    "attests_commit",
    "build_certificate",
    "matches_commit",
    "verify_certificate",
]
