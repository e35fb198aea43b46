"""Light-client error taxonomy (reference: light/errors.go).

The port's copy of cometbft_tpu/light/errors.py.
"""

from __future__ import annotations


class LightClientError(Exception):
    """Base for all light-client failures."""


class ErrOldHeaderExpired(LightClientError):
    """light/errors.go:15 — trusted header is outside the trusting period."""

    def __init__(self, expired_at, now):
        super().__init__(f"old header has expired at {expired_at} (now: {now})")
        self.expired_at = expired_at
        self.now = now


class ErrNewValSetCantBeTrusted(LightClientError):
    """light/errors.go:26 — less than trust-level of the trusted valset
    signed the new header; bisection should try a closer header."""

    def __init__(self, cause):
        super().__init__(f"can't trust new val set: {cause}")
        self.cause = cause


class ErrInvalidHeader(LightClientError):
    """light/errors.go:36 — the new header is outright invalid (the provider
    is faulty or lying; drop it)."""

    def __init__(self, cause):
        super().__init__(f"invalid header: {cause}")
        self.cause = cause


class ErrVerificationFailed(LightClientError):
    """light/errors.go:44 — verification failed at some intermediate height
    during bisection."""

    def __init__(self, from_height: int, to_height: int, cause: Exception):
        super().__init__(
            f"verify from #{from_height} to #{to_height} failed: {cause}"
        )
        self.from_height = from_height
        self.to_height = to_height
        self.cause = cause


class ErrLightClientAttack(LightClientError):
    """light/errors.go:60 — a witness disagreed with the primary and the
    divergence was confirmed: someone is lying."""


class ErrFailedHeaderCrossReferencing(LightClientError):
    """light/errors.go:55 — every witness failed to provide a comparison
    header; can't establish divergence."""


class ErrNoWitnesses(LightClientError):
    """light/errors.go:69 — no witnesses connected; cross-checking is off."""


class ErrLightBlockNotFound(LightClientError):
    """light/provider/errors.go:12 — provider has no block at that height."""


class ErrHeightTooHigh(LightClientError):
    """light/provider/errors.go:16 — height above the provider's head."""


class ErrBadLightBlock(LightClientError):
    """light/provider/errors.go:20 — provider returned a malformed block."""
