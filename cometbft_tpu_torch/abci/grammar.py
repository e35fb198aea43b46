"""ABCI call-sequence conformance checker.

Reference: test/e2e/pkg/grammar/checker.go + the clean-start / recovery
context-free grammars derived from the ABCI 2.0 expected-behavior spec.
The reference generates a parser with gogll; the grammars are regular
enough for a direct recursive-descent over the recorded call names:

  clean-start = init_chain [state-sync] consensus-exec
  state-sync  = *(offer_snapshot *apply_chunk) offer_snapshot 1*apply_chunk
  recovery    = consensus-exec
  consensus-exec   = 1*consensus-height
  consensus-height = *consensus-round finalize_block commit
  consensus-round  = prepare_proposal [process_proposal] | process_proposal

RecordingApplication wraps any Application, recording the consensus/
snapshot-connection calls the grammar covers so a running node's trace can
be checked (the reference records the same subset and trims the trailing
partial height, checker.go:74).

The port's copy of cometbft_tpu/abci/grammar.py.
"""

from __future__ import annotations

GRAMMAR_CALLS = (
    "init_chain", "offer_snapshot", "apply_snapshot_chunk",
    "prepare_proposal", "process_proposal", "finalize_block", "commit",
)


class GrammarError(Exception):
    def __init__(self, trace: list[str], pos: int, why: str):
        window = " ".join(trace[max(0, pos - 3):pos + 3])
        super().__init__(f"ABCI grammar violation at call {pos} ({why}); "
                         f"context: ...{window}...")
        self.pos = pos


class RecordingApplication:
    """Transparent Application wrapper recording grammar-relevant calls."""

    def __init__(self, inner):
        self._inner = inner
        self.trace: list[str] = []

    def __getattr__(self, name):
        fn = getattr(self._inner, name)
        if name in GRAMMAR_CALLS and callable(fn):
            def wrapped(*a, **kw):
                self.trace.append(name)
                return fn(*a, **kw)

            return wrapped
        return fn


def _trim_last_partial_height(trace: list[str]) -> list[str]:
    """checker.go:74 filterRequests: the node may be mid-height when the
    trace is captured; drop everything after the last commit."""
    for i in range(len(trace) - 1, -1, -1):
        if trace[i] == "commit":
            return trace[:i + 1]
    return []


def check(trace: list[str], clean_start: bool) -> None:
    """Raise GrammarError unless the trace parses. clean_start: the node
    booted from genesis (expects init_chain and optionally state sync);
    otherwise the recovery grammar (pure consensus-exec) applies."""
    t = _trim_last_partial_height([c for c in trace if c in GRAMMAR_CALLS])
    if not t:
        raise GrammarError(trace, 0, "no complete height recorded")
    i = 0

    def peek(k: int = 0) -> str | None:
        return t[i + k] if i + k < len(t) else None

    if clean_start:
        if peek() != "init_chain":
            raise GrammarError(t, i, "clean start must begin with init_chain")
        i += 1
        # state-sync: attempts then a success (offer + 1*apply), optional
        while peek() == "offer_snapshot":
            i += 1
            applied = 0
            while peek() == "apply_snapshot_chunk":
                i += 1
                applied += 1
            if peek() != "offer_snapshot" and applied == 0:
                raise GrammarError(
                    t, i, "a successful state sync needs >=1 apply_snapshot_chunk")

    # consensus-exec: 1 or more heights
    heights = 0
    while i < len(t):
        # *consensus-round
        while peek() in ("prepare_proposal", "process_proposal"):
            if peek() == "prepare_proposal":
                i += 1
                if peek() == "process_proposal":
                    i += 1
            else:
                i += 1
        if peek() != "finalize_block":
            raise GrammarError(t, i, f"expected finalize_block, got {peek()!r}")
        i += 1
        if peek() != "commit":
            raise GrammarError(t, i, f"expected commit after finalize_block, got {peek()!r}")
        i += 1
        heights += 1
    if heights == 0:
        raise GrammarError(t, i, "no consensus heights")
