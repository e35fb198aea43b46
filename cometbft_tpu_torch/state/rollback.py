"""State rollback (reference: state/rollback.go).

Overwrites the current state (height n) with the reconstructed state at
n-1 — the recovery tool for an app that needs to re-run the last block
(e.g. after a faulty upgrade). Does NOT touch application state; with
remove_block the block at n is also deleted so both stores sit at n-1.

The port's copy of cometbft_tpu/state/rollback.py.
"""

from __future__ import annotations

from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.state.store import StateStore, _hkey


class ErrRollback(Exception):
    pass


def rollback(block_store, state_store: StateStore,
             remove_block: bool = False) -> tuple[int, bytes]:
    """rollback.go:15-130 -> (new height, app hash)."""
    invalid_state = state_store.load()
    if invalid_state is None:
        raise ErrRollback("no state found")
    height = block_store.height()

    # state/blocks persist non-atomically: a pending extra block can exist
    if height == invalid_state.last_block_height + 1:
        if remove_block:
            block_store.delete_latest_block()
        return invalid_state.last_block_height, invalid_state.app_hash

    if height != invalid_state.last_block_height:
        raise ErrRollback(
            f"statestore height ({invalid_state.last_block_height}) is not one "
            f"below or equal to blockstore height ({height})")

    rollback_height = invalid_state.last_block_height - 1
    rollback_meta = block_store.load_block_meta(rollback_height)
    if rollback_meta is None:
        raise ErrRollback(f"block at height {rollback_height} not found")
    # app hash and last-results hash for n-1 are agreed in block n
    latest_meta = block_store.load_block_meta(invalid_state.last_block_height)
    if latest_meta is None:
        raise ErrRollback(f"block at height {invalid_state.last_block_height} not found")

    prev_last_vals = state_store.load_validators(rollback_height)
    if prev_last_vals is None:
        raise ErrRollback(f"no validator set at height {rollback_height}")

    # consensus params as-of rollback_height+1 (CP rows carry full snapshots)
    raw_cp = state_store.db.get(_hkey(b"CP:", rollback_height + 1))
    prev_params = (
        State.from_bytes(raw_cp).consensus_params if raw_cp is not None
        else invalid_state.consensus_params
    )

    val_change = min(invalid_state.last_height_validators_changed, rollback_height + 1)
    params_change = min(
        invalid_state.last_height_consensus_params_changed, rollback_height + 1)

    rolled = State(
        chain_id=invalid_state.chain_id,
        initial_height=invalid_state.initial_height,
        last_block_height=rollback_meta.header.height,
        last_block_id=rollback_meta.block_id,
        last_block_time=rollback_meta.header.time,
        next_validators=invalid_state.validators,
        validators=invalid_state.last_validators,
        last_validators=prev_last_vals,
        last_height_validators_changed=val_change,
        consensus_params=prev_params,
        last_height_consensus_params_changed=params_change,
        last_results_hash=latest_meta.header.last_results_hash,
        app_hash=latest_meta.header.app_hash,
        app_version=invalid_state.app_version,
    )
    state_store.save(rolled)
    if remove_block:
        block_store.delete_latest_block()
    return rolled.last_block_height, rolled.app_hash
