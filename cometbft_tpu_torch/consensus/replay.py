"""ABCI handshake: sync the application to the block store on boot.

Reference: consensus/replay.go:200-530. On start the node asks the app
its height (ABCI Info), compares with the state store and block store,
and replays whatever the app missed:

  app at 0                -> InitChain from genesis (replay.go:308-360)
  app < state height      -> re-execute stored blocks against the app only
  state = store height -1 -> the crash window between the WAL EndHeight
                             fsync and the state-store save: apply the
                             stored last block through the BlockExecutor,
                             which re-saves state (replay.go:414-460)
  app ahead of state by 1 -> state update only, using the stored
                             FinalizeBlockResponse as a mock app
                             (replay.go:462-480)

This is the recovery path the round-2 WAL replay guard punts to
(state.py _catchup_replay raising on found EndHeight).

The port's copy of cometbft_tpu/consensus/replay.py.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.state import BlockExecutor, State
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.types.genesis import GenesisDoc


class ErrAppBlockHeightTooHigh(Exception):
    pass


class _NullMempool:
    """Handshake executes without a live mempool (replay.go:472
    emptyMempool)."""

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        return []

    async def update(self, height: int, txs, tx_results) -> None:
        return None


class _StoredResponseClient:
    """Mock consensus conn answering FinalizeBlock from the state store's
    saved response — used when the app already ran the block but the state
    save was lost (replay.go:462 mockProxyApp)."""

    def __init__(self, resp):
        self._resp = resp

    async def finalize_block(self, req):
        return self._resp

    async def commit(self, req):
        return abci.ResponseCommit()


class Handshaker:
    def __init__(
        self,
        state_store: StateStore,
        block_store: BlockStore,
        genesis_doc: GenesisDoc,
        logger: cmtlog.Logger | None = None,
    ):
        self.state_store = state_store
        self.block_store = block_store
        self.genesis_doc = genesis_doc
        self.logger = logger or cmtlog.nop()
        self.n_blocks_replayed = 0

    async def handshake(self, proxy_app) -> State:
        """replay.go:241-280 Handshake: Info -> ReplayBlocks."""
        res = await proxy_app.query.info(abci.RequestInfo(version="", block_version=11))
        app_height = res.last_block_height
        app_hash = res.last_block_app_hash
        if app_height < 0:
            raise ValueError(f"got negative last block height {app_height} from app")
        self.logger.info(
            "ABCI handshake", app_height=app_height, app_hash=app_hash.hex()[:12]
        )
        state = self.state_store.load()
        if state is None:
            state = State.from_genesis(self.genesis_doc)
            self.state_store.bootstrap(state)
        state = await self.replay_blocks(state, app_hash, app_height, proxy_app)
        self.logger.info(
            "completed ABCI handshake", height=state.last_block_height,
            replayed=self.n_blocks_replayed,
        )
        return state

    async def replay_blocks(
        self, state: State, app_hash: bytes, app_height: int, proxy_app
    ) -> State:
        """replay.go:283-460 ReplayBlocks."""
        store_height = self.block_store.height()
        state_height = state.last_block_height

        # 1. fresh app: InitChain (replay.go:308-360)
        if app_height == 0:
            gdoc = self.genesis_doc
            req = abci.RequestInitChain(
                time=gdoc.genesis_time,
                chain_id=gdoc.chain_id,
                consensus_params=None,
                validators=[
                    abci.ValidatorUpdate(
                        power=v.power,
                        pub_key_type=v.pub_key.type_(),
                        pub_key_bytes=v.pub_key.bytes_(),
                    )
                    for v in gdoc.validators
                ],
                app_state_bytes=gdoc.app_state,
                initial_height=gdoc.initial_height,
            )
            resp = await proxy_app.consensus.init_chain(req)
            if state_height == 0:  # only a genesis state may be amended
                if resp.app_hash:
                    state.app_hash = resp.app_hash
                    app_hash = resp.app_hash
                if resp.validators:
                    from cometbft_tpu_torch.state.execution import _validator_updates_to_vals
                    from cometbft_tpu_torch.types.validator import ValidatorSet

                    vals = _validator_updates_to_vals(resp.validators)
                    state.validators = ValidatorSet(vals)
                    nxt = ValidatorSet(vals)
                    nxt.increment_proposer_priority(1)
                    state.next_validators = nxt
                if resp.consensus_params is not None:
                    state.consensus_params = state.consensus_params.update(resp.consensus_params)
                self.state_store.save(state)

        # 2. nothing stored yet
        if store_height == 0:
            self._assert_app_hash(state, app_hash)
            return state

        if app_height > store_height:
            raise ErrAppBlockHeightTooHigh(
                f"app height {app_height} exceeds store height {store_height}"
            )
        # truncated-store guards (replay.go:364-370): blocks the app would
        # need to replay have been pruned away
        store_base = self.block_store.base()
        if app_height == 0 and state.initial_height < store_base:
            raise RuntimeError(
                f"app has no state and the block store is truncated above "
                f"the initial height (store base {store_base}, initial "
                f"height {state.initial_height})")
        if 0 < app_height < store_base - 1:
            raise RuntimeError(
                f"app height {app_height} is below the truncated store "
                f"base {store_base}")
        # the height the state expects to apply next: the chain's FIRST
        # block is initial_height, not 1 (a crash between saving block
        # initial_height and the state save must remain recoverable)
        next_height = (state.initial_height if state_height == 0
                       else state_height + 1)
        if store_height > next_height:
            raise RuntimeError(
                f"block store height {store_height} is more than one ahead of "
                f"state height {state_height}"
            )

        if store_height == state_height:
            if app_height == store_height:
                # nothing to replay: the app must already match
                # (replay.go checkAppHash on the Info response)
                self._assert_app_hash(state, app_hash)
                return state
            # happy path: replay to the app only (replay.go:399-412)
            return await self._replay_to_app(state, app_height, store_height, proxy_app)

        # store_height == next_height: the crash window (one block saved
        # beyond the last applied state)
        if app_height < state_height:
            # app missed earlier blocks too: catch it up, then apply the last
            state = await self._replay_to_app(state, app_height, state_height, proxy_app)
            app_height = state_height
        if app_height == state_height:
            # app and state agree; the final stored block goes through the
            # full executor so the state store is rewritten (replay.go:414)
            return await self._apply_stored_block(state, store_height, proxy_app.consensus)
        if app_height == store_height:
            # app ran the block; rebuild state from the saved response
            resp = self.state_store.load_finalize_block_response(store_height)
            if resp is None:
                raise RuntimeError(
                    f"app is at height {app_height} but no saved FinalizeBlock "
                    f"response for it; cannot resync state"
                )
            return await self._apply_stored_block(
                state, store_height, _StoredResponseClient(resp)
            )
        raise RuntimeError(
            f"uncovered handshake case: app {app_height}, state {state_height}, "
            f"store {store_height}"
        )

    async def _replay_to_app(
        self, state: State, app_height: int, final_height: int, proxy_app
    ) -> State:
        """replay.go:500-530 applyBlock loop: FinalizeBlock+Commit only —
        state is NOT re-saved (it is already correct)."""
        from cometbft_tpu_torch.state.execution import _abci_commit_info, _abci_misbehavior

        app_hash = b""
        # a freshly-InitChained app starts at the chain's initial height,
        # which need not be 1 (replay.go:465-468)
        first = app_height + 1
        if first == 1:
            first = state.initial_height
        for h in range(first, final_height + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise RuntimeError(f"missing block {h} in store during replay")
            self.logger.info("replaying block to app", height=h)
            # signers of block h's LastCommit = validator set at h-1; the app
            # must see the same CommitInfo it saw live (execution.py:249)
            last_vals = self.state_store.load_validators(h - 1) if h > 1 else None
            req = abci.RequestFinalizeBlock(
                txs=block.data.txs,
                decided_last_commit=_abci_commit_info(block, last_vals),
                # the app must re-see the block's evidence exactly as it did
                # live, or a misbehavior-sensitive app forks its own hash
                misbehavior=_abci_misbehavior(block.evidence.evidence),
                hash=block.hash(),
                height=h,
                time=block.header.time,
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
            )
            resp = await proxy_app.consensus.finalize_block(req)
            await proxy_app.consensus.commit(abci.RequestCommit())
            app_hash = resp.app_hash
            self.n_blocks_replayed += 1
        if app_hash:
            self._assert_app_hash(state, app_hash)
        return state

    async def _apply_stored_block(self, state: State, height: int, conn) -> State:
        """replay.go:414-460: run the stored block through a BlockExecutor
        (null mempool/evidence) so updateState + state save happen."""
        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        if block is None or meta is None:
            raise RuntimeError(f"missing block {height} during handshake apply")
        exec_ = BlockExecutor(
            self.state_store, conn, _NullMempool(), evidence_pool=None,
            logger=self.logger,
        )
        self.n_blocks_replayed += 1
        return await exec_.apply_block(state, meta.block_id, block)

    def _assert_app_hash(self, state: State, app_hash: bytes) -> None:
        if state.app_hash != app_hash:
            raise RuntimeError(
                f"app hash mismatch after replay: state {state.app_hash.hex()[:12]} "
                f"vs app {app_hash.hex()[:12]}"
            )
