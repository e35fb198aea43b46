"""Background pruning service driven by retain heights.

Reference: state/pruner.go:17-140 — a service that periodically reads the
application / data-companion / ABCI-results retain heights from the state
store and prunes blocks, state rows and finalize responses up to the
minimum allowed height. Retain heights only ever move up (monotonic,
pruner.go SetApplicationBlockRetainHeight), are bounds-checked against the
block store, and survive restarts (persisted rows, state/store.py).

The application's retain height arrives from FinalizeBlock's
retain_height field via BlockExecutor (state/execution.go:305); the
companion height via the pruning gRPC/RPC surface. When the companion is
disabled (the default) only the application height drives pruning.

The port's copy of cometbft_tpu/state/pruner.py.
"""

from __future__ import annotations

import asyncio

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService

APP_RETAIN = "app_block"
COMPANION_RETAIN = "companion_block"
ABCI_RES_RETAIN = "abci_results"
TX_INDEX_RETAIN = "tx_index"
BLOCK_INDEX_RETAIN = "block_index"

DEFAULT_INTERVAL = 10.0  # config.DefaultPruningInterval


class Pruner(BaseService):
    def __init__(
        self,
        state_store,
        block_store,
        tx_indexer=None,
        block_indexer=None,
        cert_store=None,
        interval: float = DEFAULT_INTERVAL,
        companion_enabled: bool = False,
        logger: cmtlog.Logger | None = None,
        metrics=None,
    ):
        super().__init__("Pruner", logger)
        self.state_store = state_store
        self.block_store = block_store
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.cert_store = cert_store
        self.interval = interval
        self.companion_enabled = companion_enabled
        self.metrics = metrics
        self._task: asyncio.Task | None = None
        self._kick = asyncio.Event()
        self.blocks_pruned = 0
        self.abci_responses_pruned = 0
        self.certs_pruned = 0

    # ------------------------------------------------------ retain heights

    def _set_retain(self, which: str, height: int) -> None:
        """Monotonic, bounds-checked set (pruner.go:139-199)."""
        base = self.block_store.base()
        top = self.block_store.height()
        if height < base or height > top + 1:
            raise ValueError(
                f"retain height {height} out of bounds [{base}, {top + 1}]")
        cur = self.state_store.load_retain_height(which)
        if height < cur:
            raise ValueError(
                f"cannot lower {which} retain height {cur} -> {height}")
        self.state_store.save_retain_height(which, height)
        self._kick.set()

    def set_application_block_retain_height(self, height: int) -> None:
        self._set_retain(APP_RETAIN, height)

    def set_companion_block_retain_height(self, height: int) -> None:
        self._set_retain(COMPANION_RETAIN, height)

    def set_abci_res_retain_height(self, height: int) -> None:
        self._set_retain(ABCI_RES_RETAIN, height)

    def set_tx_indexer_retain_height(self, height: int) -> None:
        self._set_retain(TX_INDEX_RETAIN, height)

    def set_block_indexer_retain_height(self, height: int) -> None:
        self._set_retain(BLOCK_INDEX_RETAIN, height)

    def get_block_retain_height(self) -> int:
        return self._effective_block_retain()

    def get_abci_res_retain_height(self) -> int:
        return self.state_store.load_retain_height(ABCI_RES_RETAIN)

    def get_tx_indexer_retain_height(self) -> int:
        return self.state_store.load_retain_height(TX_INDEX_RETAIN)

    def get_block_indexer_retain_height(self) -> int:
        return self.state_store.load_retain_height(BLOCK_INDEX_RETAIN)

    def _effective_block_retain(self) -> int:
        """min(app, companion) when the companion is enabled; the app's
        height alone otherwise (pruner.go findMinRetainHeight shape)."""
        app = self.state_store.load_retain_height(APP_RETAIN)
        if not self.companion_enabled:
            return app
        comp = self.state_store.load_retain_height(COMPANION_RETAIN)
        if app == 0 or comp == 0:
            return 0  # one side has not spoken yet: prune nothing
        return min(app, comp)

    # ------------------------------------------------------------ service

    async def on_start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="pruner")

    async def on_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            try:
                self.prune_once()
            except Exception as e:  # noqa: BLE001 - pruning must not kill the node
                self.logger.error("pruning pass failed", err=str(e))
            self._kick.clear()
            try:
                await asyncio.wait_for(self._kick.wait(), self.interval)
            except asyncio.TimeoutError:
                pass

    def prune_once(self) -> tuple[int, int]:
        """One synchronous pruning pass; returns (blocks, responses)
        pruned. Exposed for tests and the inspect surface."""
        blocks = responses = 0
        retain = self._effective_block_retain()
        if retain > self.block_store.base():
            blocks = self.block_store.prune_blocks(retain)
            self.state_store.prune_states(retain)
            if blocks:
                self.logger.info("pruned blocks", to_height=retain, n=blocks)
        # commit certificates follow the BLOCK retain height exactly (a
        # cert without its block is undecodable context; a block without
        # its cert just re-certifies) — and, like the index rows below,
        # prune independently of whether block pruning fired this pass,
        # so a crash between block- and cert-pruning converges on the
        # next pass after restart instead of orphaning rows
        if self.cert_store is not None and retain > 0:
            try:
                self.certs_pruned += self.cert_store.prune(retain)
            except Exception as e:  # noqa: BLE001 - cert loss is re-derivable
                self.logger.error("cert pruning failed", err=str(e))
        # index rows follow their own retain heights when the pruning
        # service set them, else the block retain height — and prune
        # INDEPENDENTLY of whether block pruning fired this pass
        tx_retain = self.get_tx_indexer_retain_height() or retain
        bl_retain = self.get_block_indexer_retain_height() or retain
        if self.tx_indexer is not None and tx_retain > 0:
            self.tx_indexer.prune(tx_retain)
        if self.block_indexer is not None and bl_retain > 0:
            self.block_indexer.prune(bl_retain)
        res_retain = self.state_store.load_retain_height(ABCI_RES_RETAIN)
        if res_retain == 0 and not self.companion_enabled:
            # no companion and no explicit ABCI-results height: follow the
            # block retain height so finalize responses cannot grow
            # unboundedly (framework policy; the reference leaves results
            # pruning entirely to the pruning-service API)
            res_retain = retain
        if res_retain > 0:
            responses = self.state_store.prune_abci_responses(res_retain)
        self.blocks_pruned += blocks
        self.abci_responses_pruned += responses
        return blocks, responses
