"""BlockExecutor — drives ABCI through the block lifecycle.

Reference: state/execution.go. Four verbs:
  create_proposal_block  (execution.go:109)  reap mempool -> PrepareProposal
  process_proposal       (execution.go:169)  app accept/reject
  apply_block            (execution.go:211)  FinalizeBlock -> update state
                                             -> Commit -> mempool update
  validate_block         (state/validation.go) header/commit checks incl.
                         verify_commit over the batch boundary

The port's copy of cometbft_tpu/state/execution.py. validate_block's
LastCommit check goes through the port's verify_commit (on the card on the
"gpu" backend). The node gives it the event bus (types/event_bus) and the
pruner (state/pruner).
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import Client
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.libs import fail
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.mempool.mempool import CListMempool
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.basic import BlockID, BlockIDFlag
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.commit import Commit, ExtendedCommit
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet, pub_key_from_proto
from cometbft_tpu_torch.utils import cmttime


class ErrInvalidBlock(Exception):
    pass


class ErrProposalRejected(Exception):
    pass


class ErrVoteExtensionRejected(Exception):
    pass


def _abci_commit_info(block: Block, last_val_set: ValidatorSet | None) -> abci.CommitInfo:
    """Build CommitInfo from the block's LastCommit
    (state/execution.go buildLastCommitInfo)."""
    if block.header.height == 1 or block.last_commit is None or last_val_set is None:
        return abci.CommitInfo(round_=0)
    votes = []
    for i, cs in enumerate(block.last_commit.signatures):
        val = last_val_set.validators[i]
        votes.append(
            abci.VoteInfo(
                validator_address=val.address,
                validator_power=val.voting_power,
                block_id_flag=int(cs.block_id_flag),
            )
        )
    return abci.CommitInfo(round_=block.last_commit.round_, votes=votes)


def _extended_commit_info(ec: ExtendedCommit | None, val_set: ValidatorSet | None) -> abci.ExtendedCommitInfo:
    if ec is None or val_set is None:
        return abci.ExtendedCommitInfo(round_=0)
    votes = []
    for i, es in enumerate(ec.extended_signatures):
        val = val_set.validators[i]
        votes.append(
            abci.ExtendedVoteInfo(
                validator_address=val.address,
                validator_power=val.voting_power,
                block_id_flag=int(es.commit_sig.block_id_flag),
                vote_extension=es.extension,
                extension_signature=es.extension_signature,
            )
        )
    return abci.ExtendedCommitInfo(round_=ec.round_, votes=votes)


def _abci_misbehavior(evidence: list) -> list[abci.Misbehavior]:
    out = []
    for ev in evidence:
        for m in ev.abci():
            out.append(
                abci.Misbehavior(
                    type_=m["type"],
                    validator_address=m["validator_address"],
                    validator_power=m["validator_power"],
                    height=m["height"],
                    time=m["time"],
                    total_voting_power=m["total_voting_power"],
                )
            )
    return out


def _validator_updates_to_vals(updates: list[abci.ValidatorUpdate]) -> list[Validator]:
    from cometbft_tpu_torch.utils import protobuf as pb

    out = []
    for u in updates:
        w = pb.Writer()
        field_num = {"ed25519": 1, "secp256k1": 2, "sr25519": 3}[u.pub_key_type]
        w.bytes(field_num, u.pub_key_bytes, always=True)
        pk = pub_key_from_proto(w.output())
        out.append(Validator.new(pk, u.power))
    return out


def results_hash(tx_results: list[abci.ExecTxResult]) -> bytes:
    """LastResultsHash: merkle over deterministic result encodings
    (reference: types/results.go)."""
    return merkle.hash_from_byte_slices([r.hash_bytes() for r in tx_results])


class BlockExecutor:
    def __init__(
        self,
        state_store: StateStore,
        app_conn: Client,  # consensus connection
        mempool: CListMempool,
        evidence_pool=None,
        event_bus=None,
        logger: cmtlog.Logger | None = None,
        pruner=None,
    ):
        self.state_store = state_store
        self.app_conn = app_conn
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.logger = logger or cmtlog.nop()
        self.pruner = pruner  # state.Pruner | None, set by node assembly

    # ------------------------------------------------------------ propose

    async def create_proposal_block(
        self,
        height: int,
        state: State,
        last_extended_commit: ExtendedCommit,
        proposer_addr: bytes,
        block_time: cmttime.Timestamp | None = None,
    ) -> Block:
        """execution.go:109-167."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence = []
        ev_size = 0
        if self.evidence_pool is not None:
            evidence, ev_size = self.evidence_pool.pending_evidence(
                state.consensus_params.evidence.max_bytes
            )
        # max data bytes (types/block.go MaxDataBytes approximation)
        max_data_bytes = (max_bytes if max_bytes > 0 else 22020096) - 2048 - ev_size
        txs = self.mempool.reap_max_bytes_max_gas(max_data_bytes, max_gas)
        commit = last_extended_commit.to_commit()

        req = abci.RequestPrepareProposal(
            max_tx_bytes=max_data_bytes,
            txs=txs,
            local_last_commit=_extended_commit_info(last_extended_commit, state.last_validators),
            misbehavior=_abci_misbehavior(evidence),
            height=height,
            time=block_time or cmttime.now(),
            next_validators_hash=state.next_validators.hash(),
            proposer_address=proposer_addr,
        )
        resp = await self.app_conn.prepare_proposal(req)
        block = state.make_block(
            height, resp.txs, commit, evidence, proposer_addr, block_time=req.time
        )
        return block

    async def process_proposal(self, block: Block, state: State) -> bool:
        """execution.go:169-209."""
        req = abci.RequestProcessProposal(
            txs=block.data.txs,
            proposed_last_commit=_abci_commit_info(block, state.last_validators),
            misbehavior=_abci_misbehavior(block.evidence.evidence),
            hash=block.hash(),
            height=block.header.height,
            time=block.header.time,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
        resp = await self.app_conn.process_proposal(req)
        if resp.status == abci.ProposalStatus.UNKNOWN:
            raise ErrProposalRejected("ProcessProposal responded with status UNKNOWN")
        return resp.is_accepted()

    async def verify_vote_extension(self, vote) -> None:
        """execution.go:349-366 VerifyVoteExtension — consult the app on
        every peer precommit extension. Raises ErrVoteExtensionRejected when
        the app answers anything but ACCEPT (the reference panics on an
        unknown status; a rejected extension just drops the vote)."""
        req = abci.RequestVerifyVoteExtension(
            hash=vote.block_id.hash,
            validator_address=vote.validator_address,
            height=vote.height,
            vote_extension=vote.extension,
        )
        resp = await self.app_conn.verify_vote_extension(req)
        if resp.status != abci.VerifyStatus.ACCEPT:
            raise ErrVoteExtensionRejected(
                f"app rejected vote extension (status={resp.status}) from "
                f"{vote.validator_address.hex()[:12]} at height {vote.height}"
            )

    # ----------------------------------------------------------- validate

    def validate_block(self, state: State, block: Block,
                       last_commit_verified: bool = False) -> None:
        """state/validation.go:15-110 — structural + against-state checks,
        LastCommit verification through the batch boundary.

        last_commit_verified=True skips the signature re-verification: the
        streaming blocksync path has already full-verified this commit on
        the device (types/validation.py stage_verify_commit) — one device
        pass per commit instead of the reference's two
        (blocksync/reactor.go:463 + state/validation.go:92)."""
        block.validate_basic()
        h = block.header
        if h.version.block != 11:
            raise ErrInvalidBlock(f"wrong Block.Header.Version: {h.version.block}")
        if h.chain_id != state.chain_id:
            raise ErrInvalidBlock(f"wrong Block.Header.ChainID: {h.chain_id}")
        expected_height = state.last_block_height + 1 if state.last_block_height else state.initial_height
        if h.height != expected_height:
            raise ErrInvalidBlock(f"wrong Block.Header.Height: want {expected_height}, got {h.height}")
        if h.last_block_id != state.last_block_id:
            raise ErrInvalidBlock("wrong Block.Header.LastBlockID")
        if h.app_hash != state.app_hash:
            raise ErrInvalidBlock("wrong Block.Header.AppHash")
        if h.last_results_hash != state.last_results_hash:
            raise ErrInvalidBlock("wrong Block.Header.LastResultsHash")
        if h.validators_hash != state.validators.hash():
            raise ErrInvalidBlock("wrong Block.Header.ValidatorsHash")
        if h.next_validators_hash != state.next_validators.hash():
            raise ErrInvalidBlock("wrong Block.Header.NextValidatorsHash")
        if h.consensus_hash != state.consensus_params.hash():
            raise ErrInvalidBlock("wrong Block.Header.ConsensusHash")
        if not state.validators.has_address(h.proposer_address):
            raise ErrInvalidBlock("block proposer is not in the validator set")

        if h.height == state.initial_height:
            if block.last_commit is not None and block.last_commit.signatures:
                raise ErrInvalidBlock("initial block can't have LastCommit signatures")
        else:
            if block.last_commit is None:
                raise ErrInvalidBlock("nil LastCommit")
            if len(block.last_commit.signatures) != len(state.last_validators):
                raise ErrInvalidBlock(
                    f"invalid block commit size: {len(block.last_commit.signatures)} vs "
                    f"{len(state.last_validators)} validators"
                )
            if not last_commit_verified:
                # THE hot call: batched signature verification (validation.go:92)
                validation.verify_commit(
                    state.chain_id,
                    state.last_validators,
                    state.last_block_id,
                    h.height - 1,
                    block.last_commit,
                )

        # evidence in the proposed block must verify (validation.go:15 ->
        # evpool.CheckEvidence, state/validation.go end)
        if self.evidence_pool is not None and block.evidence.evidence:
            self.evidence_pool.check_evidence(block.evidence.evidence)

    # -------------------------------------------------------------- apply

    async def apply_block(
        self, state: State, block_id: BlockID, block: Block,
        last_commit_verified: bool = False, validated: bool = False,
    ) -> State:
        """execution.go:211-330 + Commit at 380-419. Returns the new state.
        The mempool is locked across FinalizeBlock->Commit->Update by the
        caller's single-threaded consensus task (asyncio serialization).
        validated=True skips validate_block entirely (the blocksync apply
        loop runs it pre-pop so a bad block can still be redone)."""
        if not validated:
            self.validate_block(state, block, last_commit_verified=last_commit_verified)
        req = abci.RequestFinalizeBlock(
            txs=block.data.txs,
            decided_last_commit=_abci_commit_info(block, state.last_validators),
            misbehavior=_abci_misbehavior(block.evidence.evidence),
            hash=block.hash(),
            height=block.header.height,
            time=block.header.time,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
        resp = await self.app_conn.finalize_block(req)
        if len(resp.tx_results) != len(block.data.txs):
            raise ErrInvalidBlock(
                f"app returned {len(resp.tx_results)} tx results for {len(block.data.txs)} txs"
            )
        self.state_store.save_finalize_block_response(block.header.height, resp)
        fail.fail_point("state.finalize")  # execution.go:251 (legacy index 3)

        new_state = self._update_state(state, block_id, block, resp)
        self.state_store.save(new_state)
        fail.fail_point("state.save")  # execution.go:258 (legacy index 4)

        # Commit: app state persistence + mempool maintenance
        commit_resp = await self.app_conn.commit(abci.RequestCommit())
        # app and node state now agree on the height; only the mempool
        # rebuild and event fan-out remain (recovered by re-check)
        fail.fail_point("app.commit")
        await self.mempool.update(block.header.height, block.data.txs, resp.tx_results)

        if self.evidence_pool is not None:
            self.evidence_pool.update(new_state, block.evidence.evidence)

        if self.event_bus is not None:
            await self._fire_events(block, block_id, resp)

        new_state.retain_height = getattr(commit_resp, "retain_height", 0)
        if self.pruner is not None and new_state.retain_height > 0:
            # execution.go:305: hand the app's retain height to the pruner
            # service; actual deletion happens on its own cadence
            try:
                self.pruner.set_application_block_retain_height(
                    new_state.retain_height)
            except ValueError as e:
                self.logger.error("app retain height rejected", err=str(e))
        return new_state

    def _update_state(
        self, state: State, block_id: BlockID, block: Block, resp: abci.ResponseFinalizeBlock
    ) -> State:
        """execution.go:587-657 updateState."""
        n_val_set = state.next_validators.copy()
        last_height_vals_changed = state.last_height_validators_changed
        if resp.validator_updates:
            n_val_set.update_with_change_set(_validator_updates_to_vals(resp.validator_updates))
            last_height_vals_changed = block.header.height + 1 + 1
        n_val_set.increment_proposer_priority(1)

        params = state.consensus_params
        last_height_params_changed = state.last_height_consensus_params_changed
        if resp.consensus_param_updates is not None:
            params = params.update(resp.consensus_param_updates)
            params.validate_basic()
            last_height_params_changed = block.header.height + 1

        new = State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=block.header.height,
            last_block_id=block_id,
            last_block_time=block.header.time,
            validators=state.next_validators.copy(),
            next_validators=n_val_set,
            last_validators=state.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=results_hash(resp.tx_results),
            app_hash=resp.app_hash,
            app_version=params.version.app,
        )
        return new

    async def _fire_events(self, block: Block, block_id: BlockID, resp) -> None:
        """execution.go:659-720 fireEvents -> event bus."""
        await self.event_bus.publish_event_new_block(block, block_id, resp)
        for i, tx in enumerate(block.data.txs):
            await self.event_bus.publish_event_tx(
                block.header.height, tx, i, resp.tx_results[i]
            )
        if resp.validator_updates:
            await self.event_bus.publish_event_validator_set_updates(resp.validator_updates)
