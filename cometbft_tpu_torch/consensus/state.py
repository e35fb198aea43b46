"""ConsensusState — the Tendermint round state machine.

Reference: consensus/state.go. Structure mirrors the reference's transition
graph exactly (SURVEY.md §3.2):

  enterNewRound -> enterPropose -> [complete proposal] -> enterPrevote
  -> [+2/3 prevotes] -> enterPrecommit (lock/unlock rules)
  -> [+2/3 precommits] -> enterCommit -> finalizeCommit -> next height

Concurrency: ONE asyncio task (`_receive_routine`) consumes a queue of
peer/internal messages and timeout events; every transition happens on that
task, so the round state needs no locks (the reference pins everything to
one goroutine for the same reason, state.go:774). Messages are WAL-logged
before processing; EndHeightMessage is fsynced before ApplyBlock
(state.go:1810), making crash-replay exact.

Vote ingestion: serial add_vote by default; with
config.batch_vote_verification the VoteSet's staged/batched path carries
gossip votes to the card (SURVEY.md §3.3, the north-star hot path).

The port's copy of cometbft_tpu/consensus/state.py. A peer vote is staged
in its VoteSet and verified in one CONSENSUS-class flush through the port's
scheduler (K5, K1/K2, K6 on the card; the BLS kernels for BLS votes); on
the "gpu" backend a flush with no card raises, and the receive routine
stops as a consensus failure. A block part that does not fit the proposal
is logged as CometBFT's handleMsg does (the reference raises it as a
consensus failure; ROADMAP Queue 3). The node's own votes are added serially, as
in the reference. The node gives it the WAL (consensus/wal.py) and the
consensus metrics (libs/metrics.ConsensusMetrics).
"""

from __future__ import annotations

import asyncio
import traceback
from typing import Callable, Optional

from cometbft_tpu_torch.consensus import messages as M
from cometbft_tpu_torch.consensus import timeline
from cometbft_tpu_torch.consensus.config import ConsensusConfig
from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
from cometbft_tpu_torch.consensus.round_state import RoundState, RoundStepType
from cometbft_tpu_torch.consensus.ticker import TimeoutInfo, TimeoutTicker
from cometbft_tpu_torch.consensus.wal import WAL, EndHeightMessage
from cometbft_tpu_torch.libs import fail
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs import trace
from cometbft_tpu_torch.libs.service import BaseService, TaskRunner
from cometbft_tpu_torch.ops import dispatch
from cometbft_tpu_torch.privval.file_pv import PrivValidator
from cometbft_tpu_torch.state import BlockExecutor, State
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.types.basic import BlockID, SignedMsgType
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.commit import Commit, ExtendedCommit, ExtendedCommitSig
from cometbft_tpu_torch.types.part_set import (
    ErrPartSetInvalidProof,
    ErrPartSetUnexpectedIndex,
    PartSet,
)
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import (
    ErrVoteConflictingVotes,
    ErrVoteInvalidSignature,
    VoteSet,
    commit_to_vote_set,
    extended_commit_to_vote_set,
)
from cometbft_tpu_torch.utils import cmttime

BLOCK_PART_SIZE = 65536


def _vote_key(v: Vote) -> tuple:
    """Identity of a staged vote for batched-path peer attribution."""
    return (v.height, v.round_, int(v.type_), v.validator_index,
            v.block_id.key())


class _TaggedQueue:
    """Adapter: the TimeoutTicker puts bare TimeoutInfo; the state queue
    carries (from_peer, msg) pairs."""

    def __init__(self, inner: asyncio.Queue):
        self._inner = inner

    async def put(self, ti) -> None:
        await self._inner.put((False, ti))


class ConsensusState(BaseService):
    def __init__(
        self,
        config: ConsensusConfig,
        state: State,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        wal: WAL | None = None,
        priv_validator: PrivValidator | None = None,
        event_switch=None,
        logger: cmtlog.Logger | None = None,
        metrics=None,
    ):
        super().__init__("ConsensusState", logger)
        self.config = config
        self.metrics = metrics  # libs.metrics.ConsensusMetrics | None
        self.block_exec = block_exec
        self.block_store = block_store
        self.wal = wal
        self.priv_validator = priv_validator
        self.priv_validator_pub_key = (
            priv_validator.get_pub_key() if priv_validator else None
        )
        self.event_switch = event_switch  # libs.events.EventSwitch (reactor fast path)

        self.rs = RoundState()
        self.state: State | None = None
        # set by _contain_failure when the receive routine dies; surfaced
        # through /health and /status (rpc/core.py)
        self.failed = False

        # One multiplexed queue of (from_peer, msg) — the analog of the
        # reference's select over peerMsgQueue/internalMsgQueue/tockChan.
        self.msg_queue: asyncio.Queue = asyncio.Queue(maxsize=5000)
        self.timeout_queue = _TaggedQueue(self.msg_queue)
        self.timeout_ticker = TimeoutTicker(self.timeout_queue)
        self._tasks = TaskRunner("consensus")
        self._wait_sync = False
        self.n_steps = 0  # transition counter (test instrumentation)

        # Outbound tap: called with every self-produced gossipable message
        # (ProposalMessage / BlockPartMessage / VoteMessage). The consensus
        # reactor (and the in-process test net) subscribes here — the state
        # machine itself never touches sockets (SURVEY §1).
        self.outbound_hook: Optional[Callable] = None

        # injectable decision hooks (reference: state.go:122-124, the seam
        # that makes byzantine tests possible)
        self.decide_proposal: Callable = self._default_decide_proposal
        self.do_prevote: Callable = self._default_do_prevote
        self.set_proposal_fn: Callable = self._default_set_proposal

        # misbehavior tap: (peer_id, reason) -> None, wired to
        # Switch.report_misbehavior by the node. A vote with a forged
        # signature is unforgeable proof the SENDER misbehaves (honest
        # peers only relay verified votes), so consensus reports it here
        # instead of silently dropping it.
        self.misbehavior_hook: Optional[Callable] = None
        # batched-path attribution: staged vote -> staging peer, so a
        # FLUSH_INVALID result can still be pinned on its sender
        self._staged_peer: dict[tuple, str] = {}

        # flight-recorder height timeline (libs/trace.py): one begin()-span
        # per consensus height — propose/flush/commit-verify/ABCI-exec
        # spans and step events hang off it, so a slow height keeps its
        # whole tree in the slow capture ring
        self._height_span = None
        self._height_span_h = 0

        # heightline event ring (consensus/timeline.py): per-height
        # critical-path marks + per-peer vote lag. Every hook is gated on
        # the module _enabled flag, so the disabled consensus path pays
        # one call + one bool test. Node boot labels it with the node id
        # and installs the postmortem context collector.
        self.timeline = timeline.Recorder()

        self.sync_to_state(state)

    # ------------------------------------------------------------ lifecycle

    async def on_start(self) -> None:
        if self.wal is not None:
            await self._catchup_replay()
        self._tasks.spawn(self._receive_routine(), name="cs-receive")
        self._schedule_round_0(self.rs)

    async def on_stop(self) -> None:
        self.timeout_ticker.stop()
        await self._tasks.cancel_all()
        if self.wal is not None:
            self.wal.close()

    # ---------------------------------------------------------- state setup

    def update_to_state(self, state: State) -> None:
        """state.go:1842 updateToState: prepare RoundState for the height
        after state.last_block_height."""
        if self.rs.commit_round > -1 and 0 < self.rs.height != state.last_block_height:
            raise RuntimeError(
                f"updateToState expected state height {self.rs.height}, got {state.last_block_height}"
            )
        if (
            self.state is not None
            and self.state.last_block_height > 0
            and state.last_block_height <= self.state.last_block_height
        ):
            # reference state.go updateToState: a non-advancing state (e.g.
            # the post-handshake re-sync on restart) must not reset the
            # RoundState — it would wipe the reconstructed LastCommit.
            self.logger.debug(
                "ignoring update_to_state; state height not greater",
                new=state.last_block_height, old=self.state.last_block_height,
            )
            # still signal the step: peers depend on an up-to-date view
            # (reference updateToState calls newStep() in this branch)
            if self.event_switch is not None:
                self.event_switch.fire("NewRoundStep", self.rs)
            return
        validators = state.validators
        last_precommits: VoteSet | None = None
        if self.rs.commit_round > -1 and self.rs.votes is not None:
            pcs = self.rs.votes.precommits(self.rs.commit_round)
            if pcs is None or not pcs.has_two_thirds_majority():
                raise RuntimeError("updateToState called with no +2/3 precommits")
            last_precommits = pcs

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        self.rs = RoundState(
            height=height,
            round_=0,
            step=RoundStepType.NEW_HEIGHT,
            start_time=cmttime.now().add_seconds(self.config.timeout_commit),
            validators=validators.copy() if validators else None,
            votes=HeightVoteSet(
                state.chain_id, height, validators,
                extensions_enabled=state.consensus_params.abci.vote_extensions_enabled(height),
                batch_flush_size=self.config.vote_batch_flush_size,
            ),
            last_commit=last_precommits,
            last_validators=state.last_validators.copy() if state.last_validators else None,
            locked_round=-1,
            valid_round=-1,
            commit_round=-1,
        )
        self.state = state
        self._staged_peer.clear()  # stale attribution dies with the height
        if self.event_switch is not None:
            # announce the height transition (reference updateToState ->
            # newStep -> EventNewRoundStep) so peers learn we moved on
            self.event_switch.fire("NewRoundStep", self.rs)

    def sync_to_state(self, state: State) -> None:
        """Boot-time state sync (NewState / post-handshake): update the
        RoundState and, if the resulting height needs a LastCommit the
        RoundState doesn't carry, reconstruct it from the block store.
        The single entry point for constructor, node handshake, and the
        blocksync handoff."""
        self.update_to_state(state)
        if self.rs.last_commit is None and self.state.last_block_height > 0:
            self._reconstruct_last_commit(self.state)

    def _reconstruct_last_commit(self, state: State) -> None:
        """state.go reconstructLastCommit: on restart, rebuild the LastCommit
        precommit VoteSet from the block store's seen (extended) commit so the
        proposer can build height last_block_height+1."""
        h = state.last_block_height
        ext_enabled = state.consensus_params.abci.vote_extensions_enabled(h)
        if ext_enabled:
            ec = self.block_store.load_block_extended_commit(h)
            if ec is None:
                raise RuntimeError(
                    f"failed to reconstruct last extended commit; commit for height {h} not found"
                )
            votes = extended_commit_to_vote_set(state.chain_id, ec, state.last_validators)
        else:
            sc = self.block_store.load_seen_commit(h)
            if sc is None:
                raise RuntimeError(
                    f"failed to reconstruct last commit; seen commit for height {h} not found"
                )
            votes = commit_to_vote_set(state.chain_id, sc, state.last_validators)
        if not votes.has_two_thirds_majority():
            raise RuntimeError("failed to reconstruct last commit; does not have +2/3 maj")
        self.rs.last_commit = votes

    def _schedule_round_0(self, rs: RoundState) -> None:
        sleep = max(0.0, (rs.start_time.unix_ns() - cmttime.now().unix_ns()) / 1e9)
        self.timeout_ticker.schedule_timeout(
            TimeoutInfo(sleep, rs.height, 0, RoundStepType.NEW_HEIGHT)
        )

    def _schedule_timeout(self, duration: float, height: int, round_: int, step: RoundStepType) -> None:
        self.timeout_ticker.schedule_timeout(TimeoutInfo(duration, height, round_, step))

    # --------------------------------------------------------- public input

    async def add_vote_from_peer(self, vote: Vote, peer_id: str) -> None:
        if timeline.enabled() and vote.height == self.rs.height:
            # arrival lag against the vote's signing timestamp; recorded at
            # enqueue so queue depth doesn't read as network lag
            self.timeline.vote_arrival(
                vote.height, vote.round_, int(vote.type_), peer_id,
                vote.timestamp.unix_ns())
        await self.msg_queue.put((True, M.VoteMessage(vote=vote, peer_id=peer_id)))

    async def add_proposal_from_peer(self, proposal: Proposal, peer_id: str) -> None:
        await self.msg_queue.put((True, M.ProposalMessage(proposal=proposal, peer_id=peer_id)))

    async def add_block_part_from_peer(self, height: int, round_: int, part, peer_id: str) -> None:
        await self.msg_queue.put(
            (True, M.BlockPartMessage(height=height, round_=round_, part=part, peer_id=peer_id))
        )

    # --------------------------------------------------------- receive loop

    def _gossip(self, msg) -> None:
        if self.outbound_hook is None:
            return
        try:
            self.outbound_hook(msg)
        except Exception as e:  # noqa: BLE001 - gossip must not kill consensus
            self.logger.error("outbound hook failed", err=str(e))

    async def _receive_routine(self) -> None:
        """state.go:774-862: the single serialization point."""
        while True:
            try:
                from_peer, msg = await self.msg_queue.get()
                if isinstance(msg, TimeoutInfo):
                    if self.wal is not None:
                        self.wal.write(msg)
                    await self._handle_timeout(msg)
                else:
                    if self.wal is not None:
                        if from_peer:
                            # a failed peer-message WAL write is logged,
                            # not fatal (reference state.go:822): the
                            # message is DROPPED un-WALed — as if never
                            # received — and gossip redelivers; a full or
                            # failing disk degrades, it does not halt
                            try:
                                self.wal.write(msg)
                            except OSError as e:
                                self.logger.error(
                                    "failed writing peer msg to WAL; "
                                    "dropping msg", err=str(e))
                                continue
                        else:
                            # own messages MUST be durable before they
                            # act (state.go:829 fsync): failure here is a
                            # consensus failure, handled by containment
                            self.wal.write_sync(msg)
                    await self._handle_msg(msg)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - CONSENSUS FAILURE (state.go:789)
                self.logger.error(
                    "CONSENSUS FAILURE!!!", err=traceback.format_exc()
                )
                self._contain_failure()
                return

    def _contain_failure(self) -> None:
        """state.go:789-802 containment, made observable: a node whose
        consensus routine died must not keep looking healthy. Flush+fsync
        the WAL (evidence of what was seen survives the crash), mark the
        service failed — /health and /status report it (rpc/core.py) — and
        let operators decide whether to kill the process; the reference
        likewise keeps the process up so the WAL/evidence can be pulled."""
        self.failed = True
        try:
            if self.wal is not None:
                self.wal.flush()
        except Exception as e:  # noqa: BLE001 - best effort on the way down
            self.logger.error("WAL flush on consensus failure", err=str(e))

    async def _handle_msg(self, msg) -> None:
        if isinstance(msg, M.ProposalMessage):
            self._set_proposal(msg.proposal, msg.peer_id)
        elif isinstance(msg, M.BlockPartMessage):
            try:
                await self._add_proposal_block_part(msg)
            except (ErrPartSetInvalidProof, ErrPartSetUnexpectedIndex) as err:
                # state.go handleMsg: a part that does not fit the proposal
                # is the sender's error, logged; from another round (the
                # proposal moved on) it is routine. Never a consensus failure.
                if msg.round_ != self.rs.round_:
                    self.logger.debug("received block part from wrong round",
                                      height=self.rs.height, cs_round=self.rs.round_,
                                      block_round=msg.round_)
                else:
                    self.logger.error("failed to process message", type="BlockPart",
                                      peer=msg.peer_id, err=str(err))
        elif isinstance(msg, M.VoteMessage):
            try:
                await self._try_add_vote(msg.vote, msg.peer_id)
            except ErrVoteConflictingVotes as err:
                # state.go handleMsg: a conflicting vote of our own (a peer
                # echoing an equivocation back, or the WAL replaying one) is
                # the error tryAddVote returns, logged; never a consensus
                # failure
                self.logger.error("failed to process message", type="Vote",
                                  peer=msg.peer_id, err=str(err))
        else:
            self.logger.error("unknown msg type", type=str(type(msg)))

    async def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """state.go:930-980."""
        if self.config.batch_vote_verification:
            await self._flush_all_pending_votes()
        rs = self.rs
        if ti.height != rs.height or ti.round_ < rs.round_ or (
            ti.round_ == rs.round_ and ti.step < rs.step
        ):
            return  # stale
        if ti.step == RoundStepType.NEW_HEIGHT:
            await self._enter_new_round(ti.height, 0)
        elif ti.step == RoundStepType.NEW_ROUND:
            await self._enter_propose(ti.height, 0)
        elif ti.step == RoundStepType.PROPOSE:
            await self._enter_prevote(ti.height, ti.round_)
        elif ti.step == RoundStepType.PREVOTE_WAIT:
            await self._enter_precommit(ti.height, ti.round_)
        elif ti.step == RoundStepType.PRECOMMIT_WAIT:
            await self._enter_precommit(ti.height, ti.round_)
            await self._enter_new_round(ti.height, ti.round_ + 1)
        else:
            self.logger.error("invalid timeout step", step=ti.step.name)

    # ------------------------------------------------------------- rounds

    def _new_step(self, step: RoundStepType) -> None:
        self.rs.step = step
        self.n_steps += 1
        # stamp height/round into every log record this task emits from
        # here on (libs/log.py context — grep-by-height works node-wide)
        cmtlog.set_height_round(self.rs.height, self.rs.round_)
        trace.event(f"consensus.step.{step.name.lower()}", cat="consensus",
                    parent=self._height_span, height=self.rs.height,
                    round=self.rs.round_)
        if self.event_switch is not None:
            self.event_switch.fire("NewRoundStep", self.rs)

    async def _enter_new_round(self, height: int, round_: int) -> None:
        """state.go:1042-1127."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step != RoundStepType.NEW_HEIGHT
        ):
            return
        if trace.enabled() and self._height_span_h != height:
            # new height: roll the timeline span (the previous one closed
            # in _finalize_commit; this also covers replay/catch-up jumps)
            if self._height_span is not None:
                self._height_span.finish()
            # the height budget rides on top of the unavoidable protocol
            # waits (propose window + commit delay): with the bare global
            # slow_ms, every ordinary height would be "slow" and the
            # capture ring would hold nothing but routine heights
            cfg = self.config
            wait_ms = (cfg.timeout_propose + cfg.timeout_commit) * 1e3
            self._height_span = trace.begin(
                "consensus.height", cat="consensus", height=height,
                slow_ms=trace.slow_budget_ms() + wait_ms)
            self._height_span_h = height
        self.timeline.mark(height, timeline.NEW_HEIGHT, round_=round_)
        validators = rs.validators
        if rs.round_ < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round_)
        rs.validators = validators
        rs.round_ = round_
        self._new_step(RoundStepType.NEW_ROUND)
        if round_ != 0:
            # round catchup resets proposal state (state.go:1092-1100)
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_)
        rs.triggered_timeout_precommit = False

        wait_for_txs = (
            self.config.create_empty_blocks_interval > 0
            and not self.config.create_empty_blocks
        )
        if wait_for_txs:
            self._schedule_timeout(
                self.config.create_empty_blocks_interval, height, round_,
                RoundStepType.NEW_ROUND,
            )
        await self._enter_propose(height, round_)

    def _is_proposer(self) -> bool:
        if self.priv_validator_pub_key is None:
            return False
        proposer = self.rs.validators.get_proposer()
        return proposer is not None and proposer.address == self.priv_validator_pub_key.address()

    async def _enter_propose(self, height: int, round_: int) -> None:
        """state.go:1129-1192."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStepType.PROPOSE
        ):
            return
        rs.round_ = round_
        # backstop for vote-driven height entries that skip enter_new_round
        # (first-wins: a no-op when enter_new_round already stamped it)
        self.timeline.mark(height, timeline.NEW_HEIGHT, round_=round_)
        self._new_step(RoundStepType.PROPOSE)
        self._schedule_timeout(
            self.config.propose_timeout(round_), height, round_, RoundStepType.PROPOSE
        )
        if self._is_proposer():
            with trace.span("consensus.propose", cat="consensus",
                            parent=self._height_span, height=height,
                            round=round_):
                await self.decide_proposal(height, round_)
        if self._is_proposal_complete():
            await self._enter_prevote(height, rs.round_)

    async def _default_decide_proposal(self, height: int, round_: int) -> None:
        """state.go:1193-1266."""
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            block = await self._create_proposal_block()
            if block is None:
                return
            block_parts = block.make_part_set(BLOCK_PART_SIZE)
        block_id = BlockID(hash=block.hash(), part_set_header=block_parts.header())
        proposal = Proposal(
            height=height, round_=round_, pol_round=rs.valid_round,
            block_id=block_id, timestamp=cmttime.now(),
        )
        try:
            self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception as e:  # noqa: BLE001
            self.logger.error("propose step; failed signing proposal", err=str(e))
            return
        await self.msg_queue.put((False, M.ProposalMessage(proposal=proposal)))
        self._gossip(M.ProposalMessage(proposal=proposal))
        for i in range(block_parts.total):
            part_msg = M.BlockPartMessage(height=rs.height, round_=rs.round_, part=block_parts.get_part(i))
            await self.msg_queue.put((False, part_msg))
            self._gossip(part_msg)
        self.timeline.mark(height, timeline.PROPOSAL_SENT, round_=round_)
        self.logger.info("signed proposal", height=height, round=round_, proposal=str(proposal.block_id))

    async def _create_proposal_block(self) -> Block | None:
        """state.go:1268-1309."""
        if self.priv_validator_pub_key is None:
            return None
        rs = self.rs
        if rs.height == self.state.initial_height:
            last_ext_commit = ExtendedCommit(
                height=0, round_=0, block_id=BlockID(), extended_signatures=[]
            )
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            last_ext_commit = rs.last_commit.make_extended_commit()
        else:
            self.logger.error("propose step; cannot propose anything without commit for the previous block")
            return None
        return await self.block_exec.create_proposal_block(
            rs.height, self.state, last_ext_commit, self.priv_validator_pub_key.address()
        )

    def _is_proposal_complete(self) -> bool:
        """state.go:1311-1330."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    # ------------------------------------------------------------ proposal

    def _set_proposal(self, proposal: Proposal, peer_id: str = "") -> None:
        self.set_proposal_fn(proposal, peer_id)

    def _default_set_proposal(self, proposal: Proposal, peer_id: str = "") -> None:
        """state.go:1960-1993 defaultSetProposal."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round_ != rs.round_:
            return
        if proposal.pol_round < -1 or (
            proposal.pol_round >= 0 and proposal.pol_round >= proposal.round_
        ):
            raise ValueError("error invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposal.verify(self.state.chain_id, proposer.pub_key):
            raise ValueError("error invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet.from_header(proposal.block_id.part_set_header)
        self.timeline.mark(rs.height, timeline.PROPOSAL_RECEIVED,
                           round_=rs.round_, peer=peer_id)
        self.logger.info("received proposal", proposal=str(proposal.block_id), peer=peer_id)

    async def _add_proposal_block_part(self, msg: M.BlockPartMessage) -> bool:
        """state.go:1994-2073."""
        rs = self.rs
        if msg.height != rs.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(msg.part)
        if not added:
            return False
        self.timeline.mark(msg.height, timeline.FIRST_BLOCK_PART,
                           round_=msg.round_, peer=msg.peer_id)
        if rs.proposal_block_parts.is_complete():
            block = Block.from_proto(rs.proposal_block_parts.get_reader())
            rs.proposal_block = block
            self.timeline.mark(msg.height, timeline.PROPOSAL_COMPLETE,
                               round_=msg.round_)
            self.logger.info("received complete proposal block",
                             height=block.header.height, hash=block.hash().hex()[:12])
            await self._handle_complete_proposal(msg.height)
        return True

    async def _handle_complete_proposal(self, height: int) -> None:
        """state.go:2074-2108."""
        rs = self.rs
        prevotes = rs.votes.prevotes(rs.round_)
        block_id, has_maj = (prevotes.two_thirds_majority() if prevotes else (None, False))
        if has_maj and not block_id.is_nil() and rs.valid_round < rs.round_:
            if rs.proposal_block.hash() == block_id.hash:
                rs.valid_round = rs.round_
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
                if self.event_switch is not None:
                    self.event_switch.fire("ValidBlock", rs)
        if rs.step <= RoundStepType.PROPOSE and self._is_proposal_complete():
            await self._enter_prevote(height, rs.round_)
            if has_maj:
                await self._enter_precommit(height, rs.round_)
        elif rs.step == RoundStepType.COMMIT:
            await self._try_finalize_commit(height)

    # ------------------------------------------------------------- prevote

    async def _enter_prevote(self, height: int, round_: int) -> None:
        """state.go:1311-1336."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStepType.PREVOTE
        ):
            return
        rs.round_ = round_
        self._new_step(RoundStepType.PREVOTE)
        await self.do_prevote(height, round_)

    async def _default_do_prevote(self, height: int, round_: int) -> None:
        """state.go:1337-1410."""
        rs = self.rs
        if rs.locked_block is not None:
            await self._sign_add_vote(SignedMsgType.PREVOTE, rs.locked_block.hash(),
                                      rs.locked_block_parts.header())
            return
        if rs.proposal_block is None:
            await self._sign_add_vote(SignedMsgType.PREVOTE, b"", None)
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
            accepted = await self.block_exec.process_proposal(rs.proposal_block, self.state)
        except dispatch.DEVICE_FAULTS:
            raise  # the card failed: no verdict on the block
        except Exception as e:  # noqa: BLE001
            self.logger.error("prevote step: invalid proposal block", err=str(e))
            accepted = False
        if accepted:
            await self._sign_add_vote(
                SignedMsgType.PREVOTE, rs.proposal_block.hash(),
                rs.proposal_block_parts.header(),
            )
        else:
            await self._sign_add_vote(SignedMsgType.PREVOTE, b"", None)

    async def _enter_prevote_wait(self, height: int, round_: int) -> None:
        """state.go:1478-1510."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStepType.PREVOTE_WAIT
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise RuntimeError("enterPrevoteWait without +2/3 prevotes")
        rs.round_ = round_
        self._new_step(RoundStepType.PREVOTE_WAIT)
        self._schedule_timeout(
            self.config.prevote_timeout(round_), height, round_, RoundStepType.PREVOTE_WAIT
        )

    # ----------------------------------------------------------- precommit

    async def _enter_precommit(self, height: int, round_: int) -> None:
        """state.go:1513-1645 — the locking rules."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStepType.PRECOMMIT
        ):
            return
        rs.round_ = round_
        self._new_step(RoundStepType.PRECOMMIT)
        prevotes = rs.votes.prevotes(round_)
        block_id, has_maj = (prevotes.two_thirds_majority() if prevotes else (None, False))
        if not has_maj:
            # no +2/3 prevotes: precommit nil (no unlock)
            await self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", None)
            return
        # +2/3 nil: unlock and precommit nil
        if block_id.is_nil():
            if rs.locked_block is not None:
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            await self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", None)
            return
        # +2/3 for our locked block: relock
        if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
            rs.locked_round = round_
            await self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash,
                                      block_id.part_set_header)
            return
        # +2/3 for the proposal block: lock it
        if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
            self.block_exec.validate_block(self.state, rs.proposal_block)
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            await self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash,
                                      block_id.part_set_header)
            return
        # +2/3 for a block we don't have: unlock, fetch it, precommit nil
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)
        await self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", None)

    async def _enter_precommit_wait(self, height: int, round_: int) -> None:
        """state.go:1646-1676."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.triggered_timeout_precommit
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise RuntimeError("enterPrecommitWait without +2/3 precommits")
        rs.triggered_timeout_precommit = True
        self._new_step(RoundStepType.PRECOMMIT_WAIT)
        self._schedule_timeout(
            self.config.precommit_timeout(round_), height, round_, RoundStepType.PRECOMMIT_WAIT
        )

    # -------------------------------------------------------------- commit

    async def _enter_commit(self, height: int, commit_round: int) -> None:
        """state.go:1648-1709."""
        rs = self.rs
        if rs.height != height or rs.step >= RoundStepType.COMMIT:
            return
        precommits = rs.votes.precommits(commit_round)
        block_id, has_maj = precommits.two_thirds_majority()
        if not has_maj or block_id.is_nil():
            raise RuntimeError("RunActionCommit expected +2/3 precommits for a block")
        rs.commit_round = commit_round
        rs.commit_time = cmttime.now()
        self._new_step(RoundStepType.COMMIT)
        self.timeline.mark(height, timeline.COMMIT, round_=commit_round)
        if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)
        if self.event_switch is not None:
            # announce the committed block's part-set so lagging peers fetch
            # the right parts (reference EventValidBlock in enterCommit)
            self.event_switch.fire("ValidBlock", rs)
        await self._try_finalize_commit(height)

    async def _try_finalize_commit(self, height: int) -> None:
        """state.go:1711-1737."""
        rs = self.rs
        if rs.height != height:
            raise RuntimeError("tryFinalizeCommit at wrong height")
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, has_maj = precommits.two_thirds_majority()
        if not has_maj or block_id.is_nil():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            return  # waiting for block parts
        await self._finalize_commit(height)

    async def _finalize_commit(self, height: int) -> None:
        """state.go:1739-1852."""
        rs = self.rs
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, _ = precommits.two_thirds_majority()
        with trace.span("consensus.commit_verify", cat="consensus",
                        parent=self._height_span, height=height):
            self.block_exec.validate_block(self.state, block)

        fail.fail_point("blockstore.save")  # state.go:1777 (legacy index 0)
        if self.block_store.height() < block.header.height:
            seen_extended = rs.votes.precommits(rs.commit_round).make_extended_commit()
            if self.state.consensus_params.abci.vote_extensions_enabled(block.header.height):
                self.block_store.save_block_with_extended_commit(block, block_parts, seen_extended)
            else:
                self.block_store.save_block(block, block_parts, seen_extended.to_commit())

        fail.fail_point("wal.endheight")  # state.go:1794 (legacy index 1)
        if self.wal is not None:
            self.wal.write_sync(EndHeightMessage(height))  # state.go:1810 fsync
        # state.go:1817 (legacy index 2) — the committed-but-unapplied
        # crash window: EndHeight is durable, ApplyBlock has not run
        fail.fail_point("abci.apply")

        with trace.span("consensus.abci_exec", cat="consensus",
                        parent=self._height_span, height=height,
                        txs=len(block.data.txs)):
            new_state = await self.block_exec.apply_block(
                self.state, block_id, block)
        if self._height_span is not None and self._height_span_h == height:
            self._height_span.set(
                rounds=rs.commit_round, txs=len(block.data.txs))
            self._height_span.finish()
            self._height_span = None
        self.timeline.mark(height, timeline.APPLY_DONE, round_=rs.commit_round)
        self.timeline.height_done(height)
        self.logger.info(
            "finalized block", height=height, hash=block.hash().hex()[:12],
            txs=len(block.data.txs), app_hash=new_state.app_hash.hex()[:12],
        )
        if self.metrics is not None:
            m = self.metrics
            m.height.set(height)
            m.rounds.set(rs.commit_round)
            m.num_txs.set(len(block.data.txs))
            m.total_txs.inc(len(block.data.txs))
            if block_parts is not None:
                m.block_size.set(sum(
                    len(p.bytes_) for p in block_parts.parts if p is not None))
            if self.state is not None and not self.state.last_block_time.is_zero():
                m.block_interval.observe(
                    (block.header.time.unix_ns() - self.state.last_block_time.unix_ns())
                    / 1e9)
            if rs.validators is not None:
                m.validators.set(len(rs.validators))
                m.validators_power.set(rs.validators.total_voting_power())
        self.update_to_state(new_state)
        self._schedule_round_0(self.rs)

    # --------------------------------------------------------------- votes

    async def _sign_add_vote(self, type_: SignedMsgType, hash_: bytes, psh) -> Optional[Vote]:
        """state.go:2452-2490 signAddVote."""
        rs = self.rs
        if self.priv_validator is None or self.priv_validator_pub_key is None:
            return None
        addr = self.priv_validator_pub_key.address()
        if not rs.validators.has_address(addr):
            return None
        idx, _ = rs.validators.get_by_address(addr)
        vote = Vote(
            type_=type_,
            height=rs.height,
            round_=rs.round_,
            block_id=BlockID(hash=hash_, part_set_header=psh) if hash_ else BlockID(),
            timestamp=cmttime.canonical_now_ms(),
            validator_address=addr,
            validator_index=idx,
        )
        ext_enabled = self.state.consensus_params.abci.vote_extensions_enabled(rs.height)
        if ext_enabled and type_ == SignedMsgType.PRECOMMIT and hash_:
            from cometbft_tpu_torch.abci import types as abci

            resp = await self.block_exec.app_conn.extend_vote(
                abci.RequestExtendVote(hash=hash_, height=rs.height, round_=rs.round_)
            )
            vote.extension = resp.vote_extension
        try:
            self.priv_validator.sign_vote(self.state.chain_id, vote, sign_extension=ext_enabled)
        except Exception as e:  # noqa: BLE001
            self.logger.error("failed signing vote", err=str(e))
            return None
        await self.msg_queue.put((False, M.VoteMessage(vote=vote)))
        self._gossip(M.VoteMessage(vote=vote))
        return vote

    async def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:2110-2159: tolerate expected errors, detect equivocation."""
        try:
            return await self._add_vote(vote, peer_id)
        except ErrVoteConflictingVotes as e:
            if vote.validator_address == (
                self.priv_validator_pub_key.address() if self.priv_validator_pub_key else b""
            ):
                self.logger.error("found conflicting vote from ourselves; did you unsafe_reset a validator?")
                raise
            self._conflicts_to_evidence(getattr(e, "conflicts", None) or [e])
            return False
        except ErrVoteInvalidSignature as e:
            self._report_misbehavior(peer_id, "invalid-vote-signature")
            self.logger.info("rejected vote with invalid signature",
                             err=str(e), peer=peer_id)
            return False
        except dispatch.DEVICE_FAULTS:
            raise  # the card failed, not the vote: a consensus failure
        except Exception as e:  # noqa: BLE001 - bad votes are logged, not fatal
            self.logger.info("failed attempting to add vote", err=str(e))
            return False

    def _report_misbehavior(self, peer_id: str, reason: str) -> None:
        if not peer_id or self.misbehavior_hook is None:
            return
        try:
            self.misbehavior_hook(peer_id, reason)
        except Exception as e:  # noqa: BLE001 - scoring must not kill consensus
            self.logger.error("misbehavior hook failed", err=str(e))

    def _conflicts_to_evidence(self, conflicts) -> None:
        """Equivocations -> the pool's consensus buffer (state.go:2117-2146
        ReportConflictingVotes). The pool materializes DuplicateVoteEvidence
        once the header at the vote height commits, stamping the BLOCK time
        — the timestamp other pools cross-check against. Takes a list so one
        batched flush can report every conflicting pair it found."""
        for e in conflicts:
            if self.block_exec.evidence_pool is not None:
                self.block_exec.evidence_pool.report_conflicting_votes(
                    e.vote_a, e.vote_b
                )
            self.logger.info(
                "found and sent conflicting vote to evidence pool",
                vote=str(e.vote_b),
            )

    async def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:2161-2450."""
        rs = self.rs
        # precommit for previous height (LastCommit catchup, state.go:2176)
        if vote.height + 1 == rs.height and vote.type_ == SignedMsgType.PRECOMMIT:
            if rs.step != RoundStepType.NEW_HEIGHT or rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote)
            if added and self.event_switch is not None:
                self.event_switch.fire("Vote", vote)
            return added
        if vote.height != rs.height:
            return False

        # Extension check on every peer precommit (state.go:2219-2240):
        # the extension signature is verified FIRST so the app only ever
        # sees authenticated payloads (ref vote.VerifyExtension before
        # blockExec.VerifyVoteExtension — a forged vote must not buy an
        # ABCI round-trip), then the app judges the payload. Skipped for
        # our own votes — we produced the extension via ExtendVote.
        if (
            vote.type_ == SignedMsgType.PRECOMMIT
            and not vote.block_id.is_nil()
            and self.state.consensus_params.abci.vote_extensions_enabled(vote.height)
            and vote.validator_address
            != (self.priv_validator_pub_key.address() if self.priv_validator_pub_key else b"")
        ):
            _, val = rs.validators.get_by_index(vote.validator_index)
            if val is None:
                return False
            if not vote.verify_extension(self.state.chain_id, val.pub_key):
                self.logger.info("invalid vote extension signature", vote=str(vote))
                return False
            try:
                await self.block_exec.verify_vote_extension(vote)
            except Exception:
                if self.metrics is not None:
                    self.metrics.vote_extension_received.labels("rejected").inc()
                raise
            if self.metrics is not None:
                self.metrics.vote_extension_received.labels("accepted").inc()

        if self.config.batch_vote_verification and peer_id:
            return await self._add_vote_batched(vote, peer_id)

        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            return False
        if self.event_switch is not None:
            self.event_switch.fire("Vote", vote)

        if vote.type_ == SignedMsgType.PREVOTE:
            await self._on_prevote_added(vote.round_)
        else:
            await self._on_precommit_added(vote.round_)
        if self.config.batch_vote_verification:
            # a serially-added vote (our own) can be the one that pushes the
            # speculative tally over quorum: recheck the staged batch or
            # peer votes staged earlier would never flush (liveness)
            vs = (
                rs.votes.prevotes(vote.round_)
                if vote.type_ == SignedMsgType.PREVOTE
                else rs.votes.precommits(vote.round_)
            )
            if vs is not None and vs.should_flush():
                await self._flush_vote_set(vs)
        return True

    # ---------------------------------------------------- batched vote path

    async def _add_vote_batched(self, vote: Vote, peer_id: str) -> bool:
        """THE hot path, batch-first (SURVEY §3.3): gossip votes are staged
        with cheap structural checks; signatures verify in coalesced device
        batches. Pending votes are invisible to every threshold read (the
        tally only counts verified votes), so 'never count an unverified
        vote' holds by construction; the speculative quorum boundary inside
        should_flush guarantees a staged majority is flushed immediately."""
        rs = self.rs
        staged = rs.votes.add_pending(vote, peer_id)
        if not staged:
            return False
        self._staged_peer[_vote_key(vote)] = peer_id
        vs = (
            rs.votes.prevotes(vote.round_)
            if vote.type_ == SignedMsgType.PREVOTE
            else rs.votes.precommits(vote.round_)
        )
        if vs is not None and vs.should_flush():
            await self._flush_vote_set(vs)
        return True

    async def _flush_vote_set(self, vs: VoteSet) -> None:
        """One device batch for a VoteSet's staged votes; then events +
        threshold hooks for what got added, evidence for equivocations.
        The flush runs consensus-class through the global verify
        scheduler: it drains immediately (never queued behind sync or
        mempool work) and coalesces whatever compatible queued rows fit
        the bucket as filler — the device sees one fuller batch instead
        of a fragment."""
        from cometbft_tpu_torch import sched

        n_pending = len(vs._pending)
        if self.metrics is not None and n_pending > 0:
            self.metrics.batch_flushes.inc()
            self.metrics.batch_lanes.inc(n_pending)
        kind = ("prevote" if vs.signed_msg_type == SignedMsgType.PREVOTE
                else "precommit")
        flush_sp = trace.span(
            f"consensus.{kind}_flush", cat="consensus",
            parent=self._height_span, height=self.rs.height,
            round=vs.round_, rows=n_pending)
        try:
            with flush_sp, sched.work_class(sched.CONSENSUS):
                results = vs.flush_pending()
        except ErrVoteConflictingVotes as e:
            results = getattr(e, "results", [])
            own_addr = (
                self.priv_validator_pub_key.address()
                if self.priv_validator_pub_key
                else b""
            )
            conflicts = getattr(e, "conflicts", None) or [e]
            if any(c.vote_b.validator_address == own_addr for c in conflicts):
                self.logger.error("found conflicting vote from ourselves; did you unsafe_reset a validator?")
                raise
            self._conflicts_to_evidence(conflicts)
        added_any = False
        from cometbft_tpu_torch.types import vote_set as VS

        for v, status in results:
            staging_peer = self._staged_peer.pop(_vote_key(v), "")
            if status == VS.FLUSH_ADDED:
                added_any = True
                if self.event_switch is not None:
                    self.event_switch.fire("Vote", v)
            elif status == VS.FLUSH_INVALID:
                self._report_misbehavior(staging_peer, "invalid-vote-signature")
        if added_any:
            if vs.signed_msg_type == SignedMsgType.PREVOTE:
                await self._on_prevote_added(vs.round_)
            else:
                await self._on_precommit_added(vs.round_)

    async def _flush_all_pending_votes(self) -> None:
        """Flush every staged vote batch for the current height — called
        before timeout-driven threshold decisions so liveness never waits
        on an unflushed batch."""
        if self.rs.votes is None:
            return
        for vs in self.rs.votes.pending_sets():
            await self._flush_vote_set(vs)

    async def _on_prevote_added(self, round_: int) -> None:
        """state.go:2270-2366 (parameterized by round: the batched path
        folds many votes of one round at once)."""
        rs = self.rs
        vote_round = round_
        prevotes = rs.votes.prevotes(vote_round)
        if timeline.enabled() and prevotes is not None:
            # threshold crossings (first-wins marks): rs.height read before
            # any enter_* below can advance it
            self.timeline.mark(rs.height, timeline.PREVOTE_FIRST,
                               round_=vote_round)
            if prevotes.has_one_third_any():
                self.timeline.mark(rs.height, timeline.PREVOTE_THIRD,
                                   round_=vote_round)
            if prevotes.has_two_thirds_any():
                self.timeline.mark(rs.height, timeline.PREVOTE_QUORUM,
                                   round_=vote_round)
        block_id, has_maj = prevotes.two_thirds_majority()
        if has_maj:
            # unlock on POL for a different block (state.go:2290-2305)
            if (
                rs.locked_block is not None
                and rs.locked_round < vote_round <= rs.round_
                and rs.locked_block.hash() != block_id.hash
            ):
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            # update valid block (state.go:2307-2330)
            if not block_id.is_nil() and rs.valid_round < vote_round <= rs.round_:
                if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
                    rs.valid_round = vote_round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                else:
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)

        if rs.round_ < vote_round and prevotes.has_two_thirds_any():
            await self._enter_new_round(rs.height, vote_round)
        elif rs.round_ == vote_round and rs.step >= RoundStepType.PREVOTE:
            if has_maj and (self._is_proposal_complete() or block_id.is_nil()):
                await self._enter_precommit(rs.height, vote_round)
            elif prevotes.has_two_thirds_any():
                await self._enter_prevote_wait(rs.height, vote_round)
        elif rs.proposal is not None and 0 <= rs.proposal.pol_round == vote_round:
            if self._is_proposal_complete():
                await self._enter_prevote(rs.height, rs.round_)

    async def _on_precommit_added(self, round_: int) -> None:
        """state.go:2368-2416 (parameterized by round)."""
        rs = self.rs
        vote_round = round_
        precommits = rs.votes.precommits(vote_round)
        if timeline.enabled() and precommits is not None:
            self.timeline.mark(rs.height, timeline.PRECOMMIT_FIRST,
                               round_=vote_round)
            if precommits.has_two_thirds_any():
                self.timeline.mark(rs.height, timeline.PRECOMMIT_QUORUM,
                                   round_=vote_round)
        block_id, has_maj = precommits.two_thirds_majority()
        if has_maj:
            await self._enter_new_round(rs.height, vote_round)
            await self._enter_precommit(rs.height, vote_round)
            if not block_id.is_nil():
                await self._enter_commit(rs.height, vote_round)
                if self.config.skip_timeout_commit and precommits.has_all():
                    await self._enter_new_round(rs.height, 0)
            else:
                await self._enter_precommit_wait(rs.height, vote_round)
        elif rs.round_ <= vote_round and precommits.has_two_thirds_any():
            await self._enter_new_round(rs.height, vote_round)
            await self._enter_precommit_wait(rs.height, vote_round)

    # -------------------------------------------------------------- replay

    async def _catchup_replay(self) -> None:
        """Replay WAL messages recorded after the last EndHeight
        (consensus/replay.go:94): re-feed them through the handlers with
        WAL writes disabled."""
        # replay.go:99-115: the WAL must NOT already contain EndHeight for
        # the height we are about to run — that means the block committed
        # (crash between the EndHeight fsync and the state-store save) and
        # re-feeding its messages would double-execute it against the app.
        # Recovery for that window is handshake block replay, not WAL
        # replay.
        if self.wal.search_for_end_height(self.rs.height):
            raise RuntimeError(
                f"WAL should not contain EndHeight {self.rs.height}: block "
                "already committed; requires handshake block replay"
            )
        msgs = self.wal.replay_after_height(self.rs.height - 1)
        if not msgs:
            return
        self.logger.info("catchup replay", height=self.rs.height, msgs=len(msgs))
        wal, self.wal = self.wal, None
        try:
            for msg in msgs:
                if isinstance(msg, TimeoutInfo):
                    await self._handle_timeout(msg)
                elif isinstance(msg, EndHeightMessage):
                    continue
                else:
                    await self._handle_msg(msg)
        finally:
            self.wal = wal
