"""Consensus reactor: gossips proposals, block parts, and votes.

Reference: consensus/reactor.go. Four p2p channels (reactor.go:154-192):
  State 0x20        round-step announcements, HasVote, VoteSetMaj23
  Data 0x21         proposals + block parts (+ catchup parts)
  Vote 0x22         votes
  VoteSetBits 0x23  vote-presence bitmap exchange

Per peer, three routines (reactor.go:208-218): gossip_data (parts +
proposal), gossip_votes, query_maj23. Broadcasts ride the consensus
EventSwitch: every step change -> NewRoundStep (reactor.go:421), every
added vote -> HasVote (reactor.go:466).

The state machine itself never touches the network (SURVEY §1): inbound
messages go through cs.add_*_from_peer queues; outbound gossip reads the
shared RoundState + per-peer PeerState.

The port's copy of cometbft_tpu/consensus/reactor.py. Its gossip counters
go to `cs.metrics`, the node's ConsensusMetrics (libs/metrics).
"""

from __future__ import annotations

import asyncio

from cometbft_tpu_torch.consensus import messages as M
from cometbft_tpu_torch.consensus import reactor_codec as codec
from cometbft_tpu_torch.consensus import timeline
from cometbft_tpu_torch.libs import linkmodel
from cometbft_tpu_torch.consensus.peer_state import PeerState
from cometbft_tpu_torch.consensus.round_state import RoundStepType
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.types.basic import SignedMsgType
from cometbft_tpu_torch.utils import cmttime

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23
# compact vote-set reconciliation (framework extension, no reference
# analog): VoteSummary frames ride their OWN channel so support is
# negotiated in the p2p handshake's channel list — a peer that never
# advertises 0x24 simply never receives a summary and gets classic full
# gossip (the mixed-fleet degradation path; an unknown frame would
# otherwise cost the peer its connection)
RECON_CHANNEL = 0x24

PEER_STATE_KEY = "consensus.peer_state"


class _CommitVoteSource:
    """Adapter letting pick_vote_to_send serve votes out of a stored Commit
    (the reference's Commit-implements-VoteSetReader, types/block.go:846)."""

    def __init__(self, commit):
        self.commit = commit
        self.height = commit.height
        self.round_ = commit.round_
        self.signed_msg_type = SignedMsgType.PRECOMMIT

    def size(self) -> int:
        return len(self.commit.signatures)

    def bit_array(self) -> BitArray:
        ba = BitArray(len(self.commit.signatures))
        for i, cs in enumerate(self.commit.signatures):
            ba.set_index(i, bool(cs.signature))
        return ba

    def get_by_index(self, idx: int):
        cs = self.commit.signatures[idx]
        if not cs.signature:
            return None
        return self.commit.get_vote(idx)


class ConsensusReactor(Reactor):
    def __init__(
        self,
        cs: ConsensusState,
        wait_sync: bool = False,
        logger: cmtlog.Logger | None = None,
    ):
        super().__init__("Consensus", logger)
        self.cs = cs
        self.wait_sync = wait_sync
        # keyed by peer OBJECT: a replaced duplicate conn's teardown must
        # not cancel the replacement's routines (same node id)
        self._peer_tasks: dict[object, list[asyncio.Task]] = {}
        self._subscribed = False

    # ------------------------------------------------------------- channels

    def get_channels(self) -> list[ChannelDescriptor]:
        """reactor.go:154-192 (+ the negotiated reconciliation channel)."""
        chans = [
            ChannelDescriptor(id=STATE_CHANNEL, priority=6, send_queue_capacity=64),
            ChannelDescriptor(id=DATA_CHANNEL, priority=10, send_queue_capacity=64,
                              recv_message_capacity=1 << 22),
            ChannelDescriptor(id=VOTE_CHANNEL, priority=7, send_queue_capacity=256),
            ChannelDescriptor(id=VOTE_SET_BITS_CHANNEL, priority=1, send_queue_capacity=8),
        ]
        if getattr(self.cs.config, "gossip_vote_summaries", False):
            # advertising the channel IS the capability announcement
            chans.append(ChannelDescriptor(
                id=RECON_CHANNEL, priority=2, send_queue_capacity=16))
        return chans

    # ------------------------------------------------------------ lifecycle

    async def on_start(self) -> None:
        self._subscribe_events()
        if not self.wait_sync:
            await self.cs.start()

    async def on_stop(self) -> None:
        for tasks in self._peer_tasks.values():
            for t in tasks:
                t.cancel()
        self._peer_tasks.clear()
        if self.cs.is_running:
            await self.cs.stop()

    async def switch_to_consensus(self, state) -> None:
        """blocksync -> consensus handoff (reactor.go:115 SwitchToConsensus).
        sync_to_state also reconstructs LastCommit so this node can propose
        (reference calls reconstructLastCommit here)."""
        self.cs.sync_to_state(state)
        self.wait_sync = False
        await self.cs.start()

    def _subscribe_events(self) -> None:
        """reactor.go:390 subscribeToBroadcastEvents."""
        if self._subscribed or self.cs.event_switch is None:
            return
        self._subscribed = True
        es = self.cs.event_switch
        es.add_listener("cons-reactor", "NewRoundStep",
                        lambda rs: self._broadcast_new_round_step(rs))
        es.add_listener("cons-reactor", "Vote",
                        lambda vote: self._broadcast_has_vote(vote))
        es.add_listener("cons-reactor", "ValidBlock",
                        lambda rs: self._broadcast_new_valid_block(rs))

    # ----------------------------------------------------------- broadcasts

    def _broadcast(self, chan_id: int, msg_bytes: bytes) -> None:
        if self.switch is not None:
            self.switch.broadcast(chan_id, msg_bytes)

    def _new_round_step_msg(self, rs) -> M.NewRoundStepMessage:
        elapsed = max(0, (cmttime.now().unix_ns() - rs.start_time.unix_ns()) // 10**9)
        return M.NewRoundStepMessage(
            height=rs.height,
            round_=rs.round_,
            step=int(rs.step),
            seconds_since_start_time=int(elapsed),
            last_commit_round=rs.last_commit.round_ if rs.last_commit is not None else -1,
        )

    def _broadcast_new_round_step(self, rs) -> None:
        """reactor.go:421 broadcastNewRoundStepMessage."""
        self._broadcast(STATE_CHANNEL, codec.encode(self._new_round_step_msg(rs)))

    def _broadcast_new_valid_block(self, rs) -> None:
        """reactor.go:434."""
        if rs.proposal_block_parts is None:
            return
        msg = M.NewValidBlockMessage(
            height=rs.height,
            round_=rs.round_,
            block_part_set_header=rs.proposal_block_parts.header(),
            block_parts=rs.proposal_block_parts.bit_array(),
            is_commit=rs.step == RoundStepType.COMMIT,
        )
        self._broadcast(STATE_CHANNEL, codec.encode(msg))

    def _broadcast_has_vote(self, vote) -> None:
        """reactor.go:466."""
        msg = M.HasVoteMessage(
            height=vote.height, round_=vote.round_, type_=vote.type_,
            index=vote.validator_index,
        )
        self._broadcast(STATE_CHANNEL, codec.encode(msg))

    # ------------------------------------------------------- peer lifecycle

    def init_peer(self, peer) -> None:
        peer.set(PEER_STATE_KEY, PeerState(peer.id))

    async def add_peer(self, peer) -> None:
        """reactor.go:208-230: start gossip routines + announce our step."""
        ps: PeerState = peer.get(PEER_STATE_KEY)
        loop = asyncio.get_running_loop()
        tasks = [
            loop.create_task(self._gossip_data_routine(peer, ps)),
            loop.create_task(self._gossip_votes_routine(peer, ps)),
            loop.create_task(self._query_maj23_routine(peer, ps)),
        ]
        if getattr(self.cs.config, "gossip_vote_summaries", False):
            tasks.append(
                loop.create_task(self._gossip_summary_routine(peer, ps)))
        self._peer_tasks[peer] = tasks
        if not self.wait_sync:
            peer.try_send(
                STATE_CHANNEL, codec.encode(self._new_round_step_msg(self.cs.rs))
            )

    async def remove_peer(self, peer, reason) -> None:
        for t in self._peer_tasks.pop(peer, []):
            t.cancel()

    # --------------------------------------------------------------- receive

    async def receive(self, e: Envelope) -> None:
        """reactor.go:241-385."""
        peer = e.src
        ps: PeerState = peer.get(PEER_STATE_KEY)
        if ps is None:
            return
        if e.channel_id == RECON_CHANNEL:
            # the reconciliation channel is advisory: any malformed frame
            # (codec mismatch, truncation, checksum failure) is COUNTED
            # and ignored — full gossip continues untouched, never a
            # liveness loss and never a banned peer
            self._receive_vote_summary(e.message, ps)
            return
        msg = codec.decode(e.message)
        rs = self.cs.rs

        if e.channel_id == STATE_CHANNEL:
            if isinstance(msg, M.NewRoundStepMessage):
                if msg.height < self.cs.state.initial_height:
                    raise ValueError("peer claims height below initial height")
                ps.apply_new_round_step(msg)
            elif isinstance(msg, M.NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, M.HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, M.VoteSetMaj23Message):
                await self._handle_vote_set_maj23(peer, ps, msg)
            else:
                raise ValueError(f"unexpected message on state channel: {type(msg)}")

        elif e.channel_id == DATA_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, M.ProposalMessage):
                ps.set_has_proposal(msg.proposal)
                await self.cs.add_proposal_from_peer(msg.proposal, peer.id)
            elif isinstance(msg, M.ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, M.BlockPartMessage):
                ps.set_has_proposal_block_part(msg.height, msg.round_, msg.part.index)
                await self.cs.add_block_part_from_peer(
                    msg.height, msg.round_, msg.part, peer.id
                )
            else:
                raise ValueError(f"unexpected message on data channel: {type(msg)}")

        elif e.channel_id == VOTE_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, M.VoteMessage):
                height = rs.height
                valsize = len(rs.validators) if rs.validators else 0
                last_size = rs.last_commit.size() if rs.last_commit is not None else 0
                ps.ensure_vote_bit_arrays(height, valsize)
                ps.ensure_vote_bit_arrays(height - 1, last_size)
                self._account_vote_received(ps, rs, msg.vote)
                if timeline.enabled() and msg.vote.height == rs.height:
                    # vote-timestamp delta cross-check for the skew model:
                    # only current-height votes (a gossiped old vote's age
                    # would read as clock offset)
                    linkmodel.skew().observe_vote(
                        peer.id, msg.vote.timestamp.unix_ns(),
                        cmttime.now().unix_ns(),
                        getattr(peer.mconn, "_ping_rtt_s", 0.0))
                ps.set_has_vote(
                    msg.vote.height, msg.vote.round_, msg.vote.type_,
                    msg.vote.validator_index,
                )
                await self.cs.add_vote_from_peer(msg.vote, peer.id)
            else:
                raise ValueError(f"unexpected message on vote channel: {type(msg)}")

        elif e.channel_id == VOTE_SET_BITS_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, M.VoteSetBitsMessage):
                our_votes = None
                if rs.height == msg.height and rs.votes is not None:
                    vs = (
                        rs.votes.prevotes(msg.round_)
                        if msg.type_ == SignedMsgType.PREVOTE
                        else rs.votes.precommits(msg.round_)
                    )
                    if vs is not None:
                        our_votes = vs.bit_array_by_block_id(msg.block_id)
                ps.apply_vote_set_bits(msg, our_votes)
            else:
                raise ValueError(f"unexpected message on vote-set-bits channel: {type(msg)}")

    # ------------------------------------------------- gossip accounting

    def _gossip_metric(self, name: str, *labels) -> None:
        m = getattr(self.cs, "metrics", None)
        if m is None:
            return
        counter = getattr(m, name, None)
        if counter is None:
            return
        if labels:
            counter.labels(*labels).inc()
        else:
            counter.inc()

    def _account_vote_received(self, ps: PeerState, rs, vote) -> None:
        """Receiver-side gossip accounting: did we NEED this vote?
        needed = it can still advance our view; already_had = the
        matching vote set already holds this validator's vote (the peer
        wasted a send); stale = for a height we committed past. The
        ratio of received to needed IS the vote-amplification number the
        fleet metrics grade."""
        status = "needed"
        if vote.height == rs.height:
            vs = None
            if rs.votes is not None:
                vs = (rs.votes.prevotes(vote.round_)
                      if vote.type_ == SignedMsgType.PREVOTE
                      else rs.votes.precommits(vote.round_))
            # get_by_index, not bit_array(): the latter copies the whole
            # array per received vote on the hottest p2p path. Bounds
            # guarded here — a malformed index is add_vote's problem to
            # reject, not classification's to crash on (raw list
            # indexing would wrap negatives and raise past the end)
            idx = vote.validator_index
            if (vs is not None and 0 <= idx < vs.size()
                    and vs.get_by_index(idx) is not None):
                status = "already_had"
        elif vote.height == rs.height - 1:
            lc = rs.last_commit
            idx = vote.validator_index
            if (lc is not None and vote.type_ == SignedMsgType.PRECOMMIT
                    and vote.round_ == lc.round_ and 0 <= idx < lc.size()
                    and lc.get_by_index(idx) is not None):
                status = "already_had"
        elif vote.height < rs.height - 1:
            status = "stale"
        g = ps.gossip
        g["votes_recv"] += 1
        g[f"votes_recv_{status}"] += 1
        self._gossip_metric("gossip_votes_received", status)

    def gossip_accounting(self) -> dict:
        """The vote-amplification rollup net_telemetry serves: per-peer
        sent/received/needed splits (bounded by live peers) plus totals
        and the headline `votes_per_vote_needed` ratio — received votes
        per vote that actually advanced this node's view (1.0 = perfect
        reconciliation; the gap above 1.0 is pure amplification)."""
        per_peer: dict[str, dict] = {}
        totals = {"votes_sent": 0, "votes_recv": 0, "votes_recv_needed": 0,
                  "votes_recv_already_had": 0, "votes_recv_stale": 0,
                  "summaries_sent": 0, "summaries_applied": 0,
                  "summaries_degraded": 0}
        sw = self.switch
        peers = list(sw.peers.values()) if sw is not None else []
        for peer in peers:
            ps = peer.get(PEER_STATE_KEY)
            if ps is None:
                continue
            row = dict(ps.gossip)
            row["summary_unsupported"] = ps.summary_unsupported
            per_peer[peer.id[:10]] = row
            for k in totals:
                totals[k] += ps.gossip.get(k, 0)
        needed = totals["votes_recv_needed"]
        return {
            "per_peer": per_peer,
            "totals": totals,
            "votes_per_vote_needed": (
                round(totals["votes_recv"] / needed, 3) if needed else None),
        }

    # ------------------------------------------- vote-set reconciliation

    def _receive_vote_summary(self, raw: bytes, ps: PeerState) -> None:
        """Apply one reconciliation frame with the full degradation
        ladder: codec error -> degraded_codec, wrong message type ->
        degraded_codec, checksum mismatch -> degraded_checksum, bit-size
        disagreement -> degraded_shape; stale summaries are ignored
        silently. Degradation NEVER raises — the worst outcome of a bad
        summary is the full gossip we already run."""
        try:
            msg = codec.decode(raw)
        except Exception:  # noqa: BLE001 - corrupt frame, count and drop
            ps.gossip["summaries_degraded"] += 1
            self._gossip_metric("gossip_summaries", "degraded_codec")
            return
        if not isinstance(msg, M.VoteSummaryMessage):
            ps.gossip["summaries_degraded"] += 1
            self._gossip_metric("gossip_summaries", "degraded_codec")
            return
        want = codec.vote_summary_checksum(
            msg.height, msg.round_, msg.prevotes, msg.precommits)
        if msg.checksum != want:
            ps.gossip["summaries_degraded"] += 1
            self._gossip_metric("gossip_summaries", "degraded_checksum")
            return
        # when the summary is for OUR height we know the validator count
        # and pin the bitmap size to it (crc32 is integrity, not
        # authentication — a forged size must not install); for other
        # heights the peer's existing arrays gate the shape
        rs = self.cs.rs
        expected = (len(rs.validators)
                    if msg.height == rs.height and rs.validators else None)
        verdict = ps.apply_vote_summary(msg, expected_size=expected)
        if verdict == "applied":
            self._gossip_metric("gossip_summaries", "applied")
        elif verdict == "shape":
            ps.gossip["summaries_degraded"] += 1
            self._gossip_metric("gossip_summaries", "degraded_shape")

    async def _gossip_summary_routine(self, peer, ps: PeerState) -> None:
        """Periodically push one VoteSummary frame at the peer: both vote
        bitmaps for our current (height, round). Skips resends while the
        view is unchanged. A peer that never advertised RECON_CHANNEL is
        detected once and the routine exits — that peer runs on classic
        full gossip (the mixed-fleet path)."""
        interval = getattr(self.cs.config, "vote_summary_interval", 0.5)
        if RECON_CHANNEL not in (peer.node_info.channels or b""):
            ps.summary_unsupported = True
            self._gossip_metric("gossip_summaries", "peer_unsupported")
            return
        try:
            while peer.is_running:
                # send-first, THEN sleep: a freshly (re)connected peer —
                # a churn storm makes many — learns our whole vote view
                # in its first gossip exchange instead of re-sending us
                # ~2 vote sets during the first interval
                if self.wait_sync:
                    await asyncio.sleep(interval)
                    continue
                rs = self.cs.rs
                if rs.votes is None:
                    await asyncio.sleep(interval)
                    continue
                pv = rs.votes.prevotes(rs.round_)
                pc = rs.votes.precommits(rs.round_)
                if pv is None and pc is None:
                    await asyncio.sleep(interval)
                    continue
                pv_bits = pv.bit_array() if pv is not None else None
                pc_bits = pc.bit_array() if pc is not None else None
                sig = (rs.height, rs.round_,
                       pv_bits.to_bytes() if pv_bits is not None else b"",
                       pc_bits.to_bytes() if pc_bits is not None else b"")
                if sig != ps.last_summary_sent:
                    msg = M.VoteSummaryMessage(
                        height=rs.height, round_=rs.round_,
                        prevotes=pv_bits, precommits=pc_bits,
                        checksum=codec.vote_summary_checksum(
                            rs.height, rs.round_, pv_bits, pc_bits),
                    )
                    if peer.try_send(RECON_CHANNEL, codec.encode(msg)):
                        ps.last_summary_sent = sig
                        ps.gossip["summaries_sent"] += 1
                        self._gossip_metric("gossip_summaries", "sent")
                await asyncio.sleep(interval)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - reconciliation is advisory
            self.logger.error("gossip_summary routine failed",
                              peer=peer.id[:10], err=str(e))

    async def _handle_vote_set_maj23(self, peer, ps: PeerState, msg: M.VoteSetMaj23Message) -> None:
        """reactor.go:316-361: record the peer's +2/3 claim, answer with our
        vote bits for that BlockID."""
        rs = self.cs.rs
        if rs.height != msg.height or rs.votes is None:
            return
        vs = (
            rs.votes.prevotes(msg.round_)
            if msg.type_ == SignedMsgType.PREVOTE
            else rs.votes.precommits(msg.round_)
        )
        if vs is None:
            return
        vs.set_peer_maj23(peer.id, msg.block_id)
        our_votes = vs.bit_array_by_block_id(msg.block_id)
        resp = M.VoteSetBitsMessage(
            height=msg.height, round_=msg.round_, type_=msg.type_,
            block_id=msg.block_id, votes=our_votes,
        )
        peer.try_send(VOTE_SET_BITS_CHANNEL, codec.encode(resp))

    # ------------------------------------------------------- gossip routines

    async def _gossip_data_routine(self, peer, ps: PeerState) -> None:
        """reactor.go:569-650."""
        sleep = self.cs.config.peer_gossip_sleep_duration
        try:
            while peer.is_running:
                if self.wait_sync:
                    await asyncio.sleep(sleep)
                    continue
                rs = self.cs.rs
                prs = ps.prs

                # 1. send a block part for the current proposal
                if (
                    rs.proposal_block_parts is not None
                    and prs.proposal_block_parts is not None
                    and rs.proposal_block_parts.has_header(prs.proposal_block_part_set_header)
                ):
                    gap = rs.proposal_block_parts.bit_array().sub(prs.proposal_block_parts)
                    index, ok = gap.pick_random()
                    if ok:
                        part = rs.proposal_block_parts.get_part(index)
                        sent = await peer.send(
                            DATA_CHANNEL,
                            codec.encode(M.BlockPartMessage(
                                height=rs.height, round_=rs.round_, part=part)),
                        )
                        if sent:
                            ps.set_has_proposal_block_part(prs.height, prs.round_, index)
                        else:
                            # a stopped mconn fails the send WITHOUT ever
                            # suspending; continuing unthrottled would spin
                            # the (cooperative) event loop and starve every
                            # other task — observed as a whole-node freeze
                            # in the restart-all e2e perturbation
                            await asyncio.sleep(sleep)
                        continue

                # 2. peer is on an older height: serve committed-block parts
                if (
                    prs.height != 0
                    and rs.height != prs.height
                    and self.cs.block_store.base() <= prs.height <= self.cs.block_store.height()
                ):
                    await self._gossip_catchup_part(peer, ps)
                    await asyncio.sleep(sleep)
                    continue

                # 3. different height/round: nothing to send
                if rs.height != prs.height or rs.round_ != prs.round_:
                    await asyncio.sleep(sleep)
                    continue

                # 4. send the proposal (+POL)
                if rs.proposal is not None and not prs.proposal:
                    await peer.send(
                        DATA_CHANNEL, codec.encode(M.ProposalMessage(proposal=rs.proposal))
                    )
                    ps.set_has_proposal(rs.proposal)
                    if 0 <= rs.proposal.pol_round:
                        pol = rs.votes.prevotes(rs.proposal.pol_round)
                        if pol is not None:
                            await peer.send(
                                DATA_CHANNEL,
                                codec.encode(M.ProposalPOLMessage(
                                    height=rs.height,
                                    proposal_pol_round=rs.proposal.pol_round,
                                    proposal_pol=pol.bit_array(),
                                )),
                            )
                    continue
                await asyncio.sleep(sleep)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - gossip must not crash the reactor
            self.logger.error("gossip_data routine failed", peer=peer.id[:10], err=str(e))

    async def _gossip_catchup_part(self, peer, ps: PeerState) -> None:
        """reactor.go:652-735 gossipDataForCatchup."""
        prs = ps.prs
        meta = self.cs.block_store.load_block_meta(prs.height)
        if meta is None:
            return
        # make sure the peer's part-set header matches the stored block
        if prs.proposal_block_parts is None:
            ps.init_proposal_block_parts(meta.block_id.part_set_header)
            return
        if prs.proposal_block_part_set_header != meta.block_id.part_set_header:
            return
        # any part index the peer lacks
        index, ok = prs.proposal_block_parts.not_().pick_random()
        if not ok:
            return
        part = self.cs.block_store.load_block_part(prs.height, index)
        if part is None:
            return
        sent = await peer.send(
            DATA_CHANNEL,
            codec.encode(M.BlockPartMessage(height=prs.height, round_=prs.round_, part=part)),
        )
        if sent:
            ps.set_has_proposal_block_part(prs.height, prs.round_, index)

    async def _gossip_votes_routine(self, peer, ps: PeerState) -> None:
        """reactor.go:737-830."""
        sleep = self.cs.config.peer_gossip_sleep_duration
        try:
            while peer.is_running:
                if self.wait_sync:
                    await asyncio.sleep(sleep)
                    continue
                rs = self.cs.rs
                prs = ps.prs

                if rs.height == prs.height:
                    if await self._gossip_votes_for_height(peer, ps):
                        continue
                # peer one height behind: our last commit has what it needs
                elif prs.height != 0 and rs.height == prs.height + 1 and rs.last_commit is not None:
                    if await self._pick_send_vote(peer, ps, rs.last_commit):
                        continue
                # peer further behind: serve the stored commit at its height
                elif (
                    prs.height != 0
                    and rs.height >= prs.height + 2
                    and self.cs.block_store.base() <= prs.height
                ):
                    commit = self.cs.block_store.load_block_commit(prs.height)
                    if commit is not None and await self._pick_send_vote(
                        peer, ps, _CommitVoteSource(commit)
                    ):
                        continue
                await asyncio.sleep(sleep)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            self.logger.error("gossip_votes routine failed", peer=peer.id[:10], err=str(e))

    async def _gossip_votes_for_height(self, peer, ps: PeerState) -> bool:
        """reactor.go:832-894."""
        rs = self.cs.rs
        prs = ps.prs
        # peer still in NewHeight: needs our last commit
        if prs.step == RoundStepType.NEW_HEIGHT and rs.last_commit is not None:
            if await self._pick_send_vote(peer, ps, rs.last_commit):
                return True
        # peer in Propose, has declared a POL round: send those prevotes
        if (
            prs.step <= RoundStepType.PROPOSE
            and prs.round_ != -1
            and prs.round_ <= rs.round_
            and prs.proposal_pol_round != -1
        ):
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and await self._pick_send_vote(peer, ps, pol):
                return True
        # prevotes for the peer's round
        if prs.step <= RoundStepType.PREVOTE_WAIT and -1 != prs.round_ <= rs.round_:
            vs = rs.votes.prevotes(prs.round_)
            if vs is not None and await self._pick_send_vote(peer, ps, vs):
                return True
        # precommits for the peer's round
        if prs.step <= RoundStepType.PRECOMMIT_WAIT and -1 != prs.round_ <= rs.round_:
            vs = rs.votes.precommits(prs.round_)
            if vs is not None and await self._pick_send_vote(peer, ps, vs):
                return True
        # any round's prevotes the peer can use
        if prs.round_ != -1 and prs.round_ <= rs.round_:
            vs = rs.votes.prevotes(prs.round_)
            if vs is not None and await self._pick_send_vote(peer, ps, vs):
                return True
        if prs.proposal_pol_round != -1:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and await self._pick_send_vote(peer, ps, pol):
                return True
        return False

    async def _pick_send_vote(self, peer, ps: PeerState, votes) -> bool:
        """reactor.go:1171 PickSendVote."""
        vote = ps.pick_vote_to_send(votes)
        if vote is None:
            return False
        sent = await peer.send(VOTE_CHANNEL, codec.encode(M.VoteMessage(vote=vote)))
        if sent:
            ps.set_has_vote(vote.height, vote.round_, vote.type_, vote.validator_index)
            ps.gossip["votes_sent"] += 1
            self._gossip_metric("gossip_votes_sent")
        return sent

    async def _query_maj23_routine(self, peer, ps: PeerState) -> None:
        """reactor.go:896-1000: periodically tell peers about our +2/3
        majorities so they can return any votes we miss."""
        sleep = self.cs.config.peer_query_maj23_sleep_duration
        try:
            while peer.is_running:
                await asyncio.sleep(sleep)
                if self.wait_sync:
                    continue
                rs = self.cs.rs
                prs = ps.prs
                if rs.height != prs.height or rs.votes is None:
                    continue
                for type_, vs in (
                    (SignedMsgType.PREVOTE, rs.votes.prevotes(prs.round_)),
                    (SignedMsgType.PRECOMMIT, rs.votes.precommits(prs.round_)),
                ):
                    if vs is None:
                        continue
                    block_id, ok = vs.two_thirds_majority()
                    if ok:
                        peer.try_send(
                            STATE_CHANNEL,
                            codec.encode(M.VoteSetMaj23Message(
                                height=prs.height, round_=prs.round_,
                                type_=type_, block_id=block_id,
                            )),
                        )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            self.logger.error("query_maj23 routine failed", peer=peer.id[:10], err=str(e))
