"""Consensus heightline: bounded per-height event ring + fleet aggregation.

Every node records monotonic+wall timestamps for the consensus critical
path (proposal sent/received, first block part, proposal complete,
first/1/3/2/3 prevote, 2/3 precommit, commit, ABCI apply done) plus
per-peer vote-arrival lag.  The hooks in consensus/state.py and
consensus/reactor.py follow the span-tracer idiom (libs/trace.py): a
module-global ``_enabled`` bool guards every recording call, so the
disabled cost on the consensus path is one attribute load, one call and
one bool test — asserted <3% of a 1k-row batch verify in tier-1.

Phase anatomy is contiguous by construction: each phase ends exactly
where the next begins (new_height -> proposal_complete -> prevote_quorum
-> precommit_quorum -> commit -> apply_done), so the five durations tile
the height wall time and their sum covers >=95% of it whenever all marks
landed.

``aggregate()`` fuses the rings pulled from N nodes (the
``consensus_timeline`` RPC route) onto one fleet clock axis using the
per-peer skew model (libs/linkmodel.SkewEstimator), attributing proposal
propagation per node, naming the straggler and the slowest vote link.
``chrome_spans()`` renders the fused timeline into span records accepted
by libs/trace.chrome_trace for Perfetto export.

Slow heights (total above ``instrumentation.height_slow_ms``) auto-capture
a bounded postmortem bundle — the local timeline plus whatever the
node-installed collector contributes (span captures, gossip accounting,
wire-counter deltas, scheduler/mesh health) — served by the
``postmortems`` RPC route.

The port's copy of cometbft_tpu/consensus/timeline.py.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

# Critical-path marks, in nominal order.
NEW_HEIGHT = "new_height"
PROPOSAL_SENT = "proposal_sent"
PROPOSAL_RECEIVED = "proposal_received"
FIRST_BLOCK_PART = "first_block_part"
PROPOSAL_COMPLETE = "proposal_complete"
PREVOTE_FIRST = "prevote_first"
PREVOTE_THIRD = "prevote_third"
PREVOTE_QUORUM = "prevote_quorum"
PRECOMMIT_FIRST = "precommit_first"
PRECOMMIT_QUORUM = "precommit_quorum"
COMMIT = "commit"
APPLY_DONE = "apply_done"

MARKS = (
    NEW_HEIGHT, PROPOSAL_SENT, PROPOSAL_RECEIVED, FIRST_BLOCK_PART,
    PROPOSAL_COMPLETE, PREVOTE_FIRST, PREVOTE_THIRD, PREVOTE_QUORUM,
    PRECOMMIT_FIRST, PRECOMMIT_QUORUM, COMMIT, APPLY_DONE,
)

# Contiguous phase edges: (phase, start mark, end mark).
PHASES = ("propose", "prevote", "precommit", "commit", "apply")
_PHASE_EDGES = (
    ("propose", NEW_HEIGHT, PROPOSAL_COMPLETE),
    ("prevote", PROPOSAL_COMPLETE, PREVOTE_QUORUM),
    ("precommit", PREVOTE_QUORUM, PRECOMMIT_QUORUM),
    ("commit", PRECOMMIT_QUORUM, COMMIT),
    ("apply", COMMIT, APPLY_DONE),
)

_DEF_HEIGHTS = 64
_DEF_SLOW_MS = 0.0  # <= 0: slow-height postmortems off
_DEF_POSTMORTEMS = 8
_VOTE_PEER_CAP = 64  # per-height bound on distinct vote-lag peers

_enabled = False
_def_heights = _DEF_HEIGHTS
_def_slow_ms = _DEF_SLOW_MS
_def_postmortems = _DEF_POSTMORTEMS
_clock_mono: Callable[[], int] = time.monotonic_ns
_clock_wall: Callable[[], int] = time.time_ns


def enabled() -> bool:
    return _enabled


def configure(
    enabled: bool | None = None,
    heights: int | None = None,
    slow_ms: float | None = None,
    postmortems: int | None = None,
    clock_mono: Callable[[], int] | None = None,
    clock_wall: Callable[[], int] | None = None,
) -> None:
    """Set the global arm flag and the defaults new Recorders pick up.
    Injectable clocks keep the unit tests deterministic."""
    global _enabled, _def_heights, _def_slow_ms, _def_postmortems
    global _clock_mono, _clock_wall
    if enabled is not None:
        _enabled = bool(enabled)
    if heights is not None:
        _def_heights = max(1, int(heights))
    if slow_ms is not None:
        _def_slow_ms = float(slow_ms)
    if postmortems is not None:
        _def_postmortems = max(1, int(postmortems))
    if clock_mono is not None:
        _clock_mono = clock_mono
    if clock_wall is not None:
        _clock_wall = clock_wall


def reset() -> None:
    global _enabled, _def_heights, _def_slow_ms, _def_postmortems
    global _clock_mono, _clock_wall
    _enabled = False
    _def_heights = _DEF_HEIGHTS
    _def_slow_ms = _DEF_SLOW_MS
    _def_postmortems = _DEF_POSTMORTEMS
    _clock_mono = time.monotonic_ns
    _clock_wall = time.time_ns


# ----------------------------------------------------------- recorder


class Recorder:
    """Bounded per-height event ring for one node.

    Single-writer: every mark comes from the consensus receive task (the
    in-proc harness and the reactor both funnel through it), so the hot
    path takes no lock; snapshot()/postmortem reads copy plain dicts.
    """

    __slots__ = ("node", "heights", "slow_ms", "postmortem_cap",
                 "collector", "_ring", "_by_height", "_postmortems")

    def __init__(self, node: str = "", heights: int | None = None,
                 slow_ms: float | None = None,
                 postmortem_cap: int | None = None):
        self.node = node
        self.heights = int(heights if heights is not None else _def_heights)
        self.slow_ms = float(slow_ms if slow_ms is not None else _def_slow_ms)
        self.postmortem_cap = int(
            postmortem_cap if postmortem_cap is not None else _def_postmortems)
        # collector(height) -> dict of node context for postmortem bundles;
        # installed by node boot, absent in bare-harness runs.
        self.collector: Callable[[int], dict] | None = None
        self._ring: deque[int] = deque()
        self._by_height: dict[int, dict] = {}
        self._postmortems: deque[dict] = deque(maxlen=self.postmortem_cap)

    # -- write side (consensus task) ----------------------------------

    def _rec(self, height: int) -> dict:
        r = self._by_height.get(height)
        if r is None:
            r = {"height": height, "rounds": 0, "events": {}, "votes": {}}
            self._by_height[height] = r
            self._ring.append(height)
            while len(self._ring) > self.heights:
                self._by_height.pop(self._ring.popleft(), None)
        return r

    def mark(self, height: int, name: str, *, round_: int = 0,
             peer: str = "") -> None:
        """First-wins critical-path mark with monotonic+wall stamps."""
        if not _enabled:
            return
        r = self._rec(height)
        if round_ > r["rounds"]:
            r["rounds"] = round_
        ev = r["events"]
        if name in ev:
            return
        ev[name] = {"mono_ns": _clock_mono(), "wall_ns": _clock_wall(),
                    "round": round_, "peer": peer}

    def vote_arrival(self, height: int, round_: int, type_: int, peer: str,
                     vote_wall_ns: int) -> None:
        """Per-peer vote-arrival lag: local arrival wall clock minus the
        vote's signing timestamp (skew-uncorrected; aggregate() corrects
        with the fleet skew model)."""
        if not _enabled:
            return
        votes = self._rec(height)["votes"]
        now_wall = _clock_wall()
        lag = (now_wall - vote_wall_ns) / 1e6
        v = votes.get(peer)
        if v is None:
            if len(votes) >= _VOTE_PEER_CAP:
                return
            votes[peer] = {"n": 1, "lag_ms_sum": lag, "lag_ms_max": lag,
                           "first_wall_ns": now_wall, "last_wall_ns": now_wall}
            return
        v["n"] += 1
        v["lag_ms_sum"] += lag
        if lag > v["lag_ms_max"]:
            v["lag_ms_max"] = lag
        v["last_wall_ns"] = now_wall

    def height_done(self, height: int) -> None:
        """Close out a height; capture a postmortem if it ran slow.  At
        most one bundle per height regardless of how often this fires."""
        if not _enabled:
            return
        r = self._by_height.get(height)
        if r is None:
            return
        ev = r["events"]
        a, b = ev.get(NEW_HEIGHT), ev.get(APPLY_DONE)
        if a is None or b is None:
            return
        total = max(0.0, (b["mono_ns"] - a["mono_ns"]) / 1e6)
        r["total_ms"] = total
        if self.slow_ms > 0 and total > self.slow_ms and not any(
                p["height"] == height for p in self._postmortems):
            self._capture(height, r, total)

    def _capture(self, height: int, r: dict, total: float) -> None:
        bundle = {
            "height": height,
            "node": self.node,
            "total_ms": round(total, 3),
            "slow_ms": self.slow_ms,
            "captured_wall_ns": _clock_wall(),
            "timeline": self._render(r),
        }
        if self.collector is not None:
            # The collector gathers node context (span captures, gossip
            # accounting, wire deltas, scheduler health); it must never
            # take the consensus path down with it.
            try:
                bundle["context"] = self.collector(height)
            except Exception as exc:  # noqa: BLE001
                bundle["context_error"] = repr(exc)
        self._postmortems.append(bundle)

    # -- read side ----------------------------------------------------

    def _render(self, r: dict) -> dict:
        votes = {}
        for peer, v in r["votes"].items():
            votes[peer] = {
                "n": v["n"],
                "lag_ms_mean": round(v["lag_ms_sum"] / v["n"], 3),
                "lag_ms_max": round(v["lag_ms_max"], 3),
                "first_wall_ns": v["first_wall_ns"],
                "last_wall_ns": v["last_wall_ns"],
            }
        out = {
            "height": r["height"],
            "node": self.node,
            "rounds": r["rounds"],
            "events": {k: dict(v) for k, v in r["events"].items()},
            "votes": votes,
            "phases": phases_of(r["events"]),
        }
        if "total_ms" in r:
            out["total_ms"] = round(r["total_ms"], 3)
        return out

    def snapshot(self, min_height: int = 0, limit: int = 0) -> list[dict]:
        """Rendered height records, ascending by height."""
        hs = [h for h in self._ring if h >= min_height]
        if limit > 0:
            hs = hs[-limit:]
        return [self._render(self._by_height[h]) for h in hs
                if h in self._by_height]

    def postmortems(self) -> list[dict]:
        """Bounded list of bundle summaries (newest last)."""
        return [{"height": p["height"], "total_ms": p["total_ms"],
                 "slow_ms": p["slow_ms"],
                 "captured_wall_ns": p["captured_wall_ns"]}
                for p in self._postmortems]

    def postmortem(self, height: int) -> dict | None:
        for p in self._postmortems:
            if p["height"] == height:
                return p
        return None

    def clear(self) -> None:
        self._ring.clear()
        self._by_height.clear()
        self._postmortems.clear()


# ------------------------------------------------------------- phases


def phases_of(events: dict) -> dict:
    """Contiguous phase durations (ms) from one height's event marks;
    a phase whose edge marks are missing is None.  Durations use the
    monotonic stamps, so local clock steps cannot corrupt them."""
    out = {}
    for phase, start, end in _PHASE_EDGES:
        a, b = events.get(start), events.get(end)
        out[phase] = (None if a is None or b is None
                      else round(max(0.0, (b["mono_ns"] - a["mono_ns"]) / 1e6), 3))
    return out


def _quantile(vals: list[float], q: float) -> float | None:
    if not vals:
        return None
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


# ---------------------------------------------------------- aggregate


def _doc_id(doc: dict) -> str:
    return str(doc.get("node_id") or doc.get("moniker") or doc.get("node") or "")


def aggregate(docs: list[dict]) -> dict:
    """Fuse per-node ``consensus_timeline`` documents onto one fleet axis.

    The first doc's clock is the reference axis.  Every other node's wall
    stamps are shifted by the reference node's skew estimate for it
    (offset = peer_clock - ref_clock), falling back to the negated
    reverse estimate, else zero.  Emits per-height phase anatomy with
    per-node proposal-propagation lag, the straggler (slowest node to
    assemble the proposal) and the slowest vote link.
    """
    docs = [d for d in docs if d]
    if not docs:
        return {"ref": "", "offsets_ms": {}, "heights": [], "summary": {}}
    ref = docs[0]
    ref_id = _doc_id(ref)
    ref_skew = ref.get("skew") or {}
    offsets: dict[str, float] = {ref_id: 0.0}
    for d in docs[1:]:
        nid = _doc_id(d)
        ent = ref_skew.get(nid)
        if ent is not None and ent.get("offset_ms") is not None:
            offsets[nid] = float(ent["offset_ms"])
            continue
        back = (d.get("skew") or {}).get(ref_id)
        if back is not None and back.get("offset_ms") is not None:
            offsets[nid] = -float(back["offset_ms"])
        else:
            offsets[nid] = 0.0

    heights: dict[int, dict] = {}
    for d in docs:
        nid = _doc_id(d)
        off_ns = offsets.get(nid, 0.0) * 1e6
        for rec in d.get("heights", []):
            h = int(rec["height"])
            hh = heights.setdefault(h, {})
            events = {}
            for name, ev in (rec.get("events") or {}).items():
                ev = dict(ev)
                ev["fleet_wall_ns"] = ev["wall_ns"] - off_ns
                events[name] = ev
            hh[nid] = {
                "events": events,
                "phases": rec.get("phases") or {},
                "votes": rec.get("votes") or {},
                "total_ms": rec.get("total_ms"),
                "rounds": rec.get("rounds", 0),
            }

    out_heights = []
    prop_all: list[float] = []
    straggler_counts: dict[str, int] = {}
    phase_series: dict[str, list[float]] = {p: [] for p in PHASES}
    for h in sorted(heights):
        nodes = heights[h]
        proposer = None
        t_sent = None
        for nid, n in nodes.items():
            ev = n["events"].get(PROPOSAL_SENT)
            if ev is not None:
                proposer, t_sent = nid, ev["fleet_wall_ns"]
                break
        propagation: dict[str, float] = {}
        if t_sent is not None:
            for nid, n in nodes.items():
                pc = n["events"].get(PROPOSAL_COMPLETE)
                if pc is not None:
                    propagation[nid] = round(
                        max(0.0, (pc["fleet_wall_ns"] - t_sent) / 1e6), 3)
        straggler = max(propagation, key=propagation.get) if propagation else None
        if straggler is not None:
            straggler_counts[straggler] = straggler_counts.get(straggler, 0) + 1
            prop_all.extend(propagation.values())

        fleet_phases = {}
        for phase in PHASES:
            vals = {nid: n["phases"].get(phase) for nid, n in nodes.items()
                    if n["phases"].get(phase) is not None}
            if not vals:
                fleet_phases[phase] = None
                continue
            slowest = max(vals, key=vals.get)
            fleet_phases[phase] = {
                "max_ms": round(vals[slowest], 3),
                "mean_ms": round(sum(vals.values()) / len(vals), 3),
                "slowest": slowest,
            }
            phase_series[phase].append(vals[slowest])

        slowest_link = None
        worst = -1.0
        for nid, n in nodes.items():
            for peer, v in n["votes"].items():
                mean = v.get("lag_ms_mean")
                if mean is None and v.get("n"):
                    mean = v["lag_ms_sum"] / v["n"]
                if mean is None:
                    continue
                # raw lag = arrival (nid's clock) - signing stamp (peer's
                # clock); on the ref axis arrival loses off_nid and the
                # stamp loses off_peer, so the true link lag is
                # lag - off_nid + off_peer
                adj = mean - offsets.get(nid, 0.0) + offsets.get(peer, 0.0)
                if adj > worst:
                    worst = adj
                    slowest_link = {"from": peer, "to": nid,
                                    "lag_ms": round(adj, 3), "votes": v["n"]}

        totals = {nid: n["total_ms"] for nid, n in nodes.items()
                  if n["total_ms"] is not None}
        out_heights.append({
            "height": h,
            "proposer": proposer,
            "proposal_propagation_ms": propagation,
            "straggler": straggler,
            "phases": fleet_phases,
            "slowest_link": slowest_link,
            "total_ms": {nid: round(t, 3) for nid, t in totals.items()},
        })

    phase_mean = {p: (round(sum(v) / len(v), 3) if v else None)
                  for p, v in phase_series.items()}
    known = [v for v in phase_mean.values() if v is not None]
    summary = {
        "heights": len(out_heights),
        "nodes": sorted(offsets),
        "phase_ms": phase_mean,
        "phase_total_ms": round(sum(known), 3) if known else None,
        "proposal_propagation_p50_ms": _quantile(prop_all, 0.50),
        "proposal_propagation_p99_ms": _quantile(prop_all, 0.99),
        "straggler_heights": straggler_counts,
        "top_straggler": (max(straggler_counts, key=straggler_counts.get)
                          if straggler_counts else None),
    }
    return {"ref": ref_id, "offsets_ms": {k: round(v, 3) for k, v in offsets.items()},
            "heights": out_heights, "summary": summary}


# ------------------------------------------------------- chrome export


def chrome_spans(agg: dict, docs: list[dict]) -> list[dict]:
    """Render a fleet aggregate back into span records accepted by
    libs/trace.chrome_trace: one lane (tid) per node, an X span per
    height plus per-phase child spans on the common fleet axis, and an
    instant per raw event mark."""
    offsets = agg.get("offsets_ms") or {}
    spans: list[dict] = []
    t_min = None
    per_node: dict[str, list[tuple[int, dict]]] = {}
    for d in docs:
        if not d:
            continue
        nid = _doc_id(d)
        off_ns = offsets.get(nid, 0.0) * 1e6
        for rec in d.get("heights", []):
            evs = rec.get("events") or {}
            aligned = {k: v["wall_ns"] - off_ns for k, v in evs.items()}
            if aligned:
                lo = min(aligned.values())
                t_min = lo if t_min is None else min(t_min, lo)
            per_node.setdefault(nid, []).append((int(rec["height"]), {
                "aligned": aligned, "events": evs}))
    if t_min is None:
        return []
    next_id = 1
    for tid, nid in enumerate(sorted(per_node), start=1):
        for h, rec in per_node[nid]:
            al = rec["aligned"]
            a, b = al.get(NEW_HEIGHT), al.get(APPLY_DONE)
            parent = None
            if a is not None and b is not None and b >= a:
                parent = next_id
                next_id += 1
                spans.append({
                    "id": parent, "parent_id": None, "trace_id": h,
                    "name": f"height {h} [{nid}]", "cat": "heightline",
                    "t0_ns": int(a - t_min), "dur_ns": int(b - a),
                    "tid": tid, "attrs": {"height": h, "node": nid},
                })
            for phase, start, end in _PHASE_EDGES:
                pa, pb = al.get(start), al.get(end)
                if pa is None or pb is None or pb < pa:
                    continue
                sid = next_id
                next_id += 1
                spans.append({
                    "id": sid, "parent_id": parent, "trace_id": h,
                    "name": phase, "cat": "heightline",
                    "t0_ns": int(pa - t_min), "dur_ns": int(pb - pa),
                    "tid": tid, "attrs": {"height": h, "node": nid},
                })
            for name, t in al.items():
                sid = next_id
                next_id += 1
                spans.append({
                    "id": sid, "parent_id": parent, "trace_id": h,
                    "name": name, "cat": "heightline",
                    "t0_ns": int(t - t_min), "dur_ns": 0, "tid": tid,
                    "attrs": {"height": h, "node": nid, "instant": True,
                              "peer": rec["events"][name].get("peer", "")},
                })
    return spans
