"""Write-ahead log for consensus messages.

Reference: consensus/wal.go over libs/autofile. Every message is written
BEFORE it is processed (consensus/state.go:821,829) so a crashed node
replays to the exact pre-crash state. Records are CRC32C+length framed;
EndHeightMessage sentinels mark completed heights (wal.go:42) and are the
replay anchors (SearchForEndHeight, wal.go:64). A corrupted tail (torn
write at crash) is detected by CRC/length and truncated, mirroring the
reference's WAL repair (consensus/state.go:2579).

Record body is a compact JSON envelope {"t": type, ...} — vote/proposal
payloads ride their canonical proto encodings in hex.

The port's copy of cometbft_tpu/consensus/wal.py.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Iterator

from cometbft_tpu_torch.consensus.round_state import RoundStepType
from cometbft_tpu_torch.consensus.ticker import TimeoutInfo
from cometbft_tpu_torch.libs import diskchaos, fail

MAX_RECORD_SIZE = 4 * 1024 * 1024


class WALCorruptionError(OSError):
    """Mid-group WAL corruption: a chunk that is NOT the stream tail
    failed its CRC/length framing — real disk damage, not a crash
    artifact, so replay refuses to guess. The message names the chunk,
    the byte offset of the first bad record, and the repair knob, so a
    node that cannot boot tells the operator exactly what to run."""

    def __init__(self, chunk: str, offset: int, detail: str):
        super().__init__(
            f"corrupted WAL chunk {chunk} at byte offset {offset} "
            f"({detail}); this chunk is not the stream tail, so it is "
            f"disk damage, not a torn crash-write. Repair: run "
            f"`cometbft wal-repair --home <home>` — it quarantines the "
            f"damaged chunk (kept as {os.path.basename(chunk)}.corrupt "
            f"for forensics) and the unreplayable records after it, "
            f"then the node boots and recovers the rest over "
            f"handshake/blocksync.")
        self.chunk = chunk
        self.offset = offset
        self.detail = detail


@dataclass
class RepairReport:
    """What `WAL.repair()` (the `cometbft wal-repair` surface) did."""

    corrupt_chunk: str | None = None
    offset: int = 0
    quarantined: list[str] = field(default_factory=list)
    truncated_bytes: int = 0


@dataclass
class EndHeightMessage:
    height: int


@dataclass
class EventDataRoundState:
    height: int
    round_: int
    step: str


class WAL:
    def __init__(self, path: str, chunk_size: int | None = None,
                 total_size: int | None = None):
        from cometbft_tpu_torch.libs import autofile

        self.path = path
        self.group = autofile.Group(
            path,
            chunk_size=chunk_size or autofile.DEFAULT_CHUNK_SIZE,
            total_size=total_size or autofile.DEFAULT_TOTAL_SIZE,
        )

    # ------------------------------------------------------------- write

    def write(self, msg) -> None:
        self._write_record(_encode_msg(msg))

    def write_sync(self, msg) -> None:
        self._write_record(_encode_msg(msg))
        self._timed_fsync()

    def _write_record(self, body: bytes) -> None:
        fail.fail_point("wal.write")
        crc = zlib.crc32(body) & 0xFFFFFFFF
        self.group.write(struct.pack(">II", crc, len(body)) + body)
        self.group.maybe_rotate()  # record boundary: safe rotation point

    def _timed_fsync(self) -> None:
        from cometbft_tpu_torch.libs import metrics as cmtmetrics

        t0 = time.perf_counter()
        self.group.fsync()
        cmtmetrics.storage_metrics().observe_wal_fsync(time.perf_counter() - t0)

    def flush(self) -> None:
        self._timed_fsync()

    def close(self) -> None:
        self.group.close()

    # -------------------------------------------------------------- read

    @staticmethod
    def _scan_chunk(path: str):
        """Scan one chunk: yields (good_end, body) per valid record, then
        returns via StopIteration.value a (good_end, detail|None) pair —
        detail is None when the chunk is clean to its last byte."""
        good_end = 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    detail = "torn record header" if hdr else None
                    return good_end, detail
                crc, n = struct.unpack(">II", hdr)
                if n == 0:
                    # crc32(b"") == 0, so an all-zero header would parse
                    # as a "valid" empty record — but no encoded message
                    # is empty; zeroed regions are damage
                    return good_end, "zero-length record"
                if n > MAX_RECORD_SIZE:
                    return good_end, f"record length {n} exceeds {MAX_RECORD_SIZE}"
                body = f.read(n)
                body = diskchaos.fault_read("wal.read", body)
                if len(body) < n:
                    return good_end, f"torn record body ({len(body)} of {n} bytes)"
                if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                    return good_end, "crc32 mismatch"
                good_end = f.tell()
                yield good_end, body

    def iter_records(self) -> Iterator[object]:
        """Yield decoded messages across every chunk in stream order;
        stops at a corrupted record. Torn tails are repaired by truncation
        only in the FINAL file (a mid-group corruption means real damage,
        not a crash artifact — reference wal.go repair semantics) and the
        truncation is counted on the storage metrics plane. Mid-group
        corruption raises the TYPED WALCorruptionError naming the chunk,
        the byte offset, and the `cometbft wal-repair` knob — never a
        bare stack trace, and never a corrupt message."""
        paths = [p for p in self.group.chunk_paths() if os.path.exists(p)]
        for pi, path in enumerate(paths):
            scan = self._scan_chunk(path)
            good_end, detail = 0, None
            while True:
                try:
                    good_end, body = next(scan)
                except StopIteration as stop:
                    good_end, detail = stop.value
                    break
                yield _decode_msg(body)
            size = os.path.getsize(path)
            if good_end < size:
                if pi == len(paths) - 1:
                    # torn tail: repair by truncation (reference auto-repair)
                    with open(path, "r+b") as f:
                        f.truncate(good_end)
                    from cometbft_tpu_torch.libs import metrics as cmtmetrics

                    cmtmetrics.storage_metrics().wal_truncations.inc()
                else:
                    raise WALCorruptionError(
                        path, good_end, detail or "trailing garbage")
            if detail is not None:
                return

    def repair(self) -> RepairReport:
        """The `cometbft wal-repair` surface: make the group replayable
        again after mid-group corruption. The damaged chunk keeps its
        good prefix (the original is preserved as `<chunk>.corrupt` for
        forensics) and every LATER chunk — records that cannot be safely
        replayed across the gap — is quarantined as `<chunk>.quarantined`.
        Sound because losing WAL tail records is equivalent to having
        crashed slightly earlier: block/state stores and the privval
        sign-state still guarantee no lost committed height and no
        double-sign; the node recovers the gap over handshake/blocksync."""
        report = RepairReport()
        # quarantining may rename the head out from under the group's
        # open handle — close first, reopen a fresh head after
        self.group.close()
        paths = [p for p in self.group.chunk_paths() if os.path.exists(p)]
        for pi, path in enumerate(paths):
            scan = self._scan_chunk(path)
            while True:
                try:
                    next(scan)
                except StopIteration as stop:
                    good_end, detail = stop.value
                    break
            size = os.path.getsize(path)
            if good_end >= size and detail is None:
                continue
            # first damage in stream order: truncate here, quarantine rest
            report.corrupt_chunk, report.offset = path, good_end
            report.truncated_bytes = size - good_end
            shutil.copyfile(path, path + ".corrupt")
            with open(path, "r+b") as f:
                f.truncate(good_end)
            for later in paths[pi + 1:]:
                os.replace(later, later + ".quarantined")
                report.quarantined.append(later)
            from cometbft_tpu_torch.libs import metrics as cmtmetrics

            cmtmetrics.storage_metrics().wal_repairs.inc()
            break
        self.group._head = open(self.group.head_path, "ab", buffering=0)
        diskchaos.track_open(self.group.head_path, fresh=True)
        return report

    def search_for_end_height(self, height: int) -> bool:
        """True if EndHeightMessage(height) exists (wal.go:64)."""
        for msg in self.iter_records():
            if isinstance(msg, EndHeightMessage) and msg.height == height:
                return True
        return False

    def replay_after_height(self, height: int) -> list[object]:
        """Messages recorded after EndHeight(height) — the catchup-replay
        input (consensus/replay.go:94). Collection stops at any LATER
        EndHeight sentinel: messages past it belong to an already-committed
        height and replaying them would re-execute the block against the
        app (replay.go:99-115 semantics)."""
        out: list[object] = []
        found = height == -1
        for msg in self.iter_records():
            if isinstance(msg, EndHeightMessage):
                if msg.height == height:
                    found = True
                    out = []
                elif found and msg.height > height:
                    break
                continue
            if found:
                out.append(msg)
        return out if found else []


def _encode_msg(msg) -> bytes:
    from cometbft_tpu_torch.consensus import messages as M

    if isinstance(msg, EndHeightMessage):
        doc = {"t": "eh", "h": msg.height}
    elif isinstance(msg, TimeoutInfo):
        doc = {"t": "to", "d": msg.duration, "h": msg.height, "r": msg.round_, "s": int(msg.step)}
    elif isinstance(msg, EventDataRoundState):
        doc = {"t": "rs", "h": msg.height, "r": msg.round_, "s": msg.step}
    elif isinstance(msg, M.VoteMessage):
        doc = {"t": "v", "d": msg.vote.to_proto().hex(), "p": msg.peer_id}
    elif isinstance(msg, M.ProposalMessage):
        doc = {"t": "p", "d": msg.proposal.to_proto().hex(), "p": msg.peer_id}
    elif isinstance(msg, M.BlockPartMessage):
        doc = {
            "t": "bp", "h": msg.height, "r": msg.round_,
            "d": msg.part.to_proto().hex(), "p": msg.peer_id,
        }
    else:
        raise TypeError(f"cannot WAL-encode {type(msg)}")
    return json.dumps(doc, separators=(",", ":")).encode()


def _decode_msg(body: bytes):
    from cometbft_tpu_torch.consensus import messages as M
    from cometbft_tpu_torch.types.part_set import Part
    from cometbft_tpu_torch.types.proposal import Proposal
    from cometbft_tpu_torch.types.vote import Vote

    doc = json.loads(body)
    t = doc["t"]
    if t == "eh":
        return EndHeightMessage(height=doc["h"])
    if t == "to":
        return TimeoutInfo(duration=doc["d"], height=doc["h"], round_=doc["r"],
                           step=RoundStepType(doc["s"]))
    if t == "rs":
        return EventDataRoundState(height=doc["h"], round_=doc["r"], step=doc["s"])
    if t == "v":
        return M.VoteMessage(vote=Vote.from_proto(bytes.fromhex(doc["d"])), peer_id=doc.get("p", ""))
    if t == "p":
        return M.ProposalMessage(proposal=Proposal.from_proto(bytes.fromhex(doc["d"])), peer_id=doc.get("p", ""))
    if t == "bp":
        return M.BlockPartMessage(
            height=doc["h"], round_=doc["r"],
            part=Part.from_proto(bytes.fromhex(doc["d"])), peer_id=doc.get("p", ""),
        )
    raise ValueError(f"unknown WAL record type {t!r}")
