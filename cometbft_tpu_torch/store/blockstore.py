"""BlockStore — block persistence (reference: store/store.go:38-460).

Key layout (height big-endian for ordered iteration/pruning):
  H:<height>          -> block meta (block_id proto + header proto + sizes)
  P:<height>:<index>  -> block part proto
  C:<height>          -> commit proto (the block's LastCommit, height-1 sigs)
  SC:<height>         -> "seen commit" for the block itself
  EC:<height>         -> extended commit (vote extensions, latest height)
  BH:<hash>           -> height (hash -> height index)
  base / height       -> store bounds

The port's copy of cometbft_tpu/store/blockstore.py over the port's
KVStore/MemDB; it writes the same bytes under the same keys. An extended
commit goes through ExtendedCommit.to_proto/from_proto (the bytes of the
reference's _extended_to_proto). save_block runs through the
`blockstore.save` disk-chaos seam (libs/diskchaos).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from cometbft_tpu_torch.libs import diskchaos
from cometbft_tpu_torch.store.db import KVStore
from cometbft_tpu_torch.types.basic import BlockID
from cometbft_tpu_torch.types.block import Block, Header
from cometbft_tpu_torch.types.commit import Commit, ExtendedCommit
from cometbft_tpu_torch.types.part_set import Part, PartSet
from cometbft_tpu_torch.utils import protobuf as pb


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


@dataclass
class BlockMeta:
    """store/types.go BlockMeta."""

    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.message(1, self.block_id.to_proto(), always=True)
        w.varint_i64(2, self.block_size)
        w.message(3, self.header.to_proto(), always=True)
        w.varint_i64(4, self.num_txs)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockMeta":
        r = pb.Reader(data)
        block_id, size, header, num_txs = BlockID(), 0, Header(), 0
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                block_id = BlockID.from_proto(r.read_bytes())
            elif f == 2:
                size = r.read_varint_i64()
            elif f == 3:
                header = Header.from_proto(r.read_bytes())
            elif f == 4:
                num_txs = r.read_varint_i64()
            else:
                r.skip(w)
        return cls(block_id=block_id, block_size=size, header=header, num_txs=num_txs)


class BlockStore:
    def __init__(self, db: KVStore):
        self.db = db
        self._lock = threading.RLock()
        self._base = int.from_bytes(db.get(b"base") or b"\x00" * 8, "big")
        self._height = int.from_bytes(db.get(b"height") or b"\x00" * 8, "big")

    # ------------------------------------------------------------- bounds

    def base(self) -> int:
        with self._lock:
            return self._base

    def height(self) -> int:
        with self._lock:
            return self._height

    def size(self) -> int:
        with self._lock:
            return 0 if self._height == 0 else self._height - self._base + 1

    # -------------------------------------------------------------- save

    def save_block(self, block: Block, part_set: PartSet, seen_commit: Commit) -> None:
        """store/store.go:401-417 SaveBlock."""
        self._save_block_parts(block, part_set, seen_commit, None)

    def save_block_with_extended_commit(
        self, block: Block, part_set: PartSet, seen_extended_commit: ExtendedCommit
    ) -> None:
        """store/store.go:418-440: keeps vote extensions for the latest
        height (needed to rebuild LastCommit for PrepareProposal)."""
        self._save_block_parts(
            block, part_set, seen_extended_commit.to_commit(), seen_extended_commit
        )

    def _save_block_parts(
        self,
        block: Block,
        part_set: PartSet,
        seen_commit: Commit,
        extended: ExtendedCommit | None,
    ) -> None:
        if block is None or not part_set.is_complete():
            raise ValueError("BlockStore can only save complete block part sets")
        # the block-store disk seam: an injected ENOSPC/EIO here must
        # surface BEFORE any pair lands (the batch below is one
        # transaction either way)
        diskchaos.fault_op("blockstore.save")
        height = block.header.height
        with self._lock:
            if self._height > 0 and height != self._height + 1:
                raise ValueError(
                    f"BlockStore can only save contiguous blocks: wanted {self._height + 1}, got {height}"
                )
            block_id = BlockID(hash=block.hash(), part_set_header=part_set.header())
            meta = BlockMeta(
                block_id=block_id,
                block_size=sum(len(p.bytes_) for p in part_set.parts if p),
                header=block.header,
                num_txs=len(block.data.txs),
            )
            pairs: list[tuple[bytes, bytes | None]] = [
                (_hkey(b"H:", height), meta.to_proto()),
                (b"BH:" + block_id.hash, height.to_bytes(8, "big")),
            ]
            for i in range(part_set.total):
                part = part_set.get_part(i)
                pairs.append((_hkey(b"P:", height) + i.to_bytes(4, "big"), part.to_proto()))
            if block.last_commit is not None:
                pairs.append((_hkey(b"C:", height - 1), block.last_commit.to_proto()))
            pairs.append((_hkey(b"SC:", height), seen_commit.to_proto()))
            if extended is not None:
                pairs.append((_hkey(b"EC:", height), extended.to_proto()))
            new_base = self._base or height
            pairs.append((b"base", new_base.to_bytes(8, "big")))
            pairs.append((b"height", height.to_bytes(8, "big")))
            self.db.batch_set(pairs)
            self._base, self._height = new_base, height

    # -------------------------------------------------------------- load

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self.db.get(_hkey(b"H:", height))
        return BlockMeta.from_proto(raw) if raw is not None else None

    def load_block(self, height: int) -> Block | None:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        chunks = []
        for i in range(meta.block_id.part_set_header.total):
            raw = self.db.get(_hkey(b"P:", height) + i.to_bytes(4, "big"))
            if raw is None:
                return None
            chunks.append(Part.from_proto(raw).bytes_)
        return Block.from_proto(b"".join(chunks))

    def load_block_by_hash(self, h: bytes) -> Block | None:
        raw = self.db.get(b"BH:" + h)
        if raw is None:
            return None
        return self.load_block(int.from_bytes(raw, "big"))

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self.db.get(_hkey(b"P:", height) + index.to_bytes(4, "big"))
        return Part.from_proto(raw) if raw is not None else None

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical commit for `height` (stored with block height+1)."""
        raw = self.db.get(_hkey(b"C:", height))
        return Commit.from_proto(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self.db.get(_hkey(b"SC:", height))
        return Commit.from_proto(raw) if raw is not None else None

    def load_block_extended_commit(self, height: int) -> ExtendedCommit | None:
        raw = self.db.get(_hkey(b"EC:", height))
        return ExtendedCommit.from_proto(raw) if raw is not None else None

    # ------------------------------------------------------------- prune

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        """store/store.go SaveSeenCommit — the statesync bootstrap hook:
        consensus reconstructs LastCommit from it at the restored height."""
        self.db.set(_hkey(b"SC:", height), commit.to_proto())

    def delete_latest_block(self) -> None:
        """store/store.go DeleteLatestBlock — the rollback tool's hook."""
        with self._lock:
            height = self._height
            if height == 0:
                raise ValueError("block store is empty")
            meta = self.load_block_meta(height)
            pairs: list[tuple[bytes, bytes | None]] = [
                (_hkey(b"H:", height), None),
                (_hkey(b"SC:", height), None),
                (_hkey(b"EC:", height), None),
                (_hkey(b"C:", height - 1), None),
            ]
            if meta is not None:
                pairs.append((b"BH:" + meta.block_id.hash, None))
                for i in range(10_000):
                    k = _hkey(b"P:", height) + i.to_bytes(4, "big")
                    if self.db.get(k) is None:
                        break
                    pairs.append((k, None))
            pairs.append((b"height", (height - 1).to_bytes(8, "big")))
            self.db.batch_set(pairs)
            self._height = height - 1

    def prune_blocks(self, retain_height: int) -> int:
        """store/store.go:301-383: delete blocks below retain_height,
        keeping hash indices consistent. Returns number pruned."""
        with self._lock:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height:
                raise ValueError("cannot prune beyond the latest height")
            pruned = 0
            pairs: list[tuple[bytes, bytes | None]] = []
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                pairs.append((_hkey(b"H:", h), None))
                pairs.append((b"BH:" + meta.block_id.hash, None))
                for i in range(meta.block_id.part_set_header.total):
                    pairs.append((_hkey(b"P:", h) + i.to_bytes(4, "big"), None))
                pairs.append((_hkey(b"C:", h - 1), None))
                pairs.append((_hkey(b"SC:", h), None))
                pairs.append((_hkey(b"EC:", h), None))
                pruned += 1
            pairs.append((b"base", retain_height.to_bytes(8, "big")))
            self.db.batch_set(pairs)
            self._base = retain_height
            return pruned

