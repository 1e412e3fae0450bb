"""Mutation write-ahead log: the durability half of crash recovery.

Every corpus mutation (``add_docs`` / ``delete_docs`` / compaction) appends
one framed record here *before* the engine acknowledges it, so an
acknowledged mutation survives a process crash: recovery restores the newest
valid snapshot and replays the WAL tail on top (see
``RetrievalEngine.recover``).

Format — append-only segment files ``wal-<firstseq>.log``:

    [8B magic "RWAL0001"]                      (once per segment)
    [u32 payload len][u32 crc32(payload)][msgpack payload] ...

Each payload carries a monotonic ``seq`` plus the mutation (add payloads
store the raw vector bytes + dtype/shape so replay is bit-exact).  The
format is the JAX package's (``repro.engine.wal``): the records hold no
time, so one mutation sequence gives byte-identical segments in both
packages, and each package replays and tails the other's log.  Payloads
are packed by this package's msgpack codec (`repro_torch.checkpoint.
_msgpack`), byte for byte ``msgpack.packb``.  A crash mid-write leaves a
*torn tail*: the length/CRC framing detects it, replay stops at the last
intact record, and ``open`` truncates the torn bytes so new appends never
land after garbage.

Lifecycle: ``rotate()`` at each snapshot starts a fresh segment (records up
to the snapshot's ``wal_seq`` live in older segments); ``prune(upto_seq)``
deletes segments entirely covered by the *oldest retained* snapshot — a
torn-newest-snapshot fallback can therefore still replay the older
snapshot's tail.  Thread safety is the engine's job: every append happens
under ``engine.lock``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.checkpoint import _msgpack as msgpack

_MAGIC = b"RWAL0001"
_HEADER = struct.Struct("<II")        # payload length, crc32(payload)
_MAX_RECORD = 1 << 30                 # sanity bound against garbage lengths


class WALError(RuntimeError):
    """The WAL is unusable (replay divergence, bad directory, ...) —
    distinct from a torn tail, which is an expected crash artifact and is
    truncated silently."""


class WALGap(WALError):
    """A tailing reader's position was pruned away: the records between the
    cursor and the oldest surviving segment are gone, so the reader must
    re-bootstrap from a snapshot instead of replaying."""


class WALRecord:
    """One replayable mutation."""

    __slots__ = ("seq", "kind", "payload")

    def __init__(self, seq: int, kind: str, payload: Dict):
        self.seq = seq
        self.kind = kind
        self.payload = payload

    def __repr__(self) -> str:
        return f"WALRecord(seq={self.seq}, kind={self.kind!r})"


def _segment_name(first_seq: int) -> str:
    return f"wal-{first_seq:012d}.log"


def _list_segments(wal_dir: str) -> List[Tuple[int, str]]:
    """All segment files in ``wal_dir`` as (first_seq, path), seq-sorted."""
    out = []
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return []
    for name in names:
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                first = int(name[4:-4])
            except ValueError:
                continue
            out.append((first, os.path.join(wal_dir, name)))
    return sorted(out)


def _scan_tail(path: str, offset: int) -> Tuple[List[WALRecord], int, bool]:
    """Parse frames starting at byte ``offset``; returns
    (records, clean_byte_length, torn).

    ``clean_byte_length`` is the *absolute* offset just past the last intact
    record — the truncation point for a torn tail, and the resume point for
    a tailing cursor.  ``torn`` is True when trailing bytes had to be
    discarded (partial frame, short payload, CRC mismatch).  ``offset == 0``
    verifies the segment magic first.
    """
    records: List[WALRecord] = []
    with open(path, "rb") as f:
        if offset == 0:
            if f.read(len(_MAGIC)) != _MAGIC:
                # unreadable header: treat the whole segment as torn
                return records, 0, True
            offset = len(_MAGIC)
        else:
            f.seek(offset)
        blob = f.read()
    off = 0
    clean = 0
    while off + _HEADER.size <= len(blob):
        length, crc = _HEADER.unpack_from(blob, off)
        start = off + _HEADER.size
        end = start + length
        if length > _MAX_RECORD or end > len(blob):
            return records, offset + clean, True  # partial frame
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            return records, offset + clean, True  # corrupt record
        rec = msgpack.unpackb(payload)
        records.append(WALRecord(int(rec["seq"]), rec["kind"], rec))
        off = end
        clean = off
    return records, offset + clean, off != len(blob)


def _scan_segment(path: str) -> Tuple[List[WALRecord], int, bool]:
    """Read one whole segment; returns (records, clean_byte_length, torn)."""
    return _scan_tail(path, 0)


class MutationWAL:
    """Framed, CRC-checked, fsync'd mutation log under ``wal_dir``."""

    def __init__(self, wal_dir: str, *, fsync: bool = True):
        self.wal_dir = wal_dir
        self.fsync = bool(fsync)
        os.makedirs(wal_dir, exist_ok=True)
        self.last_seq = -1                 # highest durable seq
        self.torn_tail = False             # open/replay found torn bytes
        self.n_appended = 0                # records appended this process
        self._since_rotate = 0             # records in the active segment
        self._fh = None
        segs = self._segments()
        if segs:
            # recover the active (newest) segment: find the clean length,
            # truncate any torn tail so appends go after intact records
            for first_seq, path in segs:
                recs, clean, torn = _scan_segment(path)
                if recs:
                    self.last_seq = max(self.last_seq, recs[-1].seq)
                elif not torn:
                    self.last_seq = max(self.last_seq, first_seq - 1)
                if path == segs[-1][1]:
                    self._since_rotate = len(recs)
                    if torn:
                        self.torn_tail = True
                        with open(path, "r+b") as f:
                            f.truncate(max(clean, len(_MAGIC)))
                            f.flush()
                            os.fsync(f.fileno())
            self._open_segment(segs[-1][1], fresh=False)
        else:
            self._start_segment(0)

    # -- segment plumbing ---------------------------------------------------
    def _segments(self) -> List[Tuple[int, str]]:
        return _list_segments(self.wal_dir)

    def _open_segment(self, path: str, *, fresh: bool) -> None:
        self._fh = open(path, "ab")
        if fresh:
            self._fh.write(_MAGIC)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def _start_segment(self, first_seq: int) -> None:
        path = os.path.join(self.wal_dir, _segment_name(first_seq))
        self._open_segment(path, fresh=not os.path.exists(path)
                           or os.path.getsize(path) == 0)

    # -- client surface -----------------------------------------------------
    def append(self, kind: str, payload: Dict) -> int:
        """Durably append one record; returns its seq number.

        The record is on disk (fsync'd when ``fsync=True``) before this
        returns — the engine acknowledges the mutation only after that, so
        "acked" implies "replayable".
        """
        if self._fh is None:
            raise WALError("WAL is closed")
        seq = self.last_seq + 1
        body = dict(payload)
        body["seq"] = seq
        body["kind"] = kind
        blob = msgpack.packb(body)
        self._fh.write(_HEADER.pack(len(blob), zlib.crc32(blob)))
        self._fh.write(blob)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self.last_seq = seq
        self.n_appended += 1
        self._since_rotate += 1
        return seq

    def replay(self, after_seq: int = -1) -> Iterator[WALRecord]:
        """Yield intact records with ``seq > after_seq`` in order.

        Stops at the first torn/corrupt record (sets ``torn_tail``) —
        everything after a tear is untrustworthy by construction.
        """
        for _first, path in self._segments():
            recs, _clean, torn = _scan_segment(path)
            for rec in recs:
                if rec.seq > after_seq:
                    yield rec
            if torn:
                self.torn_tail = True
                return

    def rotate(self) -> None:
        """Start a fresh segment (called at snapshot points): records up to
        ``last_seq`` stay in older segments, prunable once no retained
        snapshot needs them."""
        if self._fh is not None:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        self._start_segment(self.last_seq + 1)
        self._since_rotate = 0

    def prune(self, upto_seq: int) -> int:
        """Delete segments whose every record has ``seq <= upto_seq``;
        returns how many were removed.  The active segment is never
        pruned."""
        segs = self._segments()
        removed = 0
        for i, (first, path) in enumerate(segs):
            nxt = segs[i + 1][0] if i + 1 < len(segs) else None
            if nxt is None:                       # active segment
                break
            if nxt - 1 <= upto_seq:               # fully covered
                os.remove(path)
                removed += 1
            else:
                break
        return removed

    @property
    def lag(self) -> int:
        """Records appended since the last rotate (≈ replay length if the
        process died right now)."""
        return self._since_rotate

    @property
    def n_segments(self) -> int:
        return len(self._segments())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None

    def summary(self) -> Dict:
        return {
            "last_seq": self.last_seq,
            "lag_records": self.lag,
            "n_segments": self.n_segments,
            "torn_tail": self.torn_tail,
            "fsync": self.fsync,
        }

    def describe(self) -> str:
        return (f"MutationWAL(dir={self.wal_dir!r}, last_seq={self.last_seq}, "
                f"lag={self.lag}, segments={self.n_segments})")


class WALCursor:
    """Read-only tailing cursor over a live WAL directory.

    Built for replication: a follower polls the primary's ``wal/`` directory
    and applies records as they become durable.  The cursor is keyed by
    *sequence number*, not file position, so ``rotate()`` / ``prune()``
    racing a poll can never lose or double-apply a record:

    * records come back strictly in seq order, each exactly once — a
      re-read after rotation is filtered out by ``next_seq``;
    * a segment pruned *behind* the cursor held only consumed records —
      invisible;
    * a prune that removed records the cursor has not read yet (the reader
      fell further behind than the writer's snapshot retention) raises
      ``WALGap`` — the caller must re-bootstrap from a snapshot rather than
      silently skip the missing mutations.

    A torn tail on the newest segment is the writer mid-append (or a crash
    artifact the writer truncates on restart): ``poll`` stops before it and
    picks up from the same byte next time.  A tear in an *older* segment can
    never heal and raises ``WALError``.
    """

    def __init__(self, wal_dir: str, *, after_seq: int = -1):
        self.wal_dir = wal_dir
        self.next_seq = int(after_seq) + 1
        self._offsets: Dict[str, int] = {}     # path -> bytes fully parsed

    @property
    def applied_seq(self) -> int:
        """Highest seq this cursor has handed out (-1 before the first)."""
        return self.next_seq - 1

    def seek(self, after_seq: int) -> None:
        """Reposition so the next ``poll`` starts after ``after_seq``."""
        self.next_seq = int(after_seq) + 1
        self._offsets.clear()

    def poll(self, max_records: Optional[int] = None) -> List[WALRecord]:
        """Return new intact records with ``seq >= next_seq``, in order.

        Returns ``[]`` when the reader is caught up (or the writer is
        mid-append).  Raises ``WALGap`` when pruning outran the cursor.
        """
        for _attempt in range(3):
            try:
                return self._poll_once(max_records)
            except FileNotFoundError:
                # a segment vanished between listing and scan (prune racing
                # the poll): re-list — the seq filter keeps this idempotent
                self._offsets.clear()
                continue
        raise WALError(f"WAL segments under {self.wal_dir!r} keep vanishing "
                       "mid-scan")

    def _poll_once(self, max_records: Optional[int]) -> List[WALRecord]:
        segs = _list_segments(self.wal_dir)
        if not segs:
            return []
        if self.next_seq < segs[0][0]:
            raise WALGap(
                f"cursor at seq {self.next_seq} but oldest surviving segment "
                f"starts at {segs[0][0]}: records were pruned before they "
                "were read — re-bootstrap from a snapshot")
        live = {path for _first, path in segs}
        for stale in [p for p in self._offsets if p not in live]:
            del self._offsets[stale]
        out: List[WALRecord] = []
        for i, (first, path) in enumerate(segs):
            newest = i + 1 == len(segs)
            nxt = None if newest else segs[i + 1][0]
            if nxt is not None and nxt <= self.next_seq:
                continue                           # fully consumed segment
            recs, clean, torn = _scan_tail(path, self._offsets.get(path, 0))
            for rec in recs:
                if rec.seq < self.next_seq:
                    continue
                if rec.seq != self.next_seq:
                    raise WALError(
                        f"WAL sequence gap inside {path!r}: expected "
                        f"{self.next_seq}, found {rec.seq}")
                out.append(rec)
                self.next_seq = rec.seq + 1
                if max_records is not None and len(out) >= max_records:
                    return out
            self._offsets[path] = clean
            if torn:
                if newest:
                    return out                     # writer mid-append: retry
                raise WALError(
                    f"torn record inside non-active segment {path!r}")
        return out

    def last_available_seq(self) -> int:
        """Highest intact seq currently durable in the directory (-1 when
        empty) — the target the cursor is chasing."""
        segs = _list_segments(self.wal_dir)
        if not segs:
            return -1
        first, path = segs[-1]
        try:
            recs, _clean, _torn = _scan_segment(path)
        except FileNotFoundError:
            return self.applied_seq
        if recs:
            return recs[-1].seq
        return first - 1

    def lag(self) -> int:
        """How many durable records the cursor has not yet handed out."""
        return max(0, self.last_available_seq() - self.applied_seq)
