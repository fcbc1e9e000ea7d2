"""Single-producer single-consumer byte ring over POSIX shared
memory — the committed-stream handoff between a serving shard and
the apply/watch worker (server/roles.py).  The port's copy of
``etcd_tpu/server/shmring.py``; the segment layout is the same byte
for byte, so either package's consumer reads the other's ring.

Design constraints, in order:

  * **Bounded by construction.**  The ring is a fixed byte span; a
    producer that outruns the consumer drops whole records and
    counts them (``dropped``), it never blocks the raft apply path
    and never grows.  Consumers detect the loss as a gap in the
    COMMIT frame ``seq`` (wire/rolemsg.py) rather than silently
    missing events.
  * **Restart without replay.**  Both cursors live in the shared
    header, so a crashed consumer re-attaches and resumes at its own
    persisted ``tail`` — records applied before the crash are behind
    the cursor and can never be consumed twice (the no-double-apply
    property).
  * **Zero-copy handoff.**  Records are length-prefixed and never
    split across the wrap, so a reader can hand a contiguous
    ``memoryview`` straight to ``frombuffer`` parsers.  ``pop``
    copies by default because the payload outlives the cursor
    advance; ``peek``/``advance`` expose the no-copy path.

Layout: 64-byte header | capacity bytes of records.

  header: magic "SRG1" u32 | generation u32 | head u64 | tail u64 |
          dropped u64 | capacity u64 | reserved

  record: length u32 | payload (contiguous).  A record that would
  straddle the end of the span is preceded by a wrap marker
  (0xFFFFFFFF, written only when >= 4 bytes remain before the
  boundary) and starts at offset 0.

Cursors are monotonic byte offsets (masked modulo capacity on use),
stored as single aligned 8-byte little-endian writes — atomic for
in-order stores on the platforms we run (CPython under the GIL emits
one memcpy per struct.pack_into).  The producer publishes ``head``
only after the payload bytes are fully written; the consumer
publishes ``tail`` only after it has finished (or copied) the
payload.
"""

from __future__ import annotations

import struct
from multiprocessing import shared_memory

from ..wire.schema import BOUNDS, SRG1, FrameError, check_bound

# layout constants come from the declarative schema (wire/schema.py)
_MAGIC = SRG1.magic
_WRAP = 0xFFFFFFFF
_HDR_SIZE = SRG1.header_size
_OFF_MAGIC = SRG1.offsets["magic"]
_OFF_GEN = SRG1.offsets["generation"]
_OFF_HEAD = SRG1.offsets["head"]
_OFF_TAIL = SRG1.offsets["tail"]
_OFF_DROPPED = SRG1.offsets["dropped"]
_OFF_CAP = SRG1.offsets["capacity"]

#: Smallest record span: u32 length prefix. Also the wrap marker size.
_LEN = 4

#: plausibility cap on one length-prefixed record ("srg1.record_len"):
#: the producer drops larger payloads, the consumer treats a larger
#: prefix as corruption and resyncs at the producer cursor
_REC_CAP = BOUNDS["srg1.record_len"]


class ShmRing:
    """One endpoint of the ring. The creator (role supervisor) owns
    the segment lifetime; producers/consumers attach by name."""

    def __init__(self, name: str, capacity: int = 1 << 20, *,
                 create: bool = False):
        if capacity <= 2 * _LEN:
            raise ValueError("capacity too small")
        self.name = name
        if create:
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=_HDR_SIZE + capacity)
            buf = self._shm.buf
            buf[:_HDR_SIZE] = b"\x00" * _HDR_SIZE
            struct.pack_into("<I", buf, _OFF_MAGIC, _MAGIC)
            struct.pack_into("<Q", buf, _OFF_CAP, capacity)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
        self._attach(self._shm.buf)
        self._owner = create

    def _attach(self, buf) -> None:
        """Validate the ring header and adopt ``buf``.  The segment
        is wire data — a stale, truncated, or foreign segment must
        fail typed, and a corrupt capacity must never size the
        cursor math (cap=0 divides, cap > segment silently
        short-slices)."""
        name = self.name
        if len(buf) < _HDR_SIZE:
            raise FrameError(
                f"shm segment {name!r} too small for ring header")
        (magic,) = struct.unpack_from("<I", buf, _OFF_MAGIC)
        if magic != _MAGIC:
            raise FrameError(f"shm segment {name!r} is not a ring")
        (self.capacity,) = struct.unpack_from("<Q", buf, _OFF_CAP)
        check_bound("srg1.capacity", self.capacity)
        if (self.capacity <= 2 * _LEN
                or self.capacity != len(buf) - _HDR_SIZE):
            raise FrameError(
                f"shm segment {name!r}: implausible ring capacity "
                f"{self.capacity} for {len(buf)}-byte segment")
        self._buf = buf

    @classmethod
    def from_buffer(cls, buf, name: str = "<buffer>") -> "ShmRing":
        """Attach to a raw ring image (tests / the schema-driven
        fuzzer): same typed header validation as a shm attach, no
        shared-memory segment behind it."""
        self = cls.__new__(cls)
        self.name = name
        self._shm = None
        self._owner = False
        self._attach(memoryview(buf) if isinstance(buf, (bytes,
                     bytearray)) else buf)
        return self

    # -- header accessors ---------------------------------------------------

    def _get(self, off: int) -> int:
        (v,) = struct.unpack_from("<Q", self._buf, off)
        return v

    def _put(self, off: int, v: int) -> None:
        struct.pack_into("<Q", self._buf, off, v)

    @property
    def head(self) -> int:
        return self._get(_OFF_HEAD)

    @property
    def tail(self) -> int:
        return self._get(_OFF_TAIL)

    @property
    def dropped(self) -> int:
        return self._get(_OFF_DROPPED)

    def bump_generation(self) -> int:  # owner: shmring-producer
        """Producer calls on (re-)attach so observers can tell a
        restarted shard from a stalled one."""
        (g,) = struct.unpack_from("<I", self._buf, _OFF_GEN)
        struct.pack_into("<I", self._buf, _OFF_GEN, (g + 1) & 0xFFFFFFFF)
        return g + 1

    @property
    def generation(self) -> int:
        (g,) = struct.unpack_from("<I", self._buf, _OFF_GEN)
        return g

    def __len__(self) -> int:
        return self.head - self.tail

    # -- producer -----------------------------------------------------------

    def push(self, payload) -> bool:  # owner: shmring-producer
        """Appends one record; returns False (and counts a drop) if
        it doesn't fit. Records larger than capacity - 2*_LEN - 1
        can never fit and always drop."""
        n = len(payload)
        if n > _REC_CAP:
            # over the schema's srg1.record_len cap: the consumer
            # would treat the prefix as corruption, so drop loudly
            # here instead of poisoning the ring
            self._put(_OFF_DROPPED, self.dropped + 1)
            return False
        head, tail = self.head, self.tail
        cap = self.capacity
        pos = head % cap
        to_end = cap - pos
        need = _LEN + n
        if to_end < need:
            # wrap: burn the rest of the span (+ marker if room)
            need = to_end + _LEN + n
            marker = to_end >= _LEN
        else:
            marker = False
        # full-ring guard: leave one byte free so head==tail is
        # unambiguously "empty"
        if need >= cap - (head - tail):
            self._put(_OFF_DROPPED, self.dropped + 1)
            return False
        buf = self._buf
        if to_end < _LEN + n:
            if marker:
                struct.pack_into("<I", buf, _HDR_SIZE + pos, _WRAP)
            pos = 0
        struct.pack_into("<I", buf, _HDR_SIZE + pos, n)
        buf[_HDR_SIZE + pos + _LEN:_HDR_SIZE + pos + _LEN + n] = payload
        # publish only after the payload bytes are in place
        self._put(_OFF_HEAD, head + need)
        return True

    # -- consumer -----------------------------------------------------------

    def _peek(self) -> tuple[memoryview, int] | None:  # owner: shmring-consumer
        """Returns (payload view, consumed byte span) or None."""
        head, tail = self.head, self.tail
        if head == tail:
            return None
        cap = self.capacity
        pos = tail % cap
        to_end = cap - pos
        skipped = 0
        if to_end < _LEN:
            # producer wrapped without room for a marker
            skipped = to_end
            pos = 0
        else:
            (n,) = struct.unpack_from("<I", self._buf,
                                      _HDR_SIZE + pos)
            if n == _WRAP:
                skipped = to_end
                pos = 0
            elif _LEN + n > to_end:
                # length prefix would run past the span boundary:
                # corrupt header, resync at the producer cursor
                self._put(_OFF_TAIL, head)
                return None
        (n,) = struct.unpack_from("<I", self._buf, _HDR_SIZE + pos)
        if _LEN + n > cap - pos or n == _WRAP or n > _REC_CAP:
            self._put(_OFF_TAIL, head)
            return None
        view = self._buf[_HDR_SIZE + pos + _LEN:
                         _HDR_SIZE + pos + _LEN + n]
        return view, skipped + _LEN + n

    def pop(self) -> bytes | None:  # owner: shmring-consumer
        """Copies out the next record and advances, or None if
        empty."""
        got = self._peek()
        if got is None:
            return None
        view, span = got
        payload = bytes(view)
        view.release()
        self._put(_OFF_TAIL, self.tail + span)
        return payload

    def close(self) -> None:
        self._buf = None
        if self._shm is not None:
            self._shm.close()

    def unlink(self) -> None:
        if self._shm is None:
            return
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
