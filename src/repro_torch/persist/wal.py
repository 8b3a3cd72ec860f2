"""Write-once append log -- the paper's §2.1 logging discipline at file
granularity.

Design rules carried over from the durable queues:
* records are framed (magic, length, crc32, payload) and **write-once**:
  the fast path never reads anything it wrote (zero post-flush accesses);
* ``append`` buffers + ``flush`` issues the OS write (the CLWB analogue);
  ``fence`` fsyncs -- the ONE blocking persist; group commit batches any
  number of appends under a single fence, exactly like the queues piggyback
  flushes on one SFENCE;
* recovery replays the longest valid *prefix* (a torn/corrupt tail record is
  treated as absent -- the file-level Assumption 1).
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import List

_MAGIC = 0x5151A5A5     # 'QQ' durable-queue homage
_HDR = struct.Struct("<III")   # magic, length, crc32


@dataclass
class WalStats:
    appends: int = 0
    flushes: int = 0
    fences: int = 0
    bytes_written: int = 0
    reads_after_write: int = 0   # must stay 0 on the fast path


class WriteAheadLog:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab", buffering=1024 * 1024)
        self.stats = WalStats()

    # ------------------------------------------------------------ fast path
    def append(self, payload: bytes) -> None:
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(_HDR.pack(_MAGIC, len(payload), crc))
        self._f.write(payload)
        self.stats.appends += 1
        self.stats.bytes_written += _HDR.size + len(payload)

    def flush(self) -> None:
        """Asynchronous write-back (CLWB analogue)."""
        self._f.flush()
        self.stats.flushes += 1

    def fence(self) -> None:
        """The ONE blocking persist: everything appended so far is durable."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self.stats.fences += 1

    def append_durable(self, payload: bytes) -> None:
        """Single logical update = append + flush + fence."""
        self.append(payload)
        self.fence()

    def close(self) -> None:
        self._f.close()

    # ------------------------------------------------------------- recovery
    @staticmethod
    def replay(path: str) -> List[bytes]:
        """Longest valid prefix of records (recovery-only read path)."""
        out: List[bytes] = []
        if not os.path.exists(path):
            return out
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HDR.size <= len(data):
            magic, length, crc = _HDR.unpack_from(data, off)
            if magic != _MAGIC or off + _HDR.size + length > len(data):
                break
            payload = data[off + _HDR.size: off + _HDR.size + length]
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                break   # torn tail: stop at the persisted prefix
            out.append(payload)
            off += _HDR.size + length
        return out
