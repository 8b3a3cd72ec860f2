"""Per-worker monotone cursors -- OptUnlinkedQ/OptLinkedQ's per-thread head
index and double last-enqueue record, at file granularity.

Each worker owns a slot file that is only ever *written* on the fast path
(the movnti analogue: no read-modify-write, no readback).  Writes alternate
between two fixed slots so a torn write can only destroy the slot being
written -- the other still holds the penultimate durable value, exactly the
paper's two-record trick (§6.2).  Recovery takes the max valid value; across
workers the global cursor is the max over per-worker cursors (§6.1).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

_REC = struct.Struct("<QQI")    # value, seq, crc
_SLOT = 64                      # one "cache line" per slot


class CursorFile:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "r+b" if os.path.exists(path) else "w+b")
        if os.path.getsize(path) < 2 * _SLOT:
            self._f.write(b"\0" * (2 * _SLOT))
            self._f.flush()
        self._seq = 0
        self.fences = 0

    def advance(self, value: int, fence: bool = True) -> None:
        """Publish a new cursor value (write-only; never reads back)."""
        self._seq += 1
        body = struct.pack("<QQ", value, self._seq)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        rec = _REC.pack(value, self._seq, crc)
        self._f.seek((self._seq % 2) * _SLOT)
        self._f.write(rec)
        self._f.flush()
        if fence:
            os.fsync(self._f.fileno())
            self.fences += 1

    def fence(self) -> None:
        os.fsync(self._f.fileno())
        self.fences += 1

    def close(self) -> None:
        self._f.close()

    # ------------------------------------------------------------- recovery
    @staticmethod
    def recover(path: str) -> Optional[int]:
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            data = f.read()
        best = None
        for i in range(2):
            chunk = data[i * _SLOT: i * _SLOT + _REC.size]
            if len(chunk) < _REC.size:
                continue
            value, seq, crc = _REC.unpack(chunk)
            body = struct.pack("<QQ", value, seq)
            if (zlib.crc32(body) & 0xFFFFFFFF) == crc and seq > 0:
                if best is None or value > best:
                    best = value
        return best

    @staticmethod
    def recover_max(paths: List[str]) -> Optional[int]:
        """Global cursor = max across per-worker cursors (paper §6.1)."""
        vals = [CursorFile.recover(p) for p in paths]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None
