"""Durable data pipeline with exactly-once shard delivery.

The training data queue is a durable FIFO in the paper's mold:
* **producers** enqueue shard descriptors into a WAL -- a batch of enqueues
  shares ONE fence (group commit = the single blocking persist per update);
* **consumers** (trainer workers) read shards in order; consumption becomes
  durable when the per-worker cursor advances -- which happens at
  *checkpoint commit* time, so data state and model state move atomically:
  after a crash, training resumes from the last committed step and replays
  exactly the shards after its cursor (consumed-but-uncommitted shards are
  re-delivered; committed ones never -- the FIFO prefix rule,
  Observation 2);
* nothing on the fast path re-reads what it persisted (guideline 2): the
  shard WAL is only replayed at recovery, cursors are write-only.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..persist.cursors import CursorFile
from ..persist.wal import WriteAheadLog


class TokenSource:
    """Deterministic synthetic token stream (shard id -> tokens)."""

    def __init__(self, vocab: int, seq_len: int, batch: int):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch

    def batch_for(self, shard_id: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(shard_id % (2 ** 31))
        toks = rng.randint(0, self.vocab,
                           (self.batch, self.seq_len)).astype(np.int32)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


class DurableShardQueue:
    def __init__(self, directory: str, worker_id: int = 0, n_workers: int = 1):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.wal = WriteAheadLog(os.path.join(directory, "shards.wal"))
        self.cursor = CursorFile(self._cursor_path(worker_id))
        # volatile state rebuilt by recover()
        self._shards: List[dict] = []
        self._next = 0

    def _cursor_path(self, w: int) -> str:
        return os.path.join(self.dir, f"cursor_{w}.bin")

    # ---------------------------------------------------------------- produce
    def enqueue_shards(self, descriptors: List[dict]) -> None:
        """Durable enqueue: N appends + ONE fence (group commit)."""
        for d in descriptors:
            self.wal.append(json.dumps(d).encode())
        self.wal.fence()
        self._shards.extend(descriptors)

    # ---------------------------------------------------------------- consume
    def next_shard(self) -> Optional[dict]:
        """Volatile dequeue; durability comes from commit_consumed()."""
        mine = [i for i in range(self._next, len(self._shards))
                if i % self.n_workers == self.worker_id]
        if not mine:
            return None
        i = mine[0]
        self._next = i + 1
        d = dict(self._shards[i])
        d["_queue_index"] = i
        return d

    def commit_consumed(self, queue_index: int, fence: bool = True) -> None:
        """Advance the durable per-worker cursor (paper: movnti the
        per-thread head index + the one fence).  Called at checkpoint
        commit so data and model state stay atomic."""
        self.cursor.advance(queue_index + 1, fence=fence)

    # --------------------------------------------------------------- recovery
    def recover(self) -> int:
        """Rebuild volatile state: replay the WAL prefix, set the head to the
        max committed per-worker cursor.  Returns the resume index."""
        self._shards = [json.loads(p.decode())
                        for p in WriteAheadLog.replay(
                            os.path.join(self.dir, "shards.wal"))]
        paths = [self._cursor_path(w) for w in range(self.n_workers)]
        head = CursorFile.recover_max(paths) or 0
        self._next = head
        return head

    def close(self) -> None:
        self.wal.close()
        self.cursor.close()
