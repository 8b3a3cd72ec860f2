"""Durable inference request/response queues.

Requests are durably enqueued (append + one fence -- can group-commit a
burst under a single fence); a response is durable when its record lands in
the response WAL (one fence per batch of responses).  Crash recovery
replays: pending = requests-prefix minus responded ids.  In-flight requests
at crash time are simply re-served (at-least-once serving with
idempotent request ids -- the standard contract)."""
from __future__ import annotations

import json
import os
from typing import List

from ..persist.wal import WriteAheadLog


class DurableRequestQueue:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.req_wal = WriteAheadLog(os.path.join(directory, "requests.wal"))
        self.resp_wal = WriteAheadLog(os.path.join(directory, "responses.wal"))
        self._pending: List[dict] = []
        self._responded: set = set()

    # ----------------------------------------------------------------- client
    def submit(self, requests: List[dict]) -> None:
        """Durable enqueue; one fence for the whole burst."""
        for r in requests:
            assert "id" in r
            self.req_wal.append(json.dumps(r).encode())
            self._pending.append(r)
        self.req_wal.fence()

    # ----------------------------------------------------------------- server
    def take_batch(self, n: int) -> List[dict]:
        batch = self._pending[:n]
        self._pending = self._pending[n:]
        return batch

    def commit_responses(self, responses: List[dict]) -> None:
        """Durable response publication; one fence per batch."""
        for r in responses:
            self.resp_wal.append(json.dumps(r).encode())
            self._responded.add(r["id"])
        self.resp_wal.fence()

    def pending_count(self) -> int:
        return len(self._pending)

    # --------------------------------------------------------------- recovery
    def recover(self) -> int:
        reqs = [json.loads(p.decode()) for p in WriteAheadLog.replay(
            os.path.join(self.dir, "requests.wal"))]
        resps = [json.loads(p.decode()) for p in WriteAheadLog.replay(
            os.path.join(self.dir, "responses.wal"))]
        self._responded = {r["id"] for r in resps}
        self._pending = [r for r in reqs if r["id"] not in self._responded]
        return len(self._pending)

    def responses(self) -> List[dict]:
        return [json.loads(p.decode()) for p in WriteAheadLog.replay(
            os.path.join(self.dir, "responses.wal"))]

    def close(self) -> None:
        self.req_wal.close()
        self.resp_wal.close()
