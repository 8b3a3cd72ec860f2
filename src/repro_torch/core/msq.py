"""The volatile Michael--Scott queue (MSQ, PODC'96) -- paper §3.1.

This is the non-durable substrate every queue in the paper extends, and our
linearizability oracle.  It lives entirely in the volatile address space:
after a crash nothing survives (which is exactly why the durable amendments
exist).  It issues no flushes or fences, so it is the one queue whose cost
is identical under every :class:`repro.core.memmodel.MemoryModel` -- the
benchmark sweep uses it as the memory-model-invariant baseline.
"""
from __future__ import annotations

from typing import Any

from .nvram import NVRAM
from .opsched import (AllocV, Cas, FifoLayout, L, OpSchedule, QueueSchedules,
                      Read, Write)
from .queue_base import NULL, QueueAlgorithm
from .ssmem import VolatileAlloc

# node layout (volatile words)
ITEM, NEXT = 0, 1
NODE_WORDS = 2


class MSQueue(QueueAlgorithm):
    NAME = "MSQ"

    def __init__(self, nvram: NVRAM, mem, nthreads: int, on_event=None):
        super().__init__(nvram, mem, nthreads, on_event)
        self.valloc = VolatileAlloc(nvram, nthreads, NODE_WORDS, name="msq")
        nv = self.nvram
        self.HEAD = nv.alloc_region(1, "msq:head", persistent=False)
        self.TAIL = nv.alloc_region(1, "msq:tail", persistent=False)
        dummy = self._new_node(0, None)
        nv.write(self.HEAD, dummy)
        nv.write(self.TAIL, dummy)

    def _new_node(self, tid: int, item: Any) -> int:
        nv = self.nvram
        n = self.valloc.alloc(tid)
        nv.write(n + ITEM, item)
        nv.write(n + NEXT, NULL)
        return n

    # everything is volatile: a retry re-reads cached words and re-CASes
    RETRY_SHAPES = {
        "enq": dict(reads=2),
        "deq": dict(reads=4),
    }

    def op_schedule(self):
        """Steady state: pure volatile pointer chasing, no persists -- the
        memory-model-invariant baseline."""
        enq = OpSchedule("enq", steps=(
            AllocV(),
            Write(L("new_v", ITEM), ("item",)),
            Write(L("new_v", NEXT), ("c", NULL)),
            Read(L("TAIL")),
            Read(L("tail_v", NEXT)),
            Cas(L("tail_v", NEXT), ("sym", "new_v"), event="enq"),
            Cas(L("TAIL"), ("sym", "new_v"), root=True),
        ), uses_ssmem=False, retry_from=3)
        deq = OpSchedule("deq", steps=(
            Read(L("HEAD")),
            Read(L("head_v", NEXT)),
            Read(L("TAIL")),                     # MSQ reclamation guard
            Read(L("next_v", ITEM)),
            Cas(L("HEAD"), ("sym", "next_v"), root=True, event="deq"),
        ), uses_ssmem=False)
        return QueueSchedules(enq=enq, deq=deq, layout=FifoLayout(
            head_root="HEAD", next_off=NEXT, item_off=ITEM, volatile=True))

    def enqueue(self, tid: int, item: Any) -> None:
        nv = self.nvram
        node = self._new_node(tid, item)
        while True:
            tail = nv.read(self.TAIL)
            nxt = nv.read(tail + NEXT)
            if nxt == NULL:
                if nv.cas(tail + NEXT, NULL, node):
                    self._ev("enq", item)
                    nv.cas(self.TAIL, tail, node)
                    return
            else:
                nv.cas(self.TAIL, tail, nxt)

    def dequeue(self, tid: int) -> Any:
        nv = self.nvram
        while True:
            head = nv.read(self.HEAD)
            nxt = nv.read(head + NEXT)
            if nxt == NULL:
                self._ev("empty")
                return None
            # MSQ guard: never let the head overtake the tail -- keeps TAIL
            # from pointing at a dequeued (reclaimable) node.
            tail = nv.read(self.TAIL)
            if head == tail:
                nv.cas(self.TAIL, tail, nxt)
                continue
            item = nv.read(nxt + ITEM)   # read before CAS: the event right
            if nv.cas(self.HEAD, head, nxt):   # after the CAS is then exact
                self._ev("deq", item)
                # no immediate reuse: MSQ needs safe memory reclamation to
                # avoid ABA; the durable queues use ssmem epochs for this.
                return item
