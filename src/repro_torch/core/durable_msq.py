"""DurableMSQ -- the thinned Friedman et al. (PPoPP'18) durable queue.

The paper's baseline (§10): the original durable queue minus the
returned-value recovery mechanism (which durable linearizability does not
require).  Persist schedule:

* enqueue: persist the node content before linking (flush+fence #1), link
  with CAS, persist the predecessor's ``next`` (flush+fence #2), advance tail
  -- **2 blocking fences per enqueue**;
* dequeue: CAS the head forward and persist it (flush+fence) -- **1 fence**;
  a failing dequeue also persists the head to make preceding dequeues
  durable.

Recovery walks the persisted ``next`` chain from the persisted head.  Note
the post-flush accesses this design incurs (and the paper measures): each
enqueue re-reads the flushed tail node's line, each dequeue re-reads the
flushed head line and the flushed node content.
"""
from __future__ import annotations

from typing import Any

from .nvram import LINE_WORDS, NVRAM
from .opsched import (AllocP, Cas, Fence, FifoLayout, Flush, L, OpSchedule,
                      QueueSchedules, Read, Retire, WriteLine)
from .queue_base import NULL, QueueAlgorithm, alloc_root_lines
from .ssmem import SSMem

# persistent node layout (one cache line)
ITEM, NEXT = 0, 1


class DurableMSQueue(QueueAlgorithm):
    NAME = "DurableMSQ"

    def __init__(self, nvram: NVRAM, mem: SSMem, nthreads: int, on_event=None,
                 _recovering: bool = False, roots=None):
        super().__init__(nvram, mem, nthreads, on_event)
        nv = self.nvram
        if roots is None:
            roots = alloc_root_lines(nv, 2, "durablemsq:roots")
        self.HEAD, self.TAIL = roots
        self.roots = roots
        if not _recovering:
            dummy = self.mem.alloc(0)
            nv.write_full_line(dummy, [None, NULL, 0, 0, 0, 0, 0, 0])
            nv.write(self.HEAD, dummy)
            nv.write(self.TAIL, dummy)
            self.pflush(dummy)
            self.pflush(self.HEAD)
            self.pfence()

    # ---------------------------------------- steady-state schedule facts
    # enq retry: re-read TAIL (hit) and the obstructing tail->next on a
    # line the winner flushed (post-flush), then take the helping path --
    # persist the obstruction (flush+fence) and CAS TAIL forward before
    # re-attempting the link CAS.  deq retry: pure re-reads -- the HEAD
    # and node lines were already re-fetched (and so re-cached) by
    # whichever op touched them first after the invalidating flush, so a
    # retry adds hits, not post-flush accesses.  (Roots come from the
    # op_schedule's root CAS; see queue_base.retry_profile.)
    RETRY_SHAPES = {
        "enq": dict(reads=1, flushed_reads=0.8, cas=2, flushes=1, fences=1,
                    weight=0.6),
        "deq": dict(reads=4),
    }

    def op_schedule(self):
        """Steady state (paper §10 baseline): 2 fences/enq, 1 fence/deq,
        post-flush re-reads of the tail link and head line."""
        enq = OpSchedule("enq", steps=(
            AllocP(),
            WriteLine(L("new_p"), (None, NULL, 0, 0, 0, 0, 0, 0), item_at=0),
            Flush(L("new_p")), Fence(),              # fence #1: node content
            Read(L("TAIL")),
            Read(L("tail_p", NEXT)),
            Cas(L("tail_p", NEXT), ("sym", "new_p"), event="enq"),
            Flush(L("tail_p", NEXT)), Fence(),       # fence #2: link durable
            Cas(L("TAIL"), ("sym", "new_p"), root=True),
        ), retry_from=4)
        deq = OpSchedule("deq", steps=(
            Read(L("HEAD")),
            Read(L("head_p", NEXT)),
            Read(L("TAIL")),                         # MSQ reclamation guard
            Read(L("next_p", ITEM)),
            Cas(L("HEAD"), ("sym", "next_p"), root=True, event="deq"),
            Flush(L("HEAD")), Fence(),               # 1 fence per dequeue
            Retire(("sym", "head_p")),
        ))
        return QueueSchedules(enq=enq, deq=deq, layout=FifoLayout(
            head_root="HEAD", next_off=NEXT, item_off=ITEM))

    # ------------------------------------------------------------------ ops
    def enqueue(self, tid: int, item: Any) -> None:
        nv = self.nvram
        self.mem.op_begin(tid)
        node = self.mem.alloc(tid)
        nv.write_full_line(node, [item, NULL, 0, 0, 0, 0, 0, 0])
        self.pflush(node)
        self.pfence()                       # fence #1: node content durable
        while True:
            tail = nv.read(self.TAIL)
            nxt = nv.read(tail + NEXT)
            if nxt == NULL:
                if nv.cas(tail + NEXT, NULL, node):
                    self._ev("enq", item)
                    self.pflush(tail + NEXT)
                    self.pfence()           # fence #2: link durable
                    nv.cas(self.TAIL, tail, node)
                    return
            else:
                # help: persist the obstructing link before advancing tail
                self.pflush(tail + NEXT)
                self.pfence()
                nv.cas(self.TAIL, tail, nxt)

    def dequeue(self, tid: int) -> Any:
        nv = self.nvram
        self.mem.op_begin(tid)
        while True:
            head = nv.read(self.HEAD)
            nxt = nv.read(head + NEXT)
            if nxt == NULL:
                self.pflush(self.HEAD)
                self.pfence()               # make prior dequeues durable
                self._ev("empty")
                return None
            # MSQ guard: head must not overtake tail (reclamation safety)
            tail = nv.read(self.TAIL)
            if head == tail:
                self.pflush(tail + NEXT)
                self.pfence()
                nv.cas(self.TAIL, tail, nxt)
                continue
            item = nv.read(nxt + ITEM)
            if nv.cas(self.HEAD, head, nxt):
                self._ev("deq", item)
                self.pflush(self.HEAD)
                self.pfence()               # 1 fence per dequeue
                self.mem.retire(tid, head)
                return item

    # ------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, nvram: NVRAM, mem: SSMem, nthreads: int, roots,
                on_event=None) -> "DurableMSQueue":
        q = cls(nvram, mem, nthreads, on_event, _recovering=True, roots=roots)
        head = nvram.pread(q.HEAD) or NULL
        assert head != NULL, "initial head was persisted at construction"
        # the persisted chain from head is the queue
        cur = head
        while True:
            nxt = nvram.pread(cur + NEXT) or NULL
            if nxt == NULL:
                break
            cur = nxt
        nvram.pwrite(q.TAIL, cur)
        # reconstruct free lists: every area node not on the chain is free
        chain = set()
        c = head
        while c != NULL:
            chain.add(c)
            c = nvram.pread(c + NEXT) or NULL
        for base, nnodes in mem.area_addrs():
            for i in range(nnodes):
                a = base + i * LINE_WORDS
                if a not in chain:
                    mem.free_now(0, a)
        nvram.reset_after_recovery()
        return q
