"""UnlinkedQ -- first amendment, design #1 (paper §5.1, Figure 1).

One blocking fence per operation (meets the Cohen et al. lower bound).  Node
links are *not* persisted; recovery identifies queue nodes by scanning the
designated allocation areas for nodes with a set ``linked`` flag and an
``index`` larger than the persisted head index, then orders them by index.

The head is a double-width ``(ptr, index)`` word updated with DWCAS; a
dequeue persists the head's *index* (its whole line, of course) with one
flush+fence.  The enqueue persists the fully-initialized node with one
flush+fence after the link CAS succeeds; Assumption 1 (same-line store order
is preserved) makes ``linked=True`` reach NVRAM only after item/index.

This queue deliberately *does* access flushed content -- reading
``tail->index`` (flushed by the previous enqueuer), the dequeued node's
``item``/``index``, and the head line after its own flush -- which is exactly
the cost the second amendment removes.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from .nvram import LINE_WORDS, NVRAM
from .opsched import (AllocP, Cas, Fence, FifoLayout, Flush, L, OpSchedule,
                      QueueSchedules, Read, Retire, SlotSet, Write,
                      WriteLine)
from .queue_base import NULL, QueueAlgorithm, alloc_root_lines
from .ssmem import SSMem

# persistent node layout (one cache line): Figure 1's class Node
ITEM, NEXT, LINKED, INDEX = 0, 1, 2, 3


class UnlinkedQueue(QueueAlgorithm):
    NAME = "UnlinkedQ"

    def __init__(self, nvram: NVRAM, mem: SSMem, nthreads: int, on_event=None,
                 _recovering: bool = False, roots=None):
        super().__init__(nvram, mem, nthreads, on_event)
        nv = self.nvram
        if roots is None:
            roots = alloc_root_lines(nv, 2, "unlinkedq:roots")
        self.HEAD, self.TAIL = roots       # HEAD holds a (ptr, index) tuple
        self.roots = roots
        self.node_to_retire = [NULL] * nthreads   # volatile, Figure 1
        if not _recovering:
            dummy = self.mem.alloc(0)
            # dummy: linked=0 so recovery never resurrects it; index=0
            nv.write_full_line(dummy, [None, NULL, 0, 0, 0, 0, 0, 0])
            nv.write(self.HEAD, (dummy, 0))
            nv.write(self.TAIL, dummy)
            self.pflush(self.HEAD)
            self.pfence()

    # ---------------------------------------- steady-state schedule facts
    # Retries issue no flushes of their own, so they add no NEW line
    # invalidations: the flushed tail/head node lines are re-fetched
    # once (charged to whichever op touches them first -- already in the
    # base accounting) and a retry re-reads them as plain hits.  The
    # exact scheduler confirms flushed-access totals stay flat here.
    RETRY_SHAPES = {
        "enq": dict(reads=3),
        "deq": dict(reads=4),
    }

    def op_schedule(self):
        """Steady state (Figure 1): one fence per op; the enqueue reads the
        flushed tail node's index (post-flush), the dequeue reads the
        flushed node content and its own flushed head line."""
        enq = OpSchedule("enq", steps=(
            AllocP(),                                          # Line 21
            WriteLine(L("new_p"), (None, NULL, 0, 0, 0, 0, 0, 0),
                      item_at=0),                              # Lines 22-24
            Read(L("TAIL")),                                   # Line 26
            Read(L("tail_p", NEXT)),                           # Line 27
            Read(L("tail_p", INDEX)),                          # Line 28 (rhs)
            Write(L("new_p", INDEX), ("idx",)),                # Line 28
            Cas(L("tail_p", NEXT), ("sym", "new_p"),
                event="enq"),                                  # Line 29
            Write(L("new_p", LINKED), ("c", 1)),               # Line 30
            Flush(L("new_p")), Fence(),                        # the ONE fence
            Cas(L("TAIL"), ("sym", "new_p"), root=True),       # Line 32
        ), retry_from=2)
        deq = OpSchedule("deq", steps=(
            Read(L("HEAD")),                                   # Line 8
            Read(L("head_p", NEXT)),                           # Line 9
            Read(L("TAIL")),                                   # MSQ guard
            Read(L("next_p", INDEX)),                          # Line 13
            Read(L("next_p", ITEM)),                           # Line 14
            Cas(L("HEAD"), ("tup", ("sym", "next_p"), ("idx",)),
                root=True, event="deq"),                       # DWCAS
            Flush(L("HEAD")), Fence(),                         # the ONE fence
            Retire(("sym", "prev")),                           # Lines 16-17
            SlotSet("node_to_retire", ("sym", "head_p")),      # Line 18
        ), guards=(("slot_nonnull", "node_to_retire"),))
        return QueueSchedules(enq=enq, deq=deq, layout=FifoLayout(
            head_root="HEAD", next_off=NEXT, item_off=ITEM, idx_off=INDEX,
            head_is_tuple=True))

    # --------------------------------------------------------------- enqueue
    def enqueue(self, tid: int, item: Any) -> None:
        nv = self.nvram
        self.mem.op_begin(tid)
        node = self.mem.alloc(tid)                        # Line 21
        # full-line init: item, next=NULL, linked=false (Lines 22-24)
        nv.write_full_line(node, [item, NULL, 0, 0, 0, 0, 0, 0])
        while True:
            tail = nv.read(self.TAIL)                     # Line 26
            if nv.read(tail + NEXT) == NULL:              # Line 27
                # Line 28: reads the flushed tail node's line (post-flush!)
                nv.write(node + INDEX, nv.read(tail + INDEX) + 1)
                if nv.cas(tail + NEXT, NULL, node):       # Line 29
                    self._ev("enq", item)
                    nv.write(node + LINKED, 1)            # Line 30
                    self.pflush(node)                        # Line 31
                    self.pfence()                            # the ONE fence
                    nv.cas(self.TAIL, tail, node)         # Line 32
                    return
            else:
                nv.cas(self.TAIL, tail, nv.read(tail + NEXT))   # Line 34

    # --------------------------------------------------------------- dequeue
    def dequeue(self, tid: int) -> Any:
        nv = self.nvram
        self.mem.op_begin(tid)
        while True:
            head = nv.read(self.HEAD)                     # Line 8: (ptr, idx)
            head_ptr, _head_idx = head
            head_next = nv.read(head_ptr + NEXT)          # Line 9
            if head_next == NULL:                         # Line 10
                self.pflush(self.HEAD)                       # Line 11
                self.pfence()
                self._ev("empty")
                return None                               # Line 12
            # MSQ guard: head must not overtake tail (reclamation safety)
            tail = nv.read(self.TAIL)
            if head_ptr == tail:
                nv.cas(self.TAIL, tail, head_next)
                continue
            # Line 13: DWCAS to (next, next->index) -- reads flushed node
            nidx = nv.read(head_next + INDEX)
            item = nv.read(head_next + ITEM)              # Line 14
            if nv.cas(self.HEAD, head, (head_next, nidx)):
                self._ev("deq", item)
                self.pflush(self.HEAD)                       # Line 15
                self.pfence()                                # the ONE fence
                if self.node_to_retire[tid] != NULL:      # Lines 16-17
                    self.mem.retire(tid, self.node_to_retire[tid])
                self.node_to_retire[tid] = head_ptr       # Line 18
                return item                               # Line 19

    # -------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, nvram: NVRAM, mem: SSMem, nthreads: int, roots,
                on_event=None) -> "UnlinkedQueue":
        q = cls(nvram, mem, nthreads, on_event, _recovering=True, roots=roots)
        head_val = nvram.pread(q.HEAD)
        head_idx = head_val[1] if isinstance(head_val, tuple) else 0
        # scan designated areas for linked nodes with index > head_idx (§5.1.3)
        live: List[Tuple[int, int]] = []
        free: List[int] = []
        for base, nnodes in mem.area_addrs():
            for i in range(nnodes):
                a = base + i * LINE_WORDS
                linked = nvram.pread(a + LINKED)
                idx = nvram.pread(a + INDEX) or 0
                if linked and idx > head_idx:
                    live.append((idx, a))
                else:
                    free.append(a)
        live.sort()
        # fresh dummy with the head's index
        dummy = free.pop() if free else mem.alloc(0)
        nvram.pwrite(dummy + ITEM, None)
        nvram.pwrite(dummy + LINKED, 0)
        nvram.pwrite(dummy + INDEX, head_idx)
        nvram.pwrite(dummy + NEXT, NULL)
        # stitch next pointers in index order (links are volatile-only data,
        # but recovery writes them straight into the persistent image)
        prev = dummy
        for idx, a in live:
            nvram.pwrite(prev + NEXT, a)
            prev = a
        nvram.pwrite(prev + NEXT, NULL)
        nvram.pwrite(q.HEAD, (dummy, head_idx))
        nvram.pwrite(q.TAIL, prev)
        for a in free:
            mem.free_now(0, a)
        nvram.reset_after_recovery()
        return q
