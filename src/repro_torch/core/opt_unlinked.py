"""OptUnlinkedQ -- second amendment of UnlinkedQ (paper §6.1, §6.3).

UnlinkedQ with **zero accesses to flushed content** while keeping the single
fence per operation:

* the global persisted head index becomes **per-thread head indices**, each
  on its own cache line, written with **non-temporal stores** (movnti) so the
  flushed-and-invalidated line is never fetched back; recovery takes the max;
* each node is split into a **Persistent** half (item, index, linked --
  flushed once by the enqueuer, then only ever read by recovery) and a
  **Volatile** half (item, index, next, pptr -- serves every fast-path read);
* the queue's head and tail point at Volatile halves, so dequeues CAS and
  read purely volatile memory; the only persistent-memory work in a dequeue
  is one movnti + one fence.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from .nvram import LINE_WORDS, NVRAM
from .opsched import (AllocP, AllocV, Cas, Fence, FifoLayout, Flush, L,
                      Movnti, OpSchedule, QueueSchedules, Read, Retire,
                      RetireV, Write, WriteLine)
from .queue_base import NULL, QueueAlgorithm
from .ssmem import SSMem, VolatileAlloc

# Persistent half (designated areas, one line)
P_ITEM, P_INDEX, P_LINKED = 0, 1, 2
# Volatile half
V_ITEM, V_INDEX, V_NEXT, V_PPTR = 0, 1, 2, 3
V_WORDS = 4


class OptUnlinkedQueue(QueueAlgorithm):
    NAME = "OptUnlinkedQ"

    def __init__(self, nvram: NVRAM, mem: SSMem, nthreads: int, on_event=None,
                 _recovering: bool = False, roots=None):
        super().__init__(nvram, mem, nthreads, on_event)
        nv = self.nvram
        self.valloc = VolatileAlloc(nvram, nthreads, V_WORDS, name="optunlq")
        mem.attach_volatile(self.valloc)
        if roots is None:
            # per-thread head-index slots, one line each, + a root line id
            hidx = nv.alloc_region(nthreads * LINE_WORDS, "optunlq:headidx")
            roots = [hidx]
            self.HEADIDX = hidx
        else:
            self.HEADIDX = roots[0]
        self.roots = roots
        # head/tail are volatile pointers to Volatile halves
        self.HEAD = nv.alloc_region(1, "optunlq:head", persistent=False)
        self.TAIL = nv.alloc_region(1, "optunlq:tail", persistent=False)
        if not _recovering:
            for t in range(nthreads):
                nv.movnti(self.HEADIDX + t * LINE_WORDS, 0)
            self.pfence()
            dummy_p = self.mem.alloc(0)
            nv.write_full_line(dummy_p, [None, 0, 0, 0, 0, 0, 0, 0])
            self.pflush(dummy_p)
            self.pfence()
            dummy_v = self._new_vnode(0, None, 0, dummy_p)
            nv.write(self.HEAD, dummy_v)
            nv.write(self.TAIL, dummy_v)

    def _new_vnode(self, tid: int, item: Any, idx: int, pptr: int) -> int:
        nv = self.nvram
        v = self.valloc.alloc(tid)
        nv.write(v + V_ITEM, item)
        nv.write(v + V_INDEX, idx)
        nv.write(v + V_NEXT, NULL)
        nv.write(v + V_PPTR, pptr)
        return v

    # ---------------------------------------- steady-state schedule facts
    # Second amendment: the fast path reads/CASes Volatile halves only, so
    # a retry is pure cached work -- zero flushed_reads (the schedule's
    # volatile-only retry body *proves* it: the contention model zeroes
    # any flushed-read claim).  Contended runs must preserve
    # post_flush_accesses == 0 (property-tested).
    RETRY_SHAPES = {
        "enq": dict(reads=3),
        "deq": dict(reads=4),
    }

    def op_schedule(self):
        """Steady state (§6.1, §6.3): enqueue flushes its Persistent half
        once (never read back); dequeue's only persistent-memory work is
        one movnti + one fence.  Zero accesses to flushed content."""
        enq = OpSchedule("enq", steps=(
            AllocP(),
            # linked unset before a meaningful index is visible (§5.1.1)
            WriteLine(L("new_p"), (None, 0, 0, 0, 0, 0, 0, 0), item_at=0),
            AllocV(),
            Write(L("new_v", V_ITEM), ("item",)),
            Write(L("new_v", V_INDEX), ("c", 0)),
            Write(L("new_v", V_NEXT), ("c", NULL)),
            Write(L("new_v", V_PPTR), ("sym", "new_p")),
            Read(L("TAIL")),
            Read(L("tail_v", V_NEXT)),
            Read(L("tail_v", V_INDEX)),       # VOLATILE tail: no post-flush
            Write(L("new_p", P_INDEX), ("idx",)),
            Write(L("new_v", V_INDEX), ("idx",)),
            Cas(L("tail_v", V_NEXT), ("sym", "new_v"), event="enq"),
            Write(L("new_p", P_LINKED), ("c", 1)),
            Flush(L("new_p")), Fence(),       # flushed once, never read
            Cas(L("TAIL"), ("sym", "new_v"), root=True),
        ), retry_from=7)
        deq = OpSchedule("deq", steps=(
            Read(L("HEAD")),
            Read(L("head_v", V_NEXT)),
            Read(L("TAIL")),                  # MSQ guard
            Read(L("next_v", V_ITEM)),
            Read(L("next_v", V_INDEX)),
            Cas(L("HEAD"), ("sym", "next_v"), root=True, event="deq"),
            # persist this thread's head index: movnti, never read back
            Movnti(L("HEADIDX", per_tid=True), ("idx",)),
            Fence(),                          # the ONE fence
            Read(L("head_v", V_PPTR)),
            Retire(("sym", "head_p")),        # both halves, epoch-protected
            RetireV(("sym", "head_v")),
        ))
        return QueueSchedules(enq=enq, deq=deq, layout=FifoLayout(
            head_root="HEAD", next_off=V_NEXT, item_off=V_ITEM,
            idx_off=V_INDEX, pptr_off=V_PPTR, volatile=True))

    # --------------------------------------------------------------- enqueue
    def enqueue(self, tid: int, item: Any) -> None:
        nv = self.nvram
        self.mem.op_begin(tid)
        pnode = self.mem.alloc(tid)
        # linked unset before a meaningful index is visible (§5.1.1 order);
        # full-line init avoids fetching a previously flushed line.
        nv.write_full_line(pnode, [item, 0, 0, 0, 0, 0, 0, 0])
        vnode = self._new_vnode(tid, item, 0, pnode)
        while True:
            tailv = nv.read(self.TAIL)
            if nv.read(tailv + V_NEXT) == NULL:
                # index read from the VOLATILE tail -- no post-flush access
                idx = nv.read(tailv + V_INDEX) + 1
                nv.write(pnode + P_INDEX, idx)
                nv.write(vnode + V_INDEX, idx)
                if nv.cas(tailv + V_NEXT, NULL, vnode):
                    self._ev("enq", item)
                    nv.write(pnode + P_LINKED, 1)
                    self.pflush(pnode)                  # flushed once, never read
                    self.pfence()                       # the ONE fence
                    nv.cas(self.TAIL, tailv, vnode)
                    return
            else:
                nv.cas(self.TAIL, tailv, nv.read(tailv + V_NEXT))

    # --------------------------------------------------------------- dequeue
    def dequeue(self, tid: int) -> Any:
        nv = self.nvram
        self.mem.op_begin(tid)
        while True:
            headv = nv.read(self.HEAD)
            nxt = nv.read(headv + V_NEXT)
            if nxt == NULL:
                # persist this thread's view of the head index (§6.3: movnti,
                # never read back) so prior dequeues that emptied the queue
                # are durable before we report empty.
                idx = nv.read(headv + V_INDEX)
                nv.movnti(self.HEADIDX + tid * LINE_WORDS, idx)
                self.pfence()
                self._ev("empty")
                return None
            # MSQ guard: head must not overtake tail (reclamation safety)
            tailv = nv.read(self.TAIL)
            if headv == tailv:
                nv.cas(self.TAIL, tailv, nxt)
                continue
            item = nv.read(nxt + V_ITEM)
            idx = nv.read(nxt + V_INDEX)
            if nv.cas(self.HEAD, headv, nxt):
                self._ev("deq", item)
                nv.movnti(self.HEADIDX + tid * LINE_WORDS, idx)
                self.pfence()                           # the ONE fence
                # retire both halves of the old dummy (epoch-protected)
                self.mem.retire(tid, nv.read(headv + V_PPTR))
                self.mem.retire_volatile(tid, headv)
                return item

    # -------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, nvram: NVRAM, mem: SSMem, nthreads: int, roots,
                on_event=None) -> "OptUnlinkedQueue":
        q = cls(nvram, mem, nthreads, on_event, _recovering=True, roots=roots)
        nv = nvram
        head_idx = max((nv.pread(q.HEADIDX + t * LINE_WORDS) or 0)
                       for t in range(nthreads))
        live: List[Tuple[int, int]] = []
        free: List[int] = []
        for base, nnodes in mem.area_addrs():
            for i in range(nnodes):
                a = base + i * LINE_WORDS
                if a == q.HEADIDX:   # head-index region is not an area
                    continue
                linked = nv.pread(a + P_LINKED)
                idx = nv.pread(a + P_INDEX) or 0
                if linked and idx > head_idx:
                    live.append((idx, a))
                else:
                    free.append(a)
        live.sort()
        # dummy Persistent with the recovered head index (§6.1)
        dummy_p = free.pop() if free else mem.alloc(0)
        nv.pwrite(dummy_p + P_ITEM, None)
        nv.pwrite(dummy_p + P_INDEX, head_idx)
        nv.pwrite(dummy_p + P_LINKED, 0)
        # per-thread indices stand as-is (max is unchanged); build Volatile twins
        dummy_v = q._new_vnode(0, None, head_idx, dummy_p)
        nv.write(q.HEAD, dummy_v)
        prev = dummy_v
        for idx, a in live:
            v = q._new_vnode(0, nv.pread(a + P_ITEM), idx, a)
            nv.write(prev + V_NEXT, v)
            prev = v
        nv.write(q.TAIL, prev)
        for a in free:
            mem.free_now(0, a)
        nvram.reset_after_recovery()
        return q
