"""IzraelevitzQ / NVTraverseQ -- general-transform baselines (paper §10).

Izraelevitz et al. (DISC'16): any linearizable lock-free object becomes
durably linearizable by persisting (flush + fence) after **every** access to
shared memory -- writes, CASes *and reads*.  Applied to MSQ this yields a
correct but fence-heavy queue; it is the paper's "many fences" baseline.

NVTraverseQ (Friedman et al., PLDI'20) is the same here except that flushes
issued after *reads and CASes* are not followed by their own fence (the next
update's fence covers them), since MSQ has an empty traversal phase.
"""
from __future__ import annotations

from typing import Any

from .nvram import LINE_WORDS, NVRAM
from .opsched import (AllocP, Cas, Fence, FifoLayout, Flush, L, OpSchedule,
                      QueueSchedules, Read, Retire, WriteLine)
from .queue_base import NULL, QueueAlgorithm, alloc_root_lines
from .ssmem import SSMem

ITEM, NEXT = 0, 1


class IzraelevitzQueue(QueueAlgorithm):
    NAME = "IzraelevitzQ"
    FENCE_AFTER_READ = True

    def __init__(self, nvram: NVRAM, mem: SSMem, nthreads: int, on_event=None,
                 _recovering: bool = False, roots=None):
        super().__init__(nvram, mem, nthreads, on_event)
        nv = self.nvram
        if roots is None:
            roots = alloc_root_lines(nv, 2, "izrq:roots")
        self.HEAD, self.TAIL = roots
        self.roots = roots
        if not _recovering:
            dummy = self.mem.alloc(0)
            nv.write_full_line(dummy, [None, NULL, 0, 0, 0, 0, 0, 0])
            nv.write(self.HEAD, dummy)
            nv.write(self.TAIL, dummy)
            self.pflush(dummy)
            self.pflush(self.HEAD)
            self.pflush(self.TAIL)
            self.pfence()

    # ---------------------------------------- steady-state schedule facts
    # The transform persists after EVERY shared access, so a retry replays
    # flush(+fence) per re-read and re-touches the lines those very
    # flushes invalidated -- the fence-heavy baseline is also the
    # retry-heavy one.  NVTraverseQ overrides this with the read/CAS-fail
    # fences elided (FENCE_AFTER_READ=False), mirroring the fast path.
    # Expected counts fit against the exact scheduler (a re-read is
    # post-flush only when no co-scheduled op re-fetched the line first).
    RETRY_SHAPES = {
        "enq": dict(flushed_reads=1.6, flushes=3, fences=3),
        "deq": dict(flushed_reads=3.2, flushes=5, fences=5),
    }

    def op_schedule(self):
        """Steady state: the general transform's persist-per-access
        schedule applied to MSQ (read/CAS-fail fences present iff
        ``FENCE_AFTER_READ``)."""
        far = self.FENCE_AFTER_READ

        def pread(loc):       # _pread: read + flush (+ fence)
            return (Read(loc), Flush(loc)) + ((Fence(),) if far else ())

        enq = OpSchedule("enq", steps=(
            AllocP(),
            WriteLine(L("new_p"), (None, NULL, 0, 0, 0, 0, 0, 0), item_at=0),
            Flush(L("new_p")), Fence(),
        ) + pread(L("TAIL")) + pread(L("tail_p", NEXT)) + (
            Cas(L("tail_p", NEXT), ("sym", "new_p"), event="enq"),
            Flush(L("tail_p", NEXT)), Fence(),
            Cas(L("TAIL"), ("sym", "new_p"), root=True),
            Flush(L("TAIL")), Fence(),
        ), retry_from=4)
        deq = OpSchedule("deq", steps=(
            pread(L("HEAD")) + pread(L("head_p", NEXT))
            + pread(L("TAIL")) + pread(L("next_p", ITEM)) + (
                Cas(L("HEAD"), ("sym", "next_p"), root=True, event="deq"),
                Flush(L("HEAD")), Fence(),
                Retire(("sym", "head_p")),
            )))
        return QueueSchedules(enq=enq, deq=deq, layout=FifoLayout(
            head_root="HEAD", next_off=NEXT, item_off=ITEM))

    # -- transformed accessors ---------------------------------------------
    def _pread(self, addr: int) -> Any:
        v = self.nvram.read(addr)
        self.pflush(addr)
        if self.FENCE_AFTER_READ:
            self.pfence()
        return v

    def _pwrite(self, addr: int, v: Any) -> None:
        self.nvram.write(addr, v)
        self.pflush(addr)
        self.pfence()

    def _pcas(self, addr: int, exp: Any, new: Any, ev=None) -> bool:
        ok = self.nvram.cas(addr, exp, new)
        if ok and ev is not None:
            self._ev(*ev)    # event exactly at the linearizing CAS
        self.pflush(addr)
        if self.FENCE_AFTER_READ or ok:
            self.pfence()
        return ok

    # ------------------------------------------------------------------ ops
    def enqueue(self, tid: int, item: Any) -> None:
        nv = self.nvram
        self.mem.op_begin(tid)
        node = self.mem.alloc(tid)
        nv.write_full_line(node, [item, NULL, 0, 0, 0, 0, 0, 0])
        self.pflush(node)
        self.pfence()
        while True:
            tail = self._pread(self.TAIL)
            nxt = self._pread(tail + NEXT)
            if nxt == NULL:
                if self._pcas(tail + NEXT, NULL, node, ev=("enq", item)):
                    self._pcas(self.TAIL, tail, node)
                    return
            else:
                self._pcas(self.TAIL, tail, nxt)

    def dequeue(self, tid: int) -> Any:
        self.mem.op_begin(tid)
        while True:
            head = self._pread(self.HEAD)
            nxt = self._pread(head + NEXT)
            if nxt == NULL:
                self._ev("empty")
                return None
            # MSQ guard: head must not overtake tail (reclamation safety)
            tail = self._pread(self.TAIL)
            if head == tail:
                self._pcas(self.TAIL, tail, nxt)
                continue
            item = self._pread(nxt + ITEM)
            if self._pcas(self.HEAD, head, nxt, ev=("deq", item)):
                self.mem.retire(tid, head)
                return item

    @classmethod
    def recover(cls, nvram: NVRAM, mem: SSMem, nthreads: int, roots,
                on_event=None):
        q = cls(nvram, mem, nthreads, on_event, _recovering=True, roots=roots)
        head = nvram.pread(q.HEAD) or NULL
        cur = head
        chain = {head}
        while True:
            nxt = nvram.pread(cur + NEXT) or NULL
            if nxt == NULL:
                break
            cur = nxt
            chain.add(cur)
        nvram.pwrite(q.TAIL, cur)
        for base, nnodes in mem.area_addrs():
            for i in range(nnodes):
                a = base + i * LINE_WORDS
                if a not in chain:
                    mem.free_now(0, a)
        nvram.reset_after_recovery()
        return q


class NVTraverseQueue(IzraelevitzQueue):
    NAME = "NVTraverseQ"
    FENCE_AFTER_READ = False

    RETRY_SHAPES = {
        "enq": dict(flushed_reads=2.5, flushes=3, weight=0.8),
        "deq": dict(flushed_reads=4, flushes=5, weight=0.8),
    }
