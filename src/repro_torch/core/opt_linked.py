"""OptLinkedQ -- second amendment of LinkedQ (paper §6.2, §6.3).

LinkedQ transformed to zero post-flush accesses with one fence per op:

* recovery is **reversed**: it walks *backward* ``pred`` links from
  per-thread last-enqueue records instead of forward ``next`` links from a
  flushed head -- forward links live only in the Volatile halves;
* node = Persistent{item, index, pred} + Volatile{copies + next + pptr};
  ``index`` is written *last* so (Assumption 1) a non-stale index certifies
  item/pred; recovery detects stale nodes by nonconsecutive indices;
* per-thread **head index** and **two last-enqueue records** (last and
  penultimate -- the penultimate enqueue's fence guarantees a fully durable
  chain) are written with movnti, never read on the fast path.  The
  penultimate record is written *before* the last one so any crash-time
  prefix of the line still exposes a valid completed candidate;
* recovery sorts candidates by index descending and takes the first from
  which a backward walk of consecutive indices reaches head-index + 1.
"""
from __future__ import annotations

from typing import Any, List, Set, Tuple

from .nvram import LINE_WORDS, NVRAM
from .opsched import (AllocP, AllocV, Cas, Fence, FifoLayout, Flush, L,
                      Movnti, OpSchedule, PersistedAdd, PersistedDiscard,
                      QueueSchedules, Read, Retire, RetireV, SlotSet, Write,
                      WriteLine)
from .queue_base import NULL, QueueAlgorithm
from .ssmem import SSMem, VolatileAlloc

# Persistent half (designated area line)
P_ITEM, P_INDEX, P_PRED = 0, 1, 2
# Volatile half
V_ITEM, V_INDEX, V_NEXT, V_PPTR, V_PREDV = 0, 1, 2, 3, 4
V_WORDS = 5
# per-thread record line: [pen_ptr, pen_idx, last_ptr, last_idx]
R_PEN_PTR, R_PEN_IDX, R_LAST_PTR, R_LAST_IDX = 0, 1, 2, 3


class OptLinkedQueue(QueueAlgorithm):
    NAME = "OptLinkedQ"

    def __init__(self, nvram: NVRAM, mem: SSMem, nthreads: int, on_event=None,
                 _recovering: bool = False, roots=None):
        super().__init__(nvram, mem, nthreads, on_event)
        nv = self.nvram
        self.valloc = VolatileAlloc(nvram, nthreads, V_WORDS, name="optlnq")
        mem.attach_volatile(self.valloc)
        if roots is None:
            hidx = nv.alloc_region(nthreads * LINE_WORDS, "optlnq:headidx")
            # +1 line: the recovery-written last-enqueue record
            le = nv.alloc_region((nthreads + 1) * LINE_WORDS, "optlnq:lastenq")
            roots = [hidx, le]
        self.HEADIDX, self.LASTENQ = roots
        self.roots = roots
        self.HEAD = nv.alloc_region(1, "optlnq:head", persistent=False)
        self.TAIL = nv.alloc_region(1, "optlnq:tail", persistent=False)
        # volatile helpers
        self._persisted: Set[int] = set()
        self._last: List[Tuple[int, int]] = [(NULL, 0)] * nthreads
        if not _recovering:
            for t in range(nthreads):
                nv.movnti(self.HEADIDX + t * LINE_WORDS, 0)
                self._write_record(t, (NULL, 0), (NULL, 0))
            self._write_record(nthreads, (NULL, 0), (NULL, 0))  # recovery slot
            dummy_p = self.mem.alloc(0)
            nv.write_full_line(dummy_p, [None, 0, NULL, 0, 0, 0, 0, 0])
            self.pflush(dummy_p)
            self.pfence()
            self._persisted.add(dummy_p)
            dummy_v = self._new_vnode(0, None, 0, dummy_p, NULL)
            nv.write(self.HEAD, dummy_v)
            nv.write(self.TAIL, dummy_v)

    # ---------------------------------------------------------------- helpers
    def _write_record(self, slot: int, pen: Tuple[int, int],
                      last: Tuple[int, int]) -> None:
        """movnti the per-thread record; penultimate BEFORE last (see module
        docstring -- crash-prefix then always exposes a completed candidate)."""
        nv = self.nvram
        base = self.LASTENQ + slot * LINE_WORDS
        nv.movnti(base + R_PEN_PTR, pen[0])
        nv.movnti(base + R_PEN_IDX, pen[1])
        nv.movnti(base + R_LAST_PTR, last[0])
        nv.movnti(base + R_LAST_IDX, last[1])

    def _new_vnode(self, tid: int, item: Any, idx: int, pptr: int,
                   predv: int) -> int:
        nv = self.nvram
        v = self.valloc.alloc(tid)
        nv.write(v + V_ITEM, item)
        nv.write(v + V_INDEX, idx)
        nv.write(v + V_NEXT, NULL)
        nv.write(v + V_PPTR, pptr)
        nv.write(v + V_PREDV, predv)
        return v

    # ---------------------------------------- steady-state schedule facts
    # Second amendment: retries re-read Volatile halves only (index, pred
    # pointer, next) -- zero flushed_reads (the volatile-only retry body
    # in the schedule proves it), so contended runs keep
    # post_flush_accesses == 0 (property-tested).
    RETRY_SHAPES = {
        "enq": dict(reads=4),
        "deq": dict(reads=4),
    }

    def op_schedule(self):
        """Steady state (§6.2, §6.3): the enqueue's backward flush walk
        covers exactly its own Persistent half (the tail's is already
        durable -- ``tail_persisted`` bails otherwise), then movnti-writes
        the per-thread last-enqueue record (penultimate before last) and
        issues the single fence.  Dequeue mirrors OptUnlinkedQ."""
        enq = OpSchedule("enq", steps=(
            AllocP(),
            PersistedDiscard("new_p"),   # recycled addr: durable-hint evict
            WriteLine(L("new_p"), (None, 0, NULL, 0, 0, 0, 0, 0), item_at=0),
            AllocV(),
            Write(L("new_v", V_ITEM), ("item",)),
            Write(L("new_v", V_INDEX), ("c", 0)),
            Write(L("new_v", V_NEXT), ("c", NULL)),
            Write(L("new_v", V_PPTR), ("sym", "new_p")),
            Write(L("new_v", V_PREDV), ("c", NULL)),
            Read(L("TAIL")),
            Read(L("tail_v", V_NEXT)),
            Read(L("tail_v", V_INDEX)),        # volatile reads only
            Read(L("tail_v", V_PPTR)),
            Write(L("new_p", P_PRED), ("sym", "tail_p")),
            Write(L("new_p", P_INDEX), ("idx",)),     # index LAST
            Write(L("new_v", V_INDEX), ("idx",)),
            Write(L("new_v", V_PREDV), ("sym", "tail_v")),
            Cas(L("tail_v", V_NEXT), ("sym", "new_v"), event="enq"),
            # backward flush walk over the volatile chain: own pnode, then
            # stop at the durable tail (flush reads nothing back)
            Read(L("new_v", V_PPTR)),
            Flush(L("new_p")),
            Read(L("new_v", V_PREDV)),
            Read(L("tail_v", V_PPTR)),
            # per-thread record: penultimate BEFORE last (crash-prefix
            # safety), all movnti -- never read on the fast path
            Movnti(L("LASTENQ", R_PEN_PTR, per_tid=True),
                   ("slot", "_last", 0)),
            Movnti(L("LASTENQ", R_PEN_IDX, per_tid=True),
                   ("slot", "_last", 1)),
            Movnti(L("LASTENQ", R_LAST_PTR, per_tid=True), ("sym", "new_p")),
            Movnti(L("LASTENQ", R_LAST_IDX, per_tid=True), ("idx",)),
            Fence(),                            # the ONE fence
            PersistedAdd("new_p"),
            SlotSet("_last", ("tup", ("sym", "new_p"), ("idx",))),
            Cas(L("TAIL"), ("sym", "new_v"), root=True),
        ), guards=(("tail_persisted",),), retry_from=9)
        deq = OpSchedule("deq", steps=(
            Read(L("HEAD")),
            Read(L("head_v", V_NEXT)),
            Read(L("TAIL")),                    # MSQ guard
            Read(L("next_v", V_ITEM)),
            Read(L("next_v", V_INDEX)),
            Cas(L("HEAD"), ("sym", "next_v"), root=True, event="deq"),
            Movnti(L("HEADIDX", per_tid=True), ("idx",)),
            Fence(),                            # the ONE fence
            Read(L("head_v", V_PPTR)),
            Retire(("sym", "head_p")),
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
        # evict recycled addresses from the durable-hint set at *alloc* time
        # (see linked.py: bounds the backward walk to pending enqueues)
        self._persisted.discard(pnode)
        nv.write_full_line(pnode, [item, 0, NULL, 0, 0, 0, 0, 0])
        vnode = self._new_vnode(tid, item, 0, pnode, NULL)
        while True:
            tailv = nv.read(self.TAIL)
            if nv.read(tailv + V_NEXT) == NULL:
                idx = nv.read(tailv + V_INDEX) + 1       # volatile read
                predp = nv.read(tailv + V_PPTR)          # volatile read
                nv.write(pnode + P_PRED, predp)
                nv.write(pnode + P_INDEX, idx)           # index LAST
                nv.write(vnode + V_INDEX, idx)
                nv.write(vnode + V_PREDV, tailv)
                if nv.cas(tailv + V_NEXT, NULL, vnode):
                    self._ev("enq", item)
                    # backward flush walk over the volatile chain, flushing
                    # Persistent halves only (flush reads nothing back).
                    walked = []
                    pv = vnode
                    while pv != NULL:
                        pp = nv.read(pv + V_PPTR)
                        if pp in self._persisted:
                            break
                        self.pflush(pp)
                        walked.append(pp)
                        pv = nv.read(pv + V_PREDV)
                    self._write_record(tid, self._last[tid], (pnode, idx))
                    self.pfence()                           # the ONE fence
                    self._persisted.update(walked)
                    self._last[tid] = (pnode, idx)
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
                self.pfence()                               # the ONE fence
                pp = nv.read(headv + V_PPTR)
                self.mem.retire(tid, pp)
                self.mem.retire_volatile(tid, headv)
                return item

    # -------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, nvram: NVRAM, mem: SSMem, nthreads: int, roots,
                on_event=None) -> "OptLinkedQueue":
        q = cls(nvram, mem, nthreads, on_event, _recovering=True, roots=roots)
        nv = nvram
        head_idx = max((nv.pread(q.HEADIDX + t * LINE_WORDS) or 0)
                       for t in range(nthreads))
        # gather candidates: two records per thread + the recovery slot
        cands: List[Tuple[int, int]] = []
        for slot in range(nthreads + 1):
            base = q.LASTENQ + slot * LINE_WORDS
            for (p_off, i_off) in ((R_LAST_PTR, R_LAST_IDX),
                                   (R_PEN_PTR, R_PEN_IDX)):
                ptr = nv.pread(base + p_off) or NULL
                idx = nv.pread(base + i_off) or 0
                if ptr != NULL and idx > head_idx:
                    cands.append((idx, ptr))
        cands.sort(reverse=True)
        chain: List[Tuple[int, int]] = []   # ascending (idx, pnode)
        for (idx, ptr) in cands:
            if nv.pread(ptr + P_INDEX) != idx:
                continue                     # stale node -- next candidate
            walk = [(idx, ptr)]
            cur, curidx, ok = ptr, idx, True
            while curidx > head_idx + 1:
                prev = nv.pread(cur + P_PRED) or NULL
                if prev == NULL or nv.pread(prev + P_INDEX) != curidx - 1:
                    ok = False               # nonconsecutive => stale
                    break
                curidx -= 1
                cur = prev
                walk.append((curidx, cur))
            if ok:
                chain = list(reversed(walk))
                break
        live = {p for (_, p) in chain}
        free = []
        for base, nnodes in mem.area_addrs():
            for i in range(nnodes):
                a = base + i * LINE_WORDS
                if a not in live:
                    free.append(a)
        # dummy Persistent at head_idx
        dummy_p = free.pop() if free else mem.alloc(0)
        nv.pwrite(dummy_p + P_ITEM, None)
        nv.pwrite(dummy_p + P_INDEX, head_idx)
        nv.pwrite(dummy_p + P_PRED, NULL)
        q._persisted.add(dummy_p)
        dummy_v = q._new_vnode(0, None, head_idx, dummy_p, NULL)
        nv.write(q.HEAD, dummy_v)
        prevv = dummy_v
        for (idx, p) in chain:
            v = q._new_vnode(0, nv.pread(p + P_ITEM), idx, p, prevv)
            nv.write(prevv + V_NEXT, v)
            q._persisted.add(p)
            prevv = v
        nv.write(q.TAIL, prevv)
        # reset records: stale slots cleared; the recovery slot republishes
        # the recovered tail as the durable candidate for a future crash.
        for t in range(nthreads):
            base = q.LASTENQ + t * LINE_WORDS
            for off in range(4):
                nv.pwrite(base + off, NULL if off % 2 == 0 else 0)
        rbase = q.LASTENQ + nthreads * LINE_WORDS
        if chain:
            tail_idx, tail_p = chain[-1]
            nv.pwrite(rbase + R_PEN_PTR, tail_p)
            nv.pwrite(rbase + R_PEN_IDX, tail_idx)
            nv.pwrite(rbase + R_LAST_PTR, tail_p)
            nv.pwrite(rbase + R_LAST_IDX, tail_idx)
        else:
            for off in range(4):
                nv.pwrite(rbase + off, NULL if off % 2 == 0 else 0)
        for a in free:
            mem.free_now(0, a)
        nvram.reset_after_recovery()
        return q
