"""LinkedQ -- first amendment, design #2 (paper §5.2).

Also one blocking fence per operation, via a completely different scheme:

* nodes carry an ``initialized`` validity flag; enqueue writes content first,
  flag second (same line, so Assumption 1 orders them in NVRAM without a
  fence); recovery trusts a node only if the flag is set in NVRAM;
* the flag must be *clear in NVRAM* before a node is reused.  Instead of an
  extra fence at allocation, a dequeuer clears the flag of its previously
  retired node and **piggybacks** the flag's flush on the fence its next
  successful dequeue performs anyway, returning the node to ssmem only after
  that fence;
* a backward ``pred`` link lets an enqueuer persist exactly the chain suffix
  that might not be durable yet: walk back flushing nodes until a node known
  persisted (volatile hint set), then issue the single fence;
* recovery walks the persisted ``next`` chain from the persisted head while
  ``initialized`` is set.
"""
from __future__ import annotations

from typing import Any, Set

from .nvram import LINE_WORDS, NVRAM
from .opsched import (AllocP, Cas, Fence, FifoLayout, Flush, L, OpSchedule,
                      PersistedAdd, PersistedDiscard, QueueSchedules, Read,
                      Retire, SlotSet, Write, WriteLine)
from .queue_base import NULL, QueueAlgorithm, alloc_root_lines
from .ssmem import SSMem

# persistent node layout (one cache line)
ITEM, NEXT, INIT, PRED = 0, 1, 2, 3


class LinkedQueue(QueueAlgorithm):
    NAME = "LinkedQ"

    def __init__(self, nvram: NVRAM, mem: SSMem, nthreads: int, on_event=None,
                 _recovering: bool = False, roots=None):
        super().__init__(nvram, mem, nthreads, on_event)
        nv = self.nvram
        if roots is None:
            roots = alloc_root_lines(nv, 2, "linkedq:roots")
        self.HEAD, self.TAIL = roots
        self.roots = roots
        # volatile helper state
        self._persisted: Set[int] = set()    # nodes known durable (hint)
        self._to_flush = [NULL] * nthreads   # flag cleared, flush pending
        if not _recovering:
            dummy = self.mem.alloc(0)
            nv.write_full_line(dummy, [None, NULL, 0, NULL, 0, 0, 0, 0])
            nv.write(self.HEAD, dummy)
            nv.write(self.TAIL, dummy)
            self.pflush(dummy)
            self.pflush(self.HEAD)
            self.pfence()
            self._persisted.add(dummy)

    # ---------------------------------------- steady-state schedule facts
    # Retries issue no flushes, so no new invalidations: the lines the
    # backward walk flushed are re-fetched once in the base accounting
    # and retries re-read them as hits (exact-scheduler flushed-access
    # totals stay flat).  LinkedQ's post-flush cost lives in the walk
    # itself, not in the CAS loop.
    RETRY_SHAPES = {
        "enq": dict(reads=2),
        "deq": dict(reads=4),
    }

    def op_schedule(self):
        """Steady state (§5.2): one fence per op.  The enqueue's backward
        walk covers exactly the new node plus the (already-durable) tail --
        a longer not-yet-durable suffix means a pending enqueue is still in
        flight, which op-granularity execution excludes; the
        ``tail_persisted`` guard bails to real execution otherwise.  The
        dequeue piggybacks the previously-retired node's flag flush on its
        own fence (``_to_flush`` slot; NULL on a thread's first dequeue --
        warmup bails)."""
        enq = OpSchedule("enq", steps=(
            AllocP(),
            PersistedDiscard("new_p"),      # recycled addr no longer durable
            WriteLine(L("new_p"), (None, NULL, 0, NULL, 0, 0, 0, 0),
                      item_at=0),
            Read(L("TAIL")),
            Read(L("tail_p", NEXT)),
            Write(L("new_p", PRED), ("sym", "tail_p")),
            Write(L("new_p", INIT), ("c", 1)),     # after content: Asm. 1
            Cas(L("tail_p", NEXT), ("sym", "new_p"), event="enq"),
            # backward-walk persist: the suffix [new node, durable tail]
            Read(L("new_p", PRED)),
            Flush(L("new_p")),
            Read(L("tail_p", PRED)),
            Flush(L("tail_p")),
            Fence(),                               # the ONE fence
            PersistedAdd("new_p", "tail_p"),
            Cas(L("TAIL"), ("sym", "new_p"), root=True),
        ), guards=(("tail_persisted",),), retry_from=3)
        deq = OpSchedule("deq", steps=(
            Read(L("HEAD")),
            Read(L("head_p", NEXT)),
            Read(L("TAIL")),                       # MSQ guard
            Read(L("next_p", ITEM)),
            Cas(L("HEAD"), ("sym", "next_p"), root=True, event="deq"),
            # piggyback protocol: clear the current head's flag now, flush
            # the previously retired node, one fence covers both
            Write(L("head_p", INIT), ("c", 0)),
            Flush(L("prev")),
            Flush(L("HEAD")),
            Fence(),                               # the ONE fence
            Retire(("sym", "prev")),
            SlotSet("_to_flush", ("sym", "head_p")),
        ), guards=(("slot_nonnull", "_to_flush"),))
        return QueueSchedules(enq=enq, deq=deq, layout=FifoLayout(
            head_root="HEAD", next_off=NEXT, item_off=ITEM))

    # --------------------------------------------------------------- enqueue
    def enqueue(self, tid: int, item: Any) -> None:
        nv = self.nvram
        self.mem.op_begin(tid)
        node = self.mem.alloc(tid)
        # a recycled address is no longer durable in its new incarnation;
        # evicting here (not at retire) keeps every non-persisted node on a
        # pred chain part of a *pending* enqueue, bounding backward walks.
        self._persisted.discard(node)
        # content first; `initialized` is set only after item/pred are written
        # (ssmem guarantees the flag is already clear in NVRAM on reuse).
        nv.write_full_line(node, [item, NULL, 0, NULL, 0, 0, 0, 0])
        while True:
            tail = nv.read(self.TAIL)
            if nv.read(tail + NEXT) == NULL:
                nv.write(node + PRED, tail)
                nv.write(node + INIT, 1)          # after content: Assumption 1
                if nv.cas(tail + NEXT, NULL, node):
                    self._ev("enq", item)
                    # Backward-walk persist: flush the not-yet-durable suffix
                    # INCLUDING the first durable node -- its line holds the
                    # next-pointer onto the suffix, which recovery follows.
                    # (Reads of pred on flushed lines are LinkedQ's post-flush
                    # cost, measured and eliminated by the 2nd amendment.)
                    walked = []
                    p = node
                    while True:
                        pred = nv.read(p + PRED)
                        self.pflush(p)
                        walked.append(p)
                        if p in self._persisted or pred == NULL:
                            break
                        p = pred
                    self.pfence()                     # the ONE fence
                    self._persisted.update(walked)
                    nv.cas(self.TAIL, tail, node)
                    return
            else:
                nv.cas(self.TAIL, tail, nv.read(tail + NEXT))

    # --------------------------------------------------------------- dequeue
    def dequeue(self, tid: int) -> Any:
        nv = self.nvram
        self.mem.op_begin(tid)
        while True:
            head = nv.read(self.HEAD)
            nxt = nv.read(head + NEXT)
            if nxt == NULL:
                self.pflush(self.HEAD)
                self.pfence()
                self._ev("empty")
                return None
            # MSQ guard: head must not overtake tail (reclamation safety)
            tail = nv.read(self.TAIL)
            if head == tail:
                nv.cas(self.TAIL, tail, nxt)
                continue
            item = nv.read(nxt + ITEM)
            if nv.cas(self.HEAD, head, nxt):
                self._ev("deq", item)
                # piggyback protocol (§5.2): clear the *current* retired
                # node's flag now; flush the *previous* one and let this
                # operation's single fence cover both the head and that flush;
                # only then hand the previous node back to ssmem.
                nv.write(head + INIT, 0)
                prev = self._to_flush[tid]
                if prev != NULL:
                    self.pflush(prev)
                self.pflush(self.HEAD)
                self.pfence()                         # the ONE fence
                if prev != NULL:
                    self.mem.retire(tid, prev)
                self._to_flush[tid] = head
                return item

    # -------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, nvram: NVRAM, mem: SSMem, nthreads: int, roots,
                on_event=None) -> "LinkedQueue":
        q = cls(nvram, mem, nthreads, on_event, _recovering=True, roots=roots)
        head = nvram.pread(q.HEAD) or NULL
        assert head != NULL
        # resurrect the path of consecutive initialized nodes from the head
        chain = [head]
        cur = head
        while True:
            nxt = nvram.pread(cur + NEXT) or NULL
            if nxt == NULL or not nvram.pread(nxt + INIT):
                break
            chain.append(nxt)
            cur = nxt
        nvram.pwrite(cur + NEXT, NULL)   # cut any stale suffix
        nvram.pwrite(q.TAIL, cur)
        nvram.pwrite(q.HEAD, head)
        chain_set = set(chain)
        for base, nnodes in mem.area_addrs():
            for i in range(nnodes):
                a = base + i * LINE_WORDS
                if a not in chain_set:
                    nvram.pwrite(a + INIT, 0)   # clear before reuse
                    mem.free_now(0, a)
        q._persisted.update(chain)
        nvram.reset_after_recovery()
        return q
