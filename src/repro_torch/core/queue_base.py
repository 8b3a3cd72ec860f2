"""Shared scaffolding for the durable queue implementations.

All queues expose the same interface::

    q = SomeQueue(nvram, mem, nthreads, on_event=cb)   # fresh, persisted init
    q.enqueue(tid, item)
    item = q.dequeue(tid)          # None == failing dequeue (empty)
    q2 = SomeQueue.recover(nvram, mem, nthreads, roots, on_event=cb)

``on_event`` receives volatile-linearization events -- ``("enq", item)`` at
the successful link CAS and ``("deq", item)`` at the successful head CAS --
which the harness uses for durable-linearizability checking (the scheduler
serializes primitives, so event order == linearization order).

NULL pointers are address 0 (reserved in the simulator).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .contention import RetryProfile
from .nvram import LINE_WORDS, NVRAM
from .opsched import (QueueSchedules, linearizing_root,
                      retry_touches_persistent)
from .ssmem import SSMem

NULL = 0
Event = Callable[[tuple], None]


class QueueAlgorithm:
    """Base class; concrete queues define NAME and the three operations."""

    NAME = "abstract"

    def __init__(self, nvram: NVRAM, mem: SSMem, nthreads: int,
                 on_event: Optional[Event] = None):
        self.nvram = nvram
        self.mem = mem
        self.nthreads = nthreads
        self.on_event = on_event or (lambda ev: None)

    # -- helpers ------------------------------------------------------------
    def _ev(self, *ev: Any) -> None:
        self.on_event(tuple(ev))

    # -- model-aware persist primitives -------------------------------------
    # All queues route their persistence path through these so the memory
    # model can elide work the platform does not need: under eADR
    # (persist-on-store) CLWB instructions are unnecessary and a tuned
    # implementation simply would not issue them.
    def pflush(self, addr: int) -> None:
        """Flush `addr`'s line iff the platform requires explicit flushes."""
        if self.nvram.model.needs_flush:
            self.nvram.flush(addr)

    def pfence(self) -> None:
        """Persist barrier (SFENCE); always issued -- it orders stores even
        on platforms where it no longer drains flush queues."""
        self.nvram.fence()

    def persist(self, addr: int) -> None:
        """flush + fence ('persisting a location'), model-aware."""
        self.pflush(addr)
        self.pfence()

    # -- steady-state schedule contract --------------------------------------
    # Class-level per-round retry shapes (see RetryProfile): numeric facts
    # only -- the contended root *addresses* are instance-specific and come
    # from op_schedule()'s root-marked CAS, so the numbers stay declarative.
    RETRY_SHAPES: Dict[str, Dict[str, float]] = {}

    def op_schedule(self) -> Optional[QueueSchedules]:
        """The queue's steady-state ops as typed primitive programs.

        Concrete queues return a :class:`repro.core.opsched.QueueSchedules`
        describing the exact reads, writes, CAS, model-aware pflush/pfence,
        movnti and allocator interactions of one successful steady-state
        enqueue and dequeue -- the same facts :meth:`retry_profile` and the
        B2 persist-count tables assert, as one source of truth.  Three
        consumers:

        * the batched scheduler's fast path compiles and replays it
          (:mod:`repro.core.opsched`), bailing to real execution for
          anything the program does not cover;
        * the contention layer locates each kind's CAS root and checks
          whether a retry can touch flushed content at all;
        * the equivalence suite pins the compiled replay bit-identical to
          per-op execution on every memory model.

        ``None`` (the default) opts the queue out of the fast path.
        """
        return None

    # -- contention contract -------------------------------------------------
    def retry_profile(self) -> Dict[str, RetryProfile]:
        """Per-op-kind shape of ONE failed CAS round, for the batched path.

        Returns ``{'enq': RetryProfile(...), 'deq': ...}``: which root word
        each kind's tracked CAS targets and the event codes a retry round
        replays -- cached re-reads, re-reads of *flushed* content (the
        post-flush cost a retry re-incurs), and any helping-path
        flush/fence work.  The batched scheduler's
        :class:`repro.core.contention.ContentionModel` charges these per
        modeled CAS failure; the exact scheduler ignores them (its retries
        execute for real).

        The default implementation combines the class-level
        ``RETRY_SHAPES`` numbers with root addresses resolved from
        :meth:`op_schedule` (the schedule's ``root=True`` CAS), so queues
        declare per-round costs once and never repeat address facts.  An
        empty dict (no shapes, no schedule) opts the queue out of
        contention modeling entirely.
        """
        scheds = self.op_schedule()
        if not self.RETRY_SHAPES or scheds is None:
            return {}
        return {
            kind: RetryProfile(
                root=linearizing_root(self, scheds.of_kind(kind)), **shape)
            for kind, shape in self.RETRY_SHAPES.items()
        }

    def schedule_facts(self) -> Dict[str, Dict[str, Any]]:
        """Contention-relevant facts derived from :meth:`op_schedule`:
        per op kind, the tracked root CAS address and whether a failed-CAS
        retry can touch persistent (flushable) content at all.  The
        :class:`repro.core.contention.ContentionModel` grounds every
        profile (hand-fit or learned) in these instead of trusting
        hand-maintained tables."""
        scheds = self.op_schedule()
        if scheds is None:
            return {}
        return {
            sched.kind: {
                "root": linearizing_root(self, sched),
                "flushable_retry": retry_touches_persistent(self, sched),
            }
            for sched in scheds
        }

    def enqueue(self, tid: int, item: Any) -> None:
        raise NotImplementedError

    def dequeue(self, tid: int) -> Any:
        raise NotImplementedError

    def drain(self, tid: int = 0) -> list:
        """Dequeue until empty (testing helper)."""
        out = []
        while True:
            it = self.dequeue(tid)
            if it is None:
                return out
            out.append(it)


def alloc_root_lines(nvram: NVRAM, n: int, name: str, persistent: bool = True) -> list:
    """n root words, each on its own cache line (no false sharing)."""
    base = nvram.alloc_region(n * LINE_WORDS, name=name, persistent=persistent)
    return [base + i * LINE_WORDS for i in range(n)]
