"""Test/benchmark harness: workloads, crash injection, durable-linearizability
checking for the queue family.

:class:`QueueHarness` owns one engine + allocator + queue instance and runs
op plans over it three ways: :meth:`QueueHarness.run_single` (sequential,
the differential-oracle path), :meth:`QueueHarness.run_scheduled` (exact
per-primitive OS-thread scheduler -- crash injection and linearizability
model checking), and :meth:`QueueHarness.run_batched` (clock-driven
op-granularity executor -- the throughput path, optionally with a
:class:`repro.core.contention.ContentionModel` charging CAS-retry/helping
costs for co-scheduled ops).  See docs/architecture.md for how the engines,
schedulers and the contention layer fit together.

The checker implements the paper's correctness criterion (§3.2, §7): a
post-crash recovered state is durably linearizable iff the history with the
crash removed is linearizable.  For a FIFO queue with uniquely-tagged items
and a serialized (scheduler-ordered) event log this reduces to:

* let L  = items in volatile-linearization (link CAS) order,
* let Ec = items whose enqueue *completed* (returned before the crash),
* let Dc = items returned by *completed* successful dequeues,
* the recovered queue R is valid iff there is a way to drop a subset of
  *pending* enqueues' items from L (completed ones may not be dropped) such
  that R equals the remaining sequence minus a removed *prefix*, where the
  removed prefix contains every item of Dc and removes a completed-enqueue
  item only if it is in Dc or its removal is attributable to a pending
  dequeue (at most |pending dequeues| such extra removals).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Type, Union

from .contention import ContentionModel
from .memmodel import MemoryModel
from .nvram import NVRAM, Stats
from .opsched import FastPathExecutor
from .records import EventsView, OpRecord, OpsView, RecordStore
from .scheduler import ClockScheduler, Scheduler
from .ssmem import SSMem
from .queue_base import QueueAlgorithm
from .msq import MSQueue
from .durable_msq import DurableMSQueue
from .izraelevitz import IzraelevitzQueue, NVTraverseQueue
from .unlinked import UnlinkedQueue
from .linked import LinkedQueue
from .opt_unlinked import OptUnlinkedQueue
from .opt_linked import OptLinkedQueue

ALL_QUEUES: Dict[str, Type[QueueAlgorithm]] = {
    q.NAME: q for q in (MSQueue, DurableMSQueue, IzraelevitzQueue,
                        NVTraverseQueue, UnlinkedQueue, LinkedQueue,
                        OptUnlinkedQueue, OptLinkedQueue)
}
DURABLE_QUEUES = {k: v for k, v in ALL_QUEUES.items() if k != "MSQ"}


# OpRecord lives in repro.core.records (the columnar store materializes
# them on demand); importing it here keeps the historical
# ``repro.core.harness.OpRecord`` import path working.


@dataclass
class RunResult:
    crashed: bool
    ops: List[OpRecord]          # list (legacy mode) or live OpsView
    events: List[tuple]          # serialized volatile-linearization events
    stats: Stats
    ops_completed: int
    sim_time_ns: float

    def throughput_mops(self) -> float:
        if self.sim_time_ns <= 0:
            return 0.0
        return self.ops_completed / (self.sim_time_ns / 1e9) / 1e6


class QueueHarness:
    """Owns an NVRAM + SSMem + queue instance and runs workloads over it.

    ``model`` selects the persistence platform (a name from
    :data:`repro.core.memmodel.MEMORY_MODELS` or a MemoryModel instance);
    ``nvram_cls`` selects the engine -- the batched array engine
    (:class:`repro.core.nvram.NVRAM`, default) or the sequential reference
    (:class:`repro.core.nvram_ref.ReferenceNVRAM`) used as a differential
    oracle.

    ``records`` selects the op/event bookkeeping: ``"columnar"`` (default)
    routes everything through a :class:`repro.core.records.RecordStore`
    (``self.ops`` / ``self.events`` become live views over its columns;
    compiled fast-path ops stage three scalars each and materialize in
    vector bursts); ``"legacy"`` keeps the original plain Python lists of
    :class:`~repro.core.records.OpRecord` / event tuples as the
    differential reference (``tests/test_columnar_equivalence.py`` pins
    the two bit-identical).
    """

    def __init__(self, queue_cls: Type[QueueAlgorithm], nthreads: int,
                 area_nodes: int = 4096,
                 model: Union[str, MemoryModel, None] = None,
                 nvram_cls: Type = NVRAM, records: str = "columnar"):
        self.queue_cls = queue_cls
        self.nthreads = nthreads
        self.nvram = nvram_cls(nthreads, model=model)
        self.mem = SSMem(self.nvram, nthreads, area_nodes=area_nodes)
        if records == "columnar":
            self._rstore: Optional[RecordStore] = RecordStore(nthreads)
            self._ops = OpsView(self._rstore)
            self._events = EventsView(self._rstore)
        elif records == "legacy":
            self._rstore = None
            self._ops: List[OpRecord] = []
            self._events: List[tuple] = []
        else:
            raise ValueError(
                f"records must be 'columnar' or 'legacy', got {records!r}")
        self.records = records
        self.queue = queue_cls(self.nvram, self.mem, nthreads,
                               on_event=self._events.append)
        self.contention: Optional[ContentionModel] = None   # last run_batched
        self.fast: Optional[FastPathExecutor] = None        # last run_batched
        self.last_scheduler: Optional[Scheduler] = None     # last run_scheduled
        self._trace = None            # active repro.trace recorder, if any

    # ------------------------------------------------------------ record state
    @property
    def ops(self):
        """Op records: a plain list (legacy mode) or a live
        :class:`repro.core.records.OpsView` over the columnar store."""
        return self._ops

    @ops.setter
    def ops(self, value) -> None:
        if self._rstore is not None:
            self._rstore.reset_ops(value)
        else:
            self._ops = value

    @property
    def events(self):
        """Serialized events: a plain list (legacy mode) or a live
        :class:`repro.core.records.EventsView` over the columnar store."""
        return self._events

    @events.setter
    def events(self, value) -> None:
        if self._rstore is not None:
            rs = self._rstore
            rs.clear_events()
            for ev in value:
                rs.append_event(ev)
        else:
            self._events = value

    def _completed_count(self) -> int:
        if self._rstore is not None:
            return self._rstore.completed_count()
        return sum(1 for r in self._ops if r.completed)

    def record_snapshot(self):
        """Cursor snapshot of the op/event history, paired with
        :meth:`NVRAM.snapshot` at crash-sweep boundaries: ``(n_ops,
        n_events)`` in both record modes (the columnar store's cursors ARE
        its snapshot; see :meth:`repro.core.records.RecordStore.snapshot`)."""
        if self._rstore is not None:
            return self._rstore.snapshot()
        return (len(self._ops), len(self._events))

    def record_restore(self, snap) -> None:
        """Truncate the op/event history back to a :meth:`record_snapshot`
        (records only shrink: a snapshot cannot resurrect rows dropped by a
        later restore)."""
        if self._rstore is not None:
            self._rstore.restore(snap)
        else:
            n_ops, n_events = snap
            if n_ops > len(self._ops) or n_events > len(self._events):
                raise ValueError(
                    f"record_restore past live history: {snap!r} vs "
                    f"({len(self._ops)}, {len(self._events)})")
            del self._ops[n_ops:]
            del self._events[n_events:]

    # ------------------------------------------------------------- workloads
    def make_worker(self, tid: int, plan: List[Tuple[str, Any]]):
        """plan: list of ('enq', item) / ('deq', None) steps."""
        def run(_tid: int):
            for kind, item in plan:
                self._make_op(tid, kind, item)()
        return run

    def _trace_begin(self, trace, nthreads: int, seed: Optional[int],
                     scheduler: str) -> None:
        if trace is None:
            return
        trace.attach(self.nvram, meta={
            "queue": self.queue_cls.NAME, "model": self.nvram.model.name,
            "nthreads": nthreads, "seed": seed, "scheduler": scheduler})
        self._trace = trace

    def _trace_end(self, trace) -> None:
        if trace is not None:
            trace.finish(regions=self.nvram.regions)
            self._trace = None

    def run_scheduled(self, plans: List[List[Tuple[str, Any]]], seed: int = 0,
                      crash_at: Optional[int] = None,
                      policy: str = "random", trace=None,
                      snapshot_hook=None) -> RunResult:
        """Exact per-primitive OS-thread scheduler run.  ``trace`` attaches a
        :class:`repro.trace.TraceRecorder` for the duration of the run: the
        engine tap records every primitive (with scheduler step indices) and
        the harness marks op boundaries; Stats are unaffected.

        ``snapshot_hook(step)`` is forwarded to the :class:`Scheduler`: it
        fires at every quiescent boundary (see the scheduler docs) -- the
        crash sweep uses it to capture one :class:`repro.core.nvram.NVRAM`
        snapshot per step.  The scheduler itself stays reachable afterwards
        as ``self.last_scheduler`` (step totals, grant kinds)."""
        sched = Scheduler(self.nvram, seed=seed, policy=policy,
                          crash_at=crash_at, snapshot_hook=snapshot_hook)
        self.last_scheduler = sched
        workers = [self.make_worker(t, plans[t]) for t in range(len(plans))]
        self._trace_begin(trace, len(plans), seed, "exact")
        try:
            crashed = sched.run(workers)
        finally:
            self._trace_end(trace)
        done = self._completed_count()
        return RunResult(crashed=crashed, ops=self.ops, events=self.events,
                         stats=self.nvram.total_stats(), ops_completed=done,
                         sim_time_ns=self.nvram.sim_time_ns())

    def run_single(self, plan: List[Tuple[str, Any]],
                   trace=None) -> RunResult:
        """No scheduler: sequential single-thread execution (tid 0)."""
        self.nvram.set_tid(0)
        w = self.make_worker(0, plan)
        self._trace_begin(trace, 1, None, "single")
        try:
            w(0)
        finally:
            self._trace_end(trace)
        done = self._completed_count()
        return RunResult(crashed=False, ops=self.ops, events=self.events,
                         stats=self.nvram.total_stats(), ops_completed=done,
                         sim_time_ns=self.nvram.sim_time_ns())

    def run_batched(self, plans: List[List[Tuple[str, Any]]],
                    contention: Union[ContentionModel, bool, None] = None,
                    trace=None, compiled: Optional[bool] = None,
                    pause_gc: bool = True, profile=None,
                    burst=None) -> RunResult:
        """Clock-driven op-granularity execution: no OS threads, no yield
        points.  This is the throughput path -- hundreds of thousands of
        ops across 1..64+ threads are practical (the exact scheduler caps
        out around 60 ops/thread).  The schedule is deterministic (see
        ClockScheduler); interleavings vary only through the plans.

        ``compiled`` controls the schedule-compiler fast path
        (:mod:`repro.core.opsched`): by default steady-state ops replay
        their compiled schedules (~10x+ faster per op) and everything else
        bails to real per-primitive execution; Stats are bit-identical
        either way (the fast-path equivalence suite is the gate).  Pass
        ``compiled=False`` to force per-op execution -- the reference
        behavior the equivalence tests compare against.  The fast path is
        disabled automatically when a trace recorder is attached (traces
        record real primitives) or on the reference engine.

        ``contention`` attaches a CAS-contention model to the clock windows:
        pass a configured :class:`repro.core.contention.ContentionModel`, or
        ``True`` for the calibrated default.  Retry/helping costs are charged
        per the queue's :meth:`retry_profile`; with one thread (or
        ``retry_scale=0``) the counts are bit-identical to the uncontended
        run.  Crash injection is not supported here; use
        :meth:`run_scheduled` for crash/linearizability studies.

        ``profile`` attaches an observation-only phase profiler (e.g.
        :class:`repro.obs.PhaseProfiler`): the whole call runs under a
        ``bookkeeping`` phase, with the scheduler loop, op bodies, bails
        and record-charging nested inside (see ``benchmarks/run.py
        profile``).  Stats stay bit-identical; None (the default) leaves
        every hot path untouched.

        ``burst`` opts the run into the burst executor
        (:mod:`repro.core.burst`): whole multi-thread clock-heap bursts
        predicted and applied as array programs, mispredicted bursts
        replayed through the merged columnar runner.  ``True`` uses the
        defaults, a dict passes :class:`~repro.core.burst.BurstExecutor`
        options through (``window``, ``min_ops``, ``max_fixpoint_iters``,
        ``force_mispredict_every``, ``force_reject_every``).  Only
        engages where columnar dispatch does and the queue is
        burst-eligible; results stay bit-identical either way (the burst
        equivalence suite is the gate).  Per-run predictor counters land
        in :attr:`last_burst_stats`."""
        if profile is not None:
            profile.push("bookkeeping")
            if self._rstore is not None:
                self._rstore.profiler = profile
        try:
            return self._run_batched_inner(plans, contention, trace,
                                           compiled, pause_gc, profile,
                                           burst)
        finally:
            if profile is not None:
                if self._rstore is not None:
                    self._rstore.profiler = None
                profile.pop()   # bookkeeping

    def _run_batched_inner(self, plans, contention, trace, compiled,
                           pause_gc, profile, burst=None) -> RunResult:
        if contention is True:
            contention = ContentionModel()
        elif contention is False:
            contention = None
        op_kinds: List[List[str]] = []
        op_items: List[List] = []
        for plan in plans:
            op_kinds.append([kind for kind, _ in plan])
            op_items.append([item for _, item in plan])
        if contention is not None:
            contention.begin_run(self.nvram, self.queue.retry_profile(),
                                 schedules=self.queue.schedule_facts())
        self.contention = contention
        fast = None
        if compiled is None:
            compiled = True
        if compiled and trace is None and isinstance(self.nvram, NVRAM):
            fast = self._make_fast_executor()
        self.fast = fast
        if fast is not None and self._rstore is not None:
            # bind the columnar store's staging lists into the compiled
            # fns; the ClockScheduler then dispatches them directly
            fast.attach_store(self._rstore)
        # columnar dispatch replays every steady-state op compiled and only
        # touches a thunk on bail, so building one closure per planned op
        # up front would dominate the fast path; hand the scheduler the
        # factory instead.  The predicate mirrors ClockScheduler.run's
        # dispatch guard exactly.
        columnar = (fast is not None and fast.rstore is not None
                    and contention is None and fast.timed
                    and not self.nvram.contention_tracking)
        if columnar:
            op_lists = None
        else:
            op_lists = [[self._make_op(t, kind, item)
                         for kind, item in plan]
                        for t, plan in enumerate(plans)]
        sched = ClockScheduler(self.nvram, contention=contention,
                               fast=fast, pause_gc=pause_gc,
                               profile=profile, burst=burst)
        self.last_burst_stats = None
        self._trace_begin(trace, len(plans), None, "batched")
        try:
            sched.run(op_lists, op_kinds=op_kinds, op_items=op_items,
                      make_op=self._make_op)
            if sched.burst_exec is not None:
                self.last_burst_stats = sched.burst_exec.stats()
        finally:
            if fast is not None:
                fast.flush_counts()   # land deferred compiled-op charges
            self._trace_end(trace)
            # don't leave later (uncontended) runs on this engine paying
            # for the per-primitive epoch/CAS-tag stamping
            self.nvram.contention_tracking = False
        done = self._completed_count()
        return RunResult(crashed=False, ops=self.ops, events=self.events,
                         stats=self.nvram.total_stats(), ops_completed=done,
                         sim_time_ns=self.nvram.sim_time_ns())

    def _make_fast_executor(self):
        """Build the compiled-schedule executor for this harness's queue,
        or None when the queue declares no op_schedule()."""
        if self.queue.op_schedule() is None:
            return None
        rs = self._rstore
        if rs is not None:
            def record(tid: int, kind: str, item: Any) -> None:
                rs.add_completed_op(tid, kind, item)
        else:
            def record(tid: int, kind: str, item: Any) -> None:
                self._ops.append(OpRecord(tid=tid, kind=kind, item=item,
                                          completed=True))
        return FastPathExecutor(self.queue, self.nvram, record=record)

    def _make_op(self, tid: int, kind: str, item: Any):
        rs = self._rstore
        if rs is None:
            def op():
                if self._trace is not None:
                    self._trace.begin_op(tid, kind)
                rec = OpRecord(tid=tid, kind=kind, item=item)
                self._ops.append(rec)
                if kind == "enq":
                    self.queue.enqueue(tid, item)
                else:
                    rec.item = self.queue.dequeue(tid)
                rec.completed = True
        elif kind == "enq":
            def op():
                if self._trace is not None:
                    self._trace.begin_op(tid, kind)
                i = rs.begin_op(tid, "enq", item)
                self.queue.enqueue(tid, item)
                rs.complete_op(i)
        else:
            def op():
                if self._trace is not None:
                    self._trace.begin_op(tid, kind)
                i = rs.begin_op(tid, "deq", None)
                rs.complete_op(i, self.queue.dequeue(tid))
        return op

    # --------------------------------------------------------------- recovery
    def crash_and_recover(self, mode: str = "random", seed: int = 0,
                          snapshot=None, choices=None):
        """Full-system crash + recovery on this harness's engine.

        ``snapshot`` (an :class:`repro.core.nvram.EngineSnapshot`) is
        restored first when given -- the crash-sweep path: one scheduled run
        captured with per-step snapshots replaces rerunning the whole
        schedule for every crash point.  ``choices`` (a
        :class:`repro.core.nvram.CrashChoices`) pins the adversarial
        outcome for ``mode='subset'``.
        """
        if snapshot is not None:
            self.nvram.restore(snapshot)
        if choices is not None:
            self.nvram.crash(mode=mode, seed=seed, choices=choices)
        else:
            # the reference oracle's crash() has no `choices` parameter;
            # only the batched engine grows the subset seam
            self.nvram.crash(mode=mode, seed=seed)
        self.events.append(("crash",))
        # allocator state is volatile: recovery rebuilds the free lists from
        # the (persistent) designated areas (paper §9)
        self.mem = SSMem(self.nvram, self.nthreads,
                         area_nodes=self.mem.area_nodes)
        roots = getattr(self.queue, "roots", None)
        self.queue = self.queue_cls.recover(self.nvram, self.mem,
                                            self.nthreads, roots,
                                            on_event=self.events.append)
        return self.queue


# ---------------------------------------------------------------------------
# durable linearizability checking
# ---------------------------------------------------------------------------
def check_durable_linearizability(ops: List[OpRecord], events: List[tuple],
                                  recovered: List[Any]) -> Tuple[bool, str]:
    """Validate the recovered queue contents against the pre-crash history.

    See module docstring for the rule.  Events/ops cover the pre-crash
    execution only (pass the slices up to the ("crash",) marker).
    """
    link_order = [ev[1] for ev in events if ev[0] == "enq"]
    deq_order = [ev[1] for ev in events if ev[0] == "deq"]
    enq_completed = {r.item for r in ops if r.kind == "enq" and r.completed}
    deq_completed = {r.item for r in ops
                     if r.kind == "deq" and r.completed and r.item is not None}
    pending_deqs = sum(1 for r in ops if r.kind == "deq" and not r.completed)

    # sanity: recovered items must come from linked enqueues, no duplicates
    linkset = set(link_order)
    if len(set(recovered)) != len(recovered):
        return False, "duplicate items in recovered queue"
    for it in recovered:
        if it not in linkset:
            return False, f"recovered item {it!r} was never linked"
        if it in deq_completed:
            return False, f"recovered item {it!r} was dequeued (completed)"

    # every completed enqueue must survive unless dequeued
    must_have = [it for it in link_order
                 if it in enq_completed and it not in deq_completed]
    rset = set(recovered)
    # Walk link_order: the removed part must be a prefix (FIFO, Observation 2)
    # of the *kept* sequence; pending enqueues may be dropped anywhere.
    kept = [it for it in link_order if it in rset]
    if kept != recovered:
        return False, (f"recovered order {recovered!r} != link order "
                       f"{kept!r}")
    # removed completed-enqueue items must be explained: either completed
    # dequeues or at most `pending_deqs` pending ones, and removals must form
    # a prefix of the surviving sequence.
    removed_completed = [it for it in must_have if it not in rset]
    extra = [it for it in removed_completed if it not in deq_completed]
    if len(extra) > pending_deqs:
        return False, (f"items {extra!r} vanished without a dequeue")
    # prefix check: in link_order restricted to surviving items (recovered +
    # removed-by-dequeue), all removed items must precede all recovered ones.
    surviving = [it for it in link_order
                 if it in rset or it in deq_completed or it in extra]
    seen_kept = False
    for it in surviving:
        if it in rset:
            seen_kept = True
        elif seen_kept:
            return False, f"non-prefix removal: {it!r} removed after kept item"
    # completed dequeues must have dequeued in FIFO order of linked items
    # (checked against link order restricted to dequeued items)
    deq_link_order = [it for it in link_order if it in set(deq_order)]
    if deq_link_order != deq_order:
        return False, "dequeue order violates FIFO"
    return True, "ok"


def split_at_crash(events: List[tuple]) -> Tuple[List[tuple], List[tuple]]:
    if ("crash",) in events:
        i = events.index(("crash",))
        return events[:i], events[i + 1:]
    return list(events), []   # copy: callers may keep appending to `events`
