"""The repo's two schedulers: exact per-primitive vs. batched clock-driven.

**Exact** (:class:`Scheduler`): queue algorithms call into
:class:`repro.core.nvram.NVRAM` primitives; each primitive is a *yield
point* (``NVRAM.step_hook``).  Real OS threads run the algorithm code, but
exactly one thread is granted one primitive at a time, in a seed-determined
order.  This gives:

* reproducible interleavings (seeded random / round-robin policies),
* crash injection at an exact global step index (``crash_at``), after which
  every thread observes :class:`ThreadCrashed` at its next primitive -- the
  full-system-crash model of Izraelevitz et al. adopted by the paper (§2).

This is the standard model-checking-style harness for persistency
algorithms -- how we validate durable linearizability without NVRAM
hardware -- but the condition-variable handoff costs milliseconds per op,
capping it at seed-era scales (tens of ops per thread).

**Batched** (:class:`ClockScheduler`): a discrete-event executor with no OS
threads and no yield points.  At each step the thread with the smallest
simulated clock runs its next *whole operation* inline; thread clocks (from
the engine's latency model) drive the interleaving deterministically.  This
is the throughput path behind ``QueueHarness.run_batched`` (thousands of
ops/thread, 1--64 threads) -- but running each op to completion means no
CAS ever fails, so multi-thread contention must be modeled, not observed.

**Contention windows**: ops whose simulated intervals overlap are
*co-scheduled* -- they form the clock window an op contends in.  When a
:class:`repro.core.contention.ContentionModel` is attached, the scheduler
ticks ``NVRAM.epoch`` once per executed op (stamping per-line access
epochs) and, after each op, lets the model charge the CAS retries + helping
work a real interleaving of that window would have executed (see
contention.py for the model).  Crash injection stays exclusive to the exact
scheduler: crash tests use :class:`Scheduler`, benchmarks use
:class:`ClockScheduler`.
"""
from __future__ import annotations

import gc
import heapq
import random
import threading
from typing import Callable, List, Optional

from .nvram import NVRAM, ThreadCrashed


class Scheduler:
    def __init__(self, nvram: NVRAM, seed: int = 0, policy: str = "random",
                 crash_at: Optional[int] = None, max_steps: int = 2_000_000,
                 snapshot_hook: Optional[Callable[[int], None]] = None):
        self.nvram = nvram
        self.rng = random.Random(seed)
        self.policy = policy
        self.crash_at = crash_at
        self.max_steps = max_steps
        # Crash-sweep seam: called as snapshot_hook(s) at every *quiescent
        # boundary* -- every live thread parked at a yield point, s
        # primitives fully executed (including the trailing non-primitive
        # code of the thread that ran primitive s).  The engine state at
        # boundary s is exactly what a crash_at=s run would leave behind,
        # so one hooked run captures every crash point at once.  Called
        # once more after the last primitive (s = total) on crash-free runs.
        self.snapshot_hook = snapshot_hook
        self.steps = 0
        # grants[i] = (tid, primitive kind) of granted primitive i+1 --
        # the sweep classifies crash boundaries (persist-adjacent vs
        # interior) from this record.  Only recorded on hooked (crash-
        # capture) runs: long exact runs (trace fitting, calibration)
        # must not accumulate millions of unused tuples.
        self.grants: List[tuple] = []
        self._record_grants = snapshot_hook is not None
        self.crashed = False
        self._cv = threading.Condition()
        self._waiting: set = set()
        self._done: set = set()
        self._grant: Optional[int] = None
        self._started = 0
        nvram.step_hook = self.step

    # ------------------------------------------------------------ worker side
    def step(self, tid: int, kind: str) -> None:
        with self._cv:
            if self.crashed:
                raise ThreadCrashed()
            self._waiting.add(tid)
            self._cv.notify_all()
            while self._grant != tid:
                if self.crashed:
                    self._waiting.discard(tid)
                    self._cv.notify_all()
                    raise ThreadCrashed()
                self._cv.wait()
            # granted: consume and run one primitive
            self._grant = None
            self._waiting.discard(tid)
            if self._record_grants:
                self.grants.append((tid, kind))
            # trace hook: the primitive about to execute carries this global
            # step index (grants are serialized, so the stamp cannot race)
            tap = getattr(self.nvram, "_tap", None)
            if tap is not None:
                tap.on_sched_step(self.steps)
            self._cv.notify_all()

    # ------------------------------------------------------- coordinator side
    def run(self, workers: List[Callable[[int], None]]) -> bool:
        """Run worker callables (one per thread).  Returns True if a crash
        was injected."""
        n = len(workers)
        threads = []

        def _wrap(tid: int, fn: Callable[[int], None]):
            self.nvram.set_tid(tid)
            try:
                fn(tid)
            except ThreadCrashed:
                pass
            finally:
                with self._cv:
                    self._done.add(tid)
                    self._waiting.discard(tid)
                    self._cv.notify_all()

        for i, fn in enumerate(workers):
            t = threading.Thread(target=_wrap, args=(i, fn), daemon=True)
            threads.append(t)
            t.start()

        with self._cv:
            while len(self._done) < n:
                # wait until every live thread is parked at a yield point
                self._cv.wait_for(
                    lambda: len(self._waiting) + len(self._done) >= n
                    or len(self._done) == n)
                if len(self._done) == n:
                    break
                live = sorted(self._waiting)
                if not live:
                    continue
                if (self.crash_at is not None and self.steps >= self.crash_at) \
                        or self.steps >= self.max_steps:
                    self.crashed = True
                    self._cv.notify_all()
                    self._cv.wait_for(lambda: len(self._done) == n)
                    break
                if self.snapshot_hook is not None:
                    # quiescent boundary: `steps` primitives fully executed,
                    # all live threads parked -- safe to snapshot the engine
                    self.snapshot_hook(self.steps)
                if self.policy == "rr":
                    tid = live[self.steps % len(live)]
                else:
                    tid = self.rng.choice(live)
                self._grant = tid
                self.steps += 1
                self._cv.notify_all()
                # wait for the grant to be consumed
                self._cv.wait_for(lambda: self._grant is None
                                  or len(self._done) == n)

        for t in threads:
            t.join()
        if self.snapshot_hook is not None and not self.crashed:
            # final boundary: every primitive executed, all threads done
            self.snapshot_hook(self.steps)
        self.nvram.step_hook = None
        return self.crashed


class _NullProfiler:
    """No-op stand-in letting the profiled and unprofiled clock-heap
    loops share one body (the hooks cost two empty calls per op on the
    generic path; the columnar/burst hot paths never see them)."""

    __slots__ = ()

    def push(self, name: str) -> None:
        pass

    def pop(self) -> None:
        pass


_NULL_PROF = _NullProfiler()


class ClockScheduler:
    """Batched discrete-event executor: no OS threads, no per-primitive
    yields.

    The exact :class:`Scheduler` above serializes every memory primitive
    through a condition variable between real OS threads -- the right tool
    for model checking crash interleavings, but it caps the harness at tens
    of ops per thread.  For *throughput* runs the interleaving inside one
    queue operation does not change the cost accounting (per-thread latency
    clocks), so this scheduler interleaves at **operation granularity**,
    driven by the simulated clocks themselves: at each step the thread with
    the smallest simulated time executes its next whole operation inline.
    That is a classic discrete-event simulation -- thread clocks stay as
    tightly interleaved as the latency model allows, deterministically
    (ties break by thread id), and the engine's batched cost accumulator is
    drained once per operation instead of once per primitive.

    Sequential accounting is bit-identical to the exact scheduler's (the
    differential tests assert this), which makes thousands of ops per thread
    and 1--64-thread sweeps practical.

    Note: the schedule is fully clock-determined (no randomness) -- varying
    a workload's interleaving across runs is done by varying the *plans*
    (e.g. the mixed5050 generator's seed), not the scheduler.
    """

    def __init__(self, nvram: NVRAM, contention=None, fast=None,
                 pause_gc: bool = True, profile=None, burst=None):
        self.nvram = nvram
        self.contention = contention   # Optional[ContentionModel]
        self.fast = fast               # Optional[opsched.FastPathExecutor]
        self.pause_gc = pause_gc       # False: seed-era GC behavior
        # Optional observation-only phase profiler (duck-typed push/pop,
        # e.g. repro.obs.PhaseProfiler).  When attached, columnar runs
        # take an instrumented per-op loop dispatching the same compiled
        # fns the merged runner splices -- identical Stats/records
        # (tests/test_obs_bit_identity.py), per-op timer cost only when
        # profiling.  None leaves the hot loops untouched.
        self.profile = profile
        # Burst execution (repro.core.burst): True enables it with
        # defaults, a dict passes BurstExecutor options through.  Only
        # engages on columnar runs of burst-eligible queues; everything
        # else silently stays on the merged columnar runner.
        self.burst = burst
        self.burst_exec = None         # BurstExecutor of the last run
        self.ops_run = 0

    def run(self, op_lists: Optional[List[List[Callable[[], None]]]],
            op_kinds: Optional[List[List[str]]] = None,
            op_items: Optional[List[List]] = None,
            make_op: Optional[Callable] = None) -> bool:
        """op_lists[t] is thread t's sequence of zero-argument op thunks;
        op_kinds[t][i] (required when a contention model or fast executor
        is attached) names thunk i's kind ('enq'/'deq') so retries charge
        the right profile; op_items[t][i] is the enqueued item (fast path
        only).  Returns False (this scheduler never injects crashes).

        ``op_lists`` may be None when columnar dispatch will engage (fast
        executor with an attached record store, no contention model,
        tracking off): compiled replays never touch the thunks, so the
        caller skips building ops-count closures up front and instead
        passes ``make_op(t, kind, item) -> thunk``, called only on the
        rare bails.

        With a :class:`repro.core.opsched.FastPathExecutor` attached, each
        op is first offered to the compiled schedule replay; ops outside
        the steady state (empty dequeues, warmup, allocator refills) fall
        back to their real thunk, after which the executor resyncs its
        logical view.  Thread clocks are read back from the engine either
        way, so the schedule (and every Stat) is identical to per-op
        execution -- asserted bit-for-bit by the equivalence suite."""
        nv = self.nvram
        cm = self.contention
        fast = self.fast
        if cm is not None and op_kinds is None:
            raise ValueError("contention modeling needs op_kinds")
        if fast is not None and (op_kinds is None or op_items is None):
            raise ValueError("the fast path needs op_kinds and op_items")
        prof = self.profile
        prev_hook, nv.step_hook = nv.step_hook, None   # no yield points
        # Throughput runs allocate millions of small acyclic objects
        # (op records, event tuples, store-log entries); generational GC
        # passes over the growing live set cost ~30% of wall time for
        # zero reclaim.  Refcounting handles everything we drop.
        gc_was_enabled = self.pause_gc and gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        if prof is not None:
            prof.push("bookkeeping")
        try:
            seed_src = op_lists if op_lists is not None else op_kinds
            cursors = [0] * len(seed_src)
            heap = [(nv.thread_time_ns(t), t) for t, ops in
                    enumerate(seed_src) if ops]
            heapq.heapify(heap)
            timed = (fast is not None and cm is None and fast.timed)
            if (timed and fast.rstore is not None
                    and not nv.contention_tracking):
                return self._run_columnar(heap, cursors, op_lists,
                                          op_kinds, op_items, make_op,
                                          prof)
            if op_lists is None:
                raise ValueError("op_lists omitted but columnar dispatch "
                                 "is unavailable on this run")
            self._heap_loop(heap, cursors, op_lists, op_kinds, op_items,
                            timed,
                            prof if prof is not None else _NULL_PROF)
        finally:
            nv.step_hook = prev_hook
            if gc_was_enabled:
                gc.enable()
            if prof is not None:
                prof.pop()   # bookkeeping
        return False

    def _heap_loop(self, heap, cursors, op_lists, op_kinds, op_items,
                   timed: bool, prof) -> None:
        """The generic clock-heap loop (everything except columnar
        dispatch), shared by the profiled and unprofiled paths -- ``prof``
        is either the attached profiler or the no-op stand-in.  Phases:
        ``heap-loop`` (pop/push + cursor bookkeeping),
        ``interpreted-body`` (op bodies: compiled replay or plain
        thunks), ``bail-real-op`` (fast-path bails incl. resync)."""
        nv = self.nvram
        cm = self.contention
        fast = self.fast
        heappush, heappop = heapq.heappush, heapq.heappop
        prof.push("heap-loop")
        try:
            while heap:
                t_start, t = heappop(heap)
                i = cursors[t]
                if timed:
                    # compiled replay with exact incremental clocks: the
                    # engine is only consulted on bail (real execution)
                    prof.push("interpreted-body")
                    t_end = fast.try_op_timed(t, op_kinds[t][i],
                                              op_items[t][i], t_start)
                    prof.pop()
                    if t_end is None:
                        prof.push("bail-real-op")
                        nv.set_tid(t)
                        op_lists[t][i]()
                        fast.after_real_op(t, op_kinds[t][i])
                        t_end = nv.thread_time_ns(t)
                        prof.pop()
                else:
                    nv.set_tid(t)
                    if cm is not None:
                        nv.epoch += 1     # one clock-window tick per op
                    if fast is not None:
                        kind = op_kinds[t][i]
                        prof.push("interpreted-body")
                        hit = fast.try_op(t, kind, op_items[t][i])
                        prof.pop()
                        if not hit:
                            prof.push("bail-real-op")
                            op_lists[t][i]()
                            fast.after_real_op(t, kind)
                            prof.pop()
                    else:
                        prof.push("interpreted-body")
                        op_lists[t][i]()
                        prof.pop()
                    if cm is not None:
                        t_end = cm.after_op(t, op_kinds[t][i], t_start)
                    else:
                        t_end = nv.thread_time_ns(t)
                self.ops_run += 1
                cursors[t] += 1
                if cursors[t] < len(op_lists[t]):
                    heappush(heap, (t_end, t))
        finally:
            prof.pop()   # heap-loop

    def _run_columnar(self, heap, cursors, op_lists, op_kinds, op_items,
                      make_op, prof) -> bool:
        """Columnar dispatch: the per-kind staged fns append to the
        record store's staging lists; charges and record materialization
        happen in vector bursts at sync points.  Three drivers, all
        bit-identical:

        * the merged ``fast.crunner`` (default, no profiler) -- per-op
          fn bodies spliced into one loop;
        * the burst executor (``burst`` enabled and the queue is
          burst-eligible) -- whole multi-thread bursts as array
          programs, rejected bursts replayed through the merged runner
          in bounded chunks (the ``mispredict-replay`` phase);
        * an instrumented per-op loop (profiler attached, no burst) --
          dispatches the exact fn bodies the runner splices, per-op
          timer cost only when profiling.
        """
        nv = self.nvram
        fast = self.fast
        rs = fast.rstore
        lens = [len(ks) for ks in op_kinds]

        def bail(t, i, t_start, kind):
            # outside the compiled steady state: materialize the staged
            # burst so the engine clock read after the real thunk is
            # exact, run the real thunk, stitch its clocks into the
            # store's per-thread chain
            rs.sync()
            nv.set_tid(t)
            if op_lists is not None:
                op_lists[t][i]()
            else:
                make_op(t, kind, op_items[t][i])()
            fast.after_real_op(t, kind)
            t_end = nv.thread_time_ns(t)
            rs.note_real_clocks(t, t_start, t_end)
            return t_end

        bx = None
        if self.burst:
            from .burst import BurstExecutor, build_burst_program
            bprog = build_burst_program(fast)
            if bprog is not None:
                opts = dict(self.burst) if isinstance(self.burst, dict) \
                    else {}
                bx = BurstExecutor(bprog, fast, op_kinds, op_items, lens,
                                   profile=prof, **opts)
                self.burst_exec = bx
        if bx is not None:
            crunner = fast.crunner
            if prof is not None:
                prof.push("heap-loop")
            try:
                while heap:
                    n = bx.try_burst(heap, cursors)
                    self.ops_run += n
                    if heap and n == 0:
                        # burst rejected here: replay a bounded chunk on
                        # the merged columnar runner, bit-identically
                        if prof is not None:
                            prof.push("mispredict-replay")
                        m = crunner(heap, cursors, op_kinds, op_items,
                                    lens, bail, bx.REPLAY_CHUNK)
                        if prof is not None:
                            prof.pop()
                        self.ops_run += m
                        bx.replayed_ops += m
            finally:
                if prof is not None:
                    prof.pop()   # heap-loop
            return False
        if prof is None:
            self.ops_run += fast.crunner(
                heap, cursors, op_kinds, op_items, lens, bail)
            return False
        # instrumented per-op columnar loop: dispatches the per-kind
        # staged fns -- the exact bodies the merged runner splices, so
        # every append, charge and clock is bit-identical; the merged
        # runner is purely a loop-overhead optimization
        fns = fast.cfns
        fenq, fdeq = fns["enq"], fns["deq"]
        heappush, heappop = heapq.heappush, heapq.heappop
        prof.push("heap-loop")
        try:
            while heap:
                t_start, t = heappop(heap)
                i = cursors[t]
                kind = op_kinds[t][i]
                prof.push("interpreted-body")
                t_end = (fenq if kind == "enq" else fdeq)(
                    t, op_items[t][i], t_start)
                prof.pop()
                if t_end is None:
                    prof.push("bail-real-op")
                    t_end = bail(t, i, t_start, kind)
                    prof.pop()
                self.ops_run += 1
                cursors[t] = i + 1
                if i + 1 < lens[t]:
                    heappush(heap, (t_end, t))
        finally:
            prof.pop()   # heap-loop
        return False
