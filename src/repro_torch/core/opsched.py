"""Steady-state op-schedule IR, compiler and fast-path executor.

The paper's central objects -- per-op persist schedules and post-flush
access counts (§5-§6) -- are *fixed primitive sequences* in steady state:
once a queue is warm, every successful enqueue/dequeue replays the same
reads, writes, CAS, flush and fence primitives against a small, predictable
set of cache lines.  The per-op throughput path
(:class:`repro.core.scheduler.ClockScheduler`) nevertheless re-executes
those primitives one Python call at a time (~50-100µs/op).  This module
removes that overhead without changing a single count:

* **IR** (:class:`OpSchedule` built from :class:`L` locations and the step
  constructors below): each queue's :meth:`~repro.core.queue_base.
  QueueAlgorithm.op_schedule` declares its steady-state enqueue/dequeue as
  a typed primitive program -- the same facts its ``retry_profile()`` and
  the B2 persist-count tables assert, now as one machine-readable source
  of truth.  The contention layer derives each op kind's CAS *root* and
  whether a retry can touch flushed content directly from this program
  (:func:`linearizing_root`, :func:`retry_touches_persistent`).

* **Compiler** (:func:`compile_schedule`): partial-evaluates a schedule
  against a :class:`repro.core.memmodel.MemoryModel` and one queue
  instance.  Model-elided work disappears (``pflush`` under eADR), line
  touches whose outcome is decidable intra-op fold into a fixed event
  vector (a re-read after an invalidating flush *is* a post-flush access),
  and only genuinely state-dependent classifications survive as runtime
  steps.  The result is one pre-reduced ``(N_EV,)`` count vector plus a
  short effect program over the engine's raw arrays.

* **Executor** (:class:`FastPathExecutor`): replays compiled ops for the
  scheduler.  Logical FIFO contents are maintained in O(1) Python (a
  deque of ``(pnode, vnode, item, index)`` records), memory effects are
  applied through the same ``_vis``/``_pmem``/store-log structures the
  primitives would touch, and the whole op's events are charged through
  :meth:`repro.core.nvram.NVRAM.charge_counts` in one vector add.  Any
  op outside the compiled steady state -- empty dequeues, first-op
  sentinel warmup (per-thread retire/flush slots still NULL), allocator
  area refills, leftover unfenced persists, crash-adjacent engines --
  **bails** to real per-primitive execution; the executor then resyncs
  its logical view from engine memory.

Equivalence is the gate, not an aspiration: ``tests/
test_fastpath_equivalence.py`` asserts fast-path Stats (every counter
*and* ``time_ns``) are bit-identical to per-op ClockScheduler execution
for all 8 queues x 3 memory models x contention off/on/learned, and
``tests/test_fastpath_bailout.py`` covers the bail conditions.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .nvram import (EV_CAS, EV_DRAM, EV_FENCE, EV_FENCE_LINE, EV_FLUSH,
                    EV_HIT, EV_MOVNTI, EV_POSTFLUSH, EV_READ, EV_WRITE,
                    LINE_WORDS, LS_CACHED, LS_EVERFL, LS_FINVAL, N_EV,
                    NVRAM, TOUCH_CLASS, TOUCH_NEXT)
from .records import MAX_STAGED_NCLASS, MAX_STAGED_THREADS, META_KEY_SHIFT

NULL = 0

# Codegen cache: the generated sources are pure functions of (queue
# class, op schedule, model), so identical text recurs across harness
# constructions -- re-``exec`` of the cached code object into fresh
# globals is ~100x cheaper than re-``compile``.
_CODE_CACHE: Dict[Tuple[str, str], Any] = {}


def compile_cached(src: str, name: str):
    key = (name, src)
    code = _CODE_CACHE.get(key)
    if code is None:
        code = _CODE_CACHE[key] = compile(src, name, "exec")
    return code


# --------------------------------------------------------------------------
# locations and value expressions (queue-facing, address-free)
# --------------------------------------------------------------------------
# Environment symbols an op binds at runtime.  ``*_p`` addresses live in
# persistent space, ``*_v`` in volatile space; ``prev`` is the per-thread
# slot value bound by a ``slot_nonnull`` guard (always a persistent node).
_SYMS = ("new_p", "new_v", "tail_p", "tail_v", "head_p", "head_v",
         "next_p", "next_v", "prev")
(E_NEW_P, E_NEW_V, E_TAIL_P, E_TAIL_V, E_HEAD_P, E_HEAD_V,
 E_NEXT_P, E_NEXT_V, E_PREV) = range(len(_SYMS))
_SYM_INDEX = {s: i for i, s in enumerate(_SYMS)}
_VOLATILE_SYMS = {"new_v", "tail_v", "head_v", "next_v"}


@dataclass(frozen=True)
class L:
    """A symbolic address: an UPPERCASE queue root attribute (``HEAD``,
    ``TAIL``, ``HEADIDX``...) or a lowercase env symbol, plus a word
    offset.  ``per_tid`` addresses the calling thread's line within a
    per-thread root region (``base + tid * LINE_WORDS + off``)."""
    base: str
    off: int = 0
    per_tid: bool = False

    @property
    def is_root(self) -> bool:
        return self.base[0].isupper()


# Value expressions -- tiny tagged tuples, compiled to closures:
#   ("c", x)            literal
#   ("item",)           the op's item
#   ("idx",)            the op's index (enq: tail index + 1; deq: next's)
#   ("sym", name)       an env symbol's address *as a value* (pointer store)
#   ("tup", e1, e2)     a pair (double-width CAS payloads)
#   ("slot", attr, i)   element i of the per-thread tuple ``q.attr[tid]``
Val = tuple


# --------------------------------------------------------------------------
# IR steps
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Step:
    op: str                       # step constructor name below
    loc: Optional[L] = None
    val: Optional[Val] = None
    tpl: Optional[tuple] = None   # WriteLine template
    item_at: Optional[int] = None
    root: bool = False            # Cas: tracked contention root
    event: Optional[str] = None   # Cas: linearization event kind
    attr: Optional[str] = None    # slot / persisted-set steps
    syms: tuple = ()              # persisted_add symbols


def AllocP() -> Step:
    """Allocate a persistent node from ssmem into ``new_p`` (bails to the
    real path when the allocator would have to carve a new area)."""
    return Step("alloc_p")


def AllocV() -> Step:
    """Allocate a volatile node from the queue's ``valloc`` into ``new_v``."""
    return Step("alloc_v")


def Read(loc: L) -> Step:
    return Step("read", loc=loc)


def Write(loc: L, val: Val) -> Step:
    return Step("write", loc=loc, val=val)


def WriteLine(loc: L, tpl: tuple, item_at: Optional[int] = None) -> Step:
    """Full-line store without RFO (``NVRAM.write_full_line``)."""
    return Step("write_line", loc=loc, tpl=tpl, item_at=item_at)


def Cas(loc: L, val: Val, root: bool = False,
        event: Optional[str] = None) -> Step:
    """A CAS that always succeeds in steady state.  ``root=True`` marks the
    op's contention-tracked root CAS (exactly one per schedule);
    ``event`` emits the volatile-linearization event at this CAS."""
    return Step("cas", loc=loc, val=val, root=root, event=event)


def Flush(loc: L) -> Step:
    """Model-aware ``pflush`` (elided when the platform needs no flushes)."""
    return Step("flush", loc=loc)


def Fence() -> Step:
    return Step("fence")


def Movnti(loc: L, val: Val) -> Step:
    return Step("movnti", loc=loc, val=val)


def Retire(val: Val) -> Step:
    return Step("retire", val=val)


def RetireV(val: Val) -> Step:
    return Step("retire_v", val=val)


def SlotSet(attr: str, val: Val) -> Step:
    """``q.<attr>[tid] = value`` (volatile per-thread helper state)."""
    return Step("slot_set", attr=attr, val=val)


def PersistedDiscard(sym: str) -> Step:
    return Step("persisted_discard", attr=sym)


def PersistedAdd(*syms: str) -> Step:
    return Step("persisted_add", syms=syms)


@dataclass(frozen=True)
class OpSchedule:
    """One op kind's steady-state primitive program.

    ``guards`` are extra bail conditions beyond the built-in ones:
      ``("slot_nonnull", attr)``  -- ``q.attr[tid] != NULL`` (binds ``prev``)
      ``("tail_persisted",)``     -- the tail node's persistent half is in
                                     ``q._persisted`` (bounds backward walks)
    ``retry_from`` indexes the first step of the CAS-retry loop body; the
    contention layer inspects ``steps[retry_from:]`` to decide whether a
    failed-CAS retry can touch flushed (persistent) content at all.
    """
    kind: str
    steps: Tuple[Step, ...]
    guards: Tuple[tuple, ...] = ()
    uses_ssmem: bool = True
    retry_from: int = 0


@dataclass(frozen=True)
class FifoLayout:
    """How to walk the queue's logical FIFO straight out of engine memory
    (bootstrap + post-bail resync).  ``head_root`` names the root attr
    whose value is the current dummy node."""
    head_root: str
    next_off: int = 1
    item_off: int = 0
    idx_off: Optional[int] = None
    pptr_off: Optional[int] = None    # volatile layouts: ptr to pnode
    volatile: bool = False
    head_is_tuple: bool = False


@dataclass(frozen=True)
class QueueSchedules:
    enq: OpSchedule
    deq: OpSchedule
    layout: FifoLayout

    def __iter__(self):
        yield from (self.enq, self.deq)

    def of_kind(self, kind: str) -> OpSchedule:
        return self.enq if kind == "enq" else self.deq


# --------------------------------------------------------------------------
# schedule-derived contention facts
# --------------------------------------------------------------------------
def _loc_is_volatile(queue, loc: L) -> bool:
    if loc.is_root:
        return getattr(queue, loc.base) >= NVRAM._VOLATILE_BASE
    return loc.base in _VOLATILE_SYMS


def linearizing_root(queue, sched: OpSchedule) -> int:
    """Resolve the op's contention-tracked root word address: the target
    of the schedule's unique ``Cas(..., root=True)`` step."""
    roots = [s for s in sched.steps if s.op == "cas" and s.root]
    if len(roots) != 1:
        raise ValueError(
            f"{type(queue).__name__}/{sched.kind}: expected exactly one "
            f"root CAS, found {len(roots)}")
    loc = roots[0].loc
    if not loc.is_root:
        raise ValueError(f"root CAS must target a fixed root, got {loc}")
    base = getattr(queue, loc.base)
    return base + loc.off   # per_tid roots are not CAS targets


def retry_touches_persistent(queue, sched: OpSchedule) -> bool:
    """Does the CAS-retry loop body fetch any persistent-space line?

    A retry round can only re-incur the paper's post-flush penalty if the
    re-executed reads/CASes touch persistent memory at all; the
    second-amendment queues' loop bodies are volatile-only, which is
    exactly why their contended ``post_flush_accesses`` stay zero.  The
    contention model uses this to zero out ``flushed_reads`` claims the
    schedule cannot support.
    """
    for s in sched.steps[sched.retry_from:]:
        if s.op in ("read", "cas") and not _loc_is_volatile(queue, s.loc):
            return True
    return False


# --------------------------------------------------------------------------
# compiler
# --------------------------------------------------------------------------
# runtime opcodes.  K_PENDW / K_DRAINF are the compiler's drain fusion:
# a write whose line is provably drained by a fence later in the same op
# skips store-log materialization entirely (K_PENDW applies only the
# coherent-view store), and the fence's K_DRAINF applies the persistent
# image directly -- pre-existing log entries (recycled lines) take the
# generic order-preserving branch at runtime.
(K_CLASS_P, K_CLASS_V, K_STATE, K_VVAL, K_LOGW, K_PMEMW, K_LINE, K_DRAIN,
 K_NT, K_NTAPPLY, K_CASTAG, K_STAMP, K_PENDW, K_DRAINF) = range(14)

# K_STATE modes
ST_INVAL = 0     # invalidating flush: cached=0, finval=1, everfl=1
ST_EVERFL = 1    # retaining flush: everfl=1, cache state untouched
ST_RECACHE = 2   # post-flush re-touch: cached=1, finval=0


def _compile_addr(queue, loc: L):
    """Location -> runtime address descriptor (mode, a, b)."""
    if loc.is_root:
        base = getattr(queue, loc.base)
        if loc.per_tid:
            return (2, base, loc.off)
        return (0, base + loc.off)
    return (1, _SYM_INDEX[loc.base], loc.off)


def _compile_val(queue, val: Val):
    """Value expression -> closure(env, item, idx, tid)."""
    tag = val[0]
    if tag == "c":
        x = val[1]
        return lambda env, item, idx, tid: x
    if tag == "item":
        return lambda env, item, idx, tid: item
    if tag == "idx":
        return lambda env, item, idx, tid: idx
    if tag == "sym":
        i = _SYM_INDEX[val[1]]
        return lambda env, item, idx, tid: env[i]
    if tag == "tup":
        f1 = _compile_val(queue, val[1])
        f2 = _compile_val(queue, val[2])
        return lambda env, item, idx, tid: (f1(env, item, idx, tid),
                                            f2(env, item, idx, tid))
    if tag == "slot":
        attr, i = val[1], val[2]
        slots = getattr(queue, attr)
        return lambda env, item, idx, tid: slots[tid][i]
    raise ValueError(f"unknown value expr {val!r}")


class CompiledOp:
    """One (queue, kind, model) schedule lowered to a count vector + a
    short effect program over the engine arrays.

    ``prog`` is the backend-neutral opcode list; ``guard_specs`` /
    ``aux_specs`` keep the declarative forms so the codegen backend can
    translate them without re-walking the schedule.  ``n_class`` counts
    the dynamic classification points (each contributes one 4-bit outcome
    nibble to the codegen backend's cache key)."""

    __slots__ = ("kind", "base_counts", "prog", "aux", "event_kind",
                 "uses_ssmem", "allocs_p", "allocs_v", "guards",
                 "guard_specs", "aux_specs", "n_class", "_veccache",
                 "_tcache", "_deferred")

    def __init__(self, kind):
        self.kind = kind
        self.base_counts = np.zeros(N_EV, dtype=np.int64)
        self.prog: List[tuple] = []
        self.aux: List[tuple] = []
        self.event_kind: Optional[str] = None
        self.uses_ssmem = True
        self.allocs_p = False
        self.allocs_v = False
        self.guards: List[Callable] = []
        self.guard_specs: Tuple[tuple, ...] = ()
        self.aux_specs: List[tuple] = []
        self.n_class = 0
        self._veccache: Dict[Any, np.ndarray] = {}
        self._tcache: Dict[int, float] = {}    # key -> op time delta (ns)
        self._deferred: Dict[tuple, int] = {}  # (tid, key) -> pending ops

    def counts_for(self, dyn: tuple) -> np.ndarray:
        vec = self._veccache.get(dyn)
        if vec is None:
            vec = self.base_counts.copy()
            for c in dyn:
                vec[c] += 1
            self._veccache[dyn] = vec
        return vec

    def counts_for_key(self, key: int) -> np.ndarray:
        """Codegen-backend variant: outcomes packed as 4-bit nibbles."""
        vec = self._veccache.get(key)
        if vec is None:
            vec = self.base_counts.copy()
            k = key
            for _ in range(self.n_class):
                vec[k & 15] += 1
                k >>= 4
            self._veccache[key] = vec
        return vec

    def time_for_key(self, key: int, ns_vec: np.ndarray) -> float:
        """Simulated time one op with outcome `key` advances the thread's
        clock by.  Exact-float territory: every model latency is a
        multiple of 0.5ns, so clock += delta reproduces the engine's
        counts-dot-latency reduction bit for bit (the executor checks the
        invariant before enabling incremental clocks)."""
        t = self._tcache.get(key)
        if t is None:
            t = float(self.counts_for_key(key) @ ns_vec)
            self._tcache[key] = t
        return t


class ScheduleError(ValueError):
    """A schedule the compiler cannot prove equivalent (authoring bug)."""


def compile_schedule(queue, sched: OpSchedule, model) -> CompiledOp:
    """Lower one op schedule against a memory model + queue instance."""
    op = CompiledOp(sched.kind)
    op.uses_ssmem = sched.uses_ssmem
    base = op.base_counts
    prog = op.prog
    # symbolic cache state: line key -> None (unknown) | 'cached' | 'inv'
    # line keys: (base, off // LINE_WORDS, per_tid); node symbols are
    # line-aligned and distinct symbols never alias intra-op
    pstate: Dict[tuple, Optional[str]] = {}
    vstate: Dict[tuple, bool] = {}          # volatile word touched intra-op
    flushed_since_fence: List[tuple] = []   # (line key, addr desc)
    flushed_pending_keys: set = set()
    nt_since_fence: List[tuple] = []        # (line key, addr desc, valfn)
    # positions of each line's last write/flush since the last fence: the
    # compiled fence drains a flushed line's FULL log, which is exact iff
    # no write to it lands after its last pre-fence flush
    seq = [0]
    last_write: Dict[tuple, int] = {}
    last_flush: Dict[tuple, int] = {}
    # prog indices of since-fence writes per line key (drain fusion)
    writes_map: Dict[tuple, List[int]] = {}

    def lkey(loc: L) -> tuple:
        return (loc.base, loc.off // LINE_WORDS, loc.per_tid)

    def addr(loc: L):
        return _compile_addr(queue, loc)

    def stamp(loc: L) -> None:
        # contention epoch stamp for a statically-classified touch (the
        # engine stamps on EVERY touch; one stamp per line per op is
        # equivalent -- the epoch does not change intra-op)
        prog.append((K_STAMP, addr(loc)))

    def touch_p(loc: L) -> None:
        k = lkey(loc)
        st = pstate.get(k)
        if st is None:
            prog.append((K_CLASS_P, addr(loc)))
            pstate[k] = "cached"
        elif st == "cached":
            base[EV_HIT] += 1
            stamp(loc)
        else:   # invalidated by an intra-op flush: the paper's penalty
            base[EV_POSTFLUSH] += 1
            prog.append((K_STATE, addr(loc), ST_RECACHE))
            pstate[k] = "cached"
            stamp(loc)

    def touch_v(loc: L) -> None:
        k = (loc.base, loc.off)
        if vstate.get(k):
            base[EV_HIT] += 1
        else:
            prog.append((K_CLASS_V, addr(loc)))
            vstate[k] = True

    def write_effect(loc: L, valfn, spec: Val) -> None:
        if _loc_is_volatile(queue, loc):
            prog.append((K_VVAL, addr(loc), valfn, spec))
            return
        seq[0] += 1
        last_write[lkey(loc)] = seq[0]
        if model.persist_on_store:
            prog.append((K_PMEMW, addr(loc), valfn, spec))
        else:
            prog.append((K_LOGW, addr(loc), valfn, spec))
            writes_map.setdefault(lkey(loc), []).append(len(prog) - 1)

    for si, s in enumerate(sched.steps):
        kind = s.op
        if kind == "alloc_p":
            op.allocs_p = True
        elif kind == "alloc_v":
            op.allocs_v = True
        elif kind == "read":
            base[EV_READ] += 1
            if _loc_is_volatile(queue, s.loc):
                touch_v(s.loc)
            else:
                touch_p(s.loc)
        elif kind == "write":
            base[EV_WRITE] += 1
            valfn = _compile_val(queue, s.val)
            if _loc_is_volatile(queue, s.loc):
                touch_v(s.loc)
            else:
                touch_p(s.loc)
            write_effect(s.loc, valfn, s.val)
        elif kind == "write_line":
            if _loc_is_volatile(queue, s.loc):
                raise ScheduleError("write_line is persistent-only in "
                                    "the queue schedules")
            base[EV_WRITE] += 1
            base[EV_HIT] += 1
            k = lkey(s.loc)
            seq[0] += 1
            last_write[k] = seq[0]
            prog.append((K_LINE, addr(s.loc), tuple(s.tpl), s.item_at,
                         bool(model.persist_on_store), False))
            if not model.persist_on_store:
                writes_map.setdefault(k, []).append(len(prog) - 1)
            pstate[k] = "cached"
        elif kind == "cas":
            base[EV_CAS] += 1
            valfn = _compile_val(queue, s.val)
            vol = _loc_is_volatile(queue, s.loc)
            if vol:
                touch_v(s.loc)
            else:
                touch_p(s.loc)
            write_effect(s.loc, valfn, s.val)
            prog.append((K_CASTAG, addr(s.loc), vol))
            if s.event is not None:
                if op.event_kind is not None:
                    raise ScheduleError("one linearization event per op")
                op.event_kind = s.event
        elif kind == "flush":
            if not model.needs_flush:
                continue          # pflush elided by the platform
            if _loc_is_volatile(queue, s.loc):
                raise ScheduleError("flushing volatile memory")
            base[EV_FLUSH] += 1
            k = lkey(s.loc)
            seq[0] += 1
            last_flush[k] = seq[0]
            if k not in flushed_pending_keys:
                flushed_since_fence.append((k, addr(s.loc)))
                flushed_pending_keys.add(k)
            if model.flush_invalidates:
                prog.append((K_STATE, addr(s.loc), ST_INVAL))
                pstate[k] = "inv"
            else:
                prog.append((K_STATE, addr(s.loc), ST_EVERFL))
        elif kind == "movnti":
            base[EV_MOVNTI] += 1
            if _loc_is_volatile(queue, s.loc):
                raise ScheduleError("movnti targets persistent memory")
            valfn = _compile_val(queue, s.val)
            prog.append((K_NT, addr(s.loc), valfn, s.val))
            nt_since_fence.append((lkey(s.loc), addr(s.loc), valfn, s.val))
        elif kind == "fence":
            base[EV_FENCE] += 1
            for k in flushed_pending_keys:
                if last_write.get(k, -1) > last_flush[k]:
                    raise ScheduleError(
                        f"{sched.kind}: write to {k} after its last flush "
                        "before the fence -- the compiled drain would "
                        "over-apply it")
            lines = {k for k, _ in flushed_since_fence}
            lines |= {k for k, _, _, _ in nt_since_fence}
            base[EV_FENCE_LINE] += len(lines)
            for k, a in flushed_since_fence:
                idxs = writes_map.get(k)
                if not idxs:
                    prog.append((K_DRAIN, a))
                    continue
                # drain fusion: this op's own writes to the line skip log
                # materialization; the fence applies them to the
                # persistent image directly (a pre-existing log -- e.g. a
                # recycled line -- takes the generic branch at runtime)
                deferred, total = [], 0
                for i in sorted(idxs):
                    ins = prog[i]
                    if ins[0] == K_LOGW:
                        prog[i] = (K_PENDW, ins[1], ins[2], ins[3])
                        deferred.append(("w", ins[1], ins[2], ins[3]))
                        total += 1
                    else:   # K_LINE
                        prog[i] = (K_LINE, ins[1], ins[2], ins[3], ins[4],
                                   True)
                        deferred.append(("line", ins[1], ins[2], ins[3]))
                        total += LINE_WORDS
                prog.append((K_DRAINF, a, tuple(deferred), total))
            for _, a, valfn, spec in nt_since_fence:
                prog.append((K_NTAPPLY, a, valfn, spec))
            flushed_since_fence = []
            flushed_pending_keys = set()
            nt_since_fence = []
            last_write.clear()
            last_flush.clear()
            writes_map.clear()
        elif kind == "retire":
            op.aux.append(("retire", _compile_val(queue, s.val)))
            op.aux_specs.append(("retire", s.val))
        elif kind == "retire_v":
            op.aux.append(("retire_v", _compile_val(queue, s.val)))
            op.aux_specs.append(("retire_v", s.val))
        elif kind == "slot_set":
            op.aux.append(("slot", getattr(queue, s.attr),
                           _compile_val(queue, s.val)))
            op.aux_specs.append(("slot", s.attr, s.val))
        elif kind == "persisted_discard":
            op.aux.append(("pdiscard", _SYM_INDEX[s.attr]))
            op.aux_specs.append(("pdiscard", s.attr))
        elif kind == "persisted_add":
            op.aux.append(("padd", tuple(_SYM_INDEX[x] for x in s.syms)))
            op.aux_specs.append(("padd", s.syms))
        else:
            raise ScheduleError(f"unknown step {kind!r}")
    if flushed_since_fence or nt_since_fence:
        raise ScheduleError(
            f"{sched.kind}: schedule ends with unfenced persists -- the "
            "next op's PendingEmpty bail guard would never hold")
    op.n_class = sum(1 for ins in prog if ins[0] in (K_CLASS_P, K_CLASS_V))
    if op.n_class > 15:
        raise ScheduleError("more than 15 dynamic classification points "
                            "per op (nibble key overflow)")
    op.guard_specs = tuple(sched.guards)
    # guards
    for g in sched.guards:
        if g[0] == "slot_nonnull":
            slots = getattr(queue, g[1])

            def _g_slot(ex, tid, _slots=slots):
                v = _slots[tid]
                if v == NULL:
                    return False
                ex.env[E_PREV] = v
                return True
            op.guards.append(_g_slot)
        elif g[0] == "tail_persisted":
            pers = queue._persisted

            def _g_pers(ex, tid, _pers=pers):
                t = ex.fifo[-1] if ex.fifo else ex.dummy
                return t[0] in _pers
            op.guards.append(_g_pers)
        else:
            raise ScheduleError(f"unknown guard {g!r}")
    return op


# --------------------------------------------------------------------------
# codegen backend
# --------------------------------------------------------------------------
# The interpreter above is the readable reference backend; this lowers the
# same CompiledOp program to one specialized Python function per (queue,
# kind, model) -- straight-line code over hoisted engine arrays with every
# address/constant baked in.  Both backends execute the identical opcode
# list, and the equivalence suite pins both against real per-op execution.

def _addr_src(a) -> str:
    if a[0] == 0:
        return str(a[1])
    if a[0] == 1:
        name = _SYMS[a[1]]
        return name if a[2] == 0 else f"({name} + {a[2]})"
    return f"({a[1] + a[2]} + tid * {LINE_WORDS})"


def _line_src(a) -> str:
    if a[0] == 0:
        return str(a[1] // LINE_WORDS)
    s = _addr_src(a)
    # bare names need no parens -- keeps the rendering canonical so the
    # CSE pass unifies this with the K_LINE/K_LOGW spellings
    if s.isidentifier():
        return f"{s} // {LINE_WORDS}"
    return f"({s}) // {LINE_WORDS}"


def _val_src(v: Val) -> str:
    tag = v[0]
    if tag == "c":
        return repr(v[1])
    if tag == "item":
        return "item"
    if tag == "idx":
        return "idx"
    if tag == "sym":
        return v[1]
    if tag == "tup":
        return f"({_val_src(v[1])}, {_val_src(v[2])})"
    if tag == "slot":
        return f"q.{v[1]}[tid][{v[2]}]"
    raise ScheduleError(f"unknown value expr {v!r}")


_VB = NVRAM._VOLATILE_BASE


def _emit_prog(emit, op: CompiledOp, tracking: bool,
               values_only: bool = False) -> None:
    """Emit the effect-program body shared by both codegen variants.

    Line-state transitions go through the engine's packed ``_lstate``
    byte array: dynamic touches read one byte and apply the
    ``TOUCH_CLASS``/``TOUCH_NEXT`` tables (bound as ``_CT``/``_NS``),
    static transitions write the packed constant directly.  ``tracking``
    emits the contention-epoch taps (legacy variant only; the columnar
    variant is dispatched exclusively with tracking off).

    ``values_only`` keeps just the value-carrying effects (vis/pmem/vval
    stores, log appends and drains) and drops everything the burst
    executor computes vectorized instead: outcome-key accounting and
    every ``lstate``/``vtouched`` read or write.  The burst automaton
    over the fleet lowering's opcode rows covers exactly the dropped
    transitions, so running this body per grant followed by the
    vectorized line-state scatter reproduces the full-body mutations.

    Address, line-number and volatile-index expressions are pure within
    one op body (they only read ``tid``/``item`` and the node locals
    fixed up front), so repeats are hoisted into ``_c<n>`` locals --
    common-subexpression elimination at the source level.  Value
    expressions stay inline: they may read mutable queue state."""
    cse: dict = {}

    def ref(expr: str) -> str:
        """Hoist a pure expression into a local, once per op body."""
        if expr.isidentifier() or expr.lstrip("-").isdigit():
            return expr
        v = cse.get(expr)
        if v is None:
            v = f"_c{len(cse)}"
            emit(f"    {v} = {expr}")
            cse[expr] = v
        return v

    def vals_ref(vals: List[str]) -> str:
        """One shared list object per distinct line-literal (the writers
        only ever copy out of it, never mutate it)."""
        return ref(f"[{', '.join(vals)}]")

    def line_of(a: str) -> str:
        """Line number of an already-rendered address expression."""
        if a.lstrip("-").isdigit():
            return str(int(a) // LINE_WORDS)
        return ref(f"{a} // {LINE_WORDS}")

    prog = op.prog
    for pc, ins in enumerate(prog):
        code = ins[0]
        if code in (K_CLASS_P, K_CLASS_V, K_STATE) and values_only:
            continue
        if code == K_CLASS_P:
            ln = ref(_line_src(ins[1]))
            if tracking:
                emit("    if tk:")
                emit(f"        le[{ln}] = ep")
            emit(f"    key = key << 4 | _CT[(_s := lstate[{ln}])]")
            emit(f"    lstate[{ln}] = _NS[_s]")
        elif code == K_CLASS_V:
            # branchless: untouched -> EV_DRAM (8), touched -> EV_HIT (7)
            vi = ref(f"{_addr_src(ins[1])} - {_VB}")
            emit(f"    key = key << 4 | ({EV_DRAM} - vtouched[{vi}])")
            emit(f"    vtouched[{vi}] = 1")
        elif code == K_STATE:
            mode = ins[2]
            ln = ref(_line_src(ins[1]))
            if mode == ST_INVAL:
                emit(f"    lstate[{ln}] = {LS_FINVAL | LS_EVERFL}")
            elif mode == ST_EVERFL:
                emit(f"    lstate[{ln}] |= {LS_EVERFL}")
            else:
                # ST_RECACHE provably follows this op's own ST_INVAL on
                # the same line, so the packed state is a constant
                emit(f"    lstate[{ln}] = {LS_CACHED | LS_EVERFL}")
        elif code == K_VVAL:
            vi = ref(f"{_addr_src(ins[1])} - {_VB}")
            emit(f"    vval[{vi}] = {_val_src(ins[3])}")
        elif code == K_LOGW:
            a = ref(_addr_src(ins[1]))
            ln = line_of(a)
            emit(f"    _v = {_val_src(ins[3])}")
            emit(f"    vis[{a}] = _v")
            emit(f"    _lg = log.get({ln})")
            emit("    if _lg is None:")
            emit(f"        log[{ln}] = [({a}, _v)]")
            emit("    else:")
            emit(f"        _lg.append(({a}, _v))")
        elif code == K_PMEMW:
            a = ref(_addr_src(ins[1]))
            emit(f"    _v = {_val_src(ins[3])}")
            emit(f"    vis[{a}] = _v")
            emit(f"    pmem[{a}] = _v")
        elif code == K_LINE:
            vals = [repr(x) for x in ins[2]]
            if ins[3] is not None:
                vals[ins[3]] = "item"
            a = ref(_addr_src(ins[1]))
            ln = line_of(a)
            vl = vals_ref(vals)
            emit(f"    vis[{a}:{a} + {LINE_WORDS}] = {vl}")
            if ins[4]:              # eADR: visible => durable
                emit(f"    pmem[{a}:{a} + {LINE_WORDS}] = {vl}")
            elif not ins[5]:        # materialize unless drain-fused
                emit(f"    _lg = log.get({ln})")
                emit(f"    _ents = list(zip(range({a}, {a} + "
                     f"{LINE_WORDS}), {vl}))")
                emit("    if _lg is None:")
                emit(f"        log[{ln}] = _ents")
                emit("    else:")
                emit("        _lg.extend(_ents)")
            # dead-store elimination: skip the cached-bit write when the
            # very next instruction overwrites this same line's state with
            # a constant (ST_INVAL/ST_RECACHE); nothing reads it between
            nxt = prog[pc + 1] if pc + 1 < len(prog) else None
            if values_only:
                pass
            elif not (nxt is not None and nxt[0] == K_STATE
                      and nxt[2] in (ST_INVAL, ST_RECACHE)
                      and nxt[1] == ins[1]):
                emit(f"    lstate[{ln}] = lstate[{ln}] & {LS_EVERFL} | "
                     f"{LS_CACHED}")
        elif code == K_PENDW:
            emit(f"    vis[{ref(_addr_src(ins[1]))}] = {_val_src(ins[3])}")
        elif code == K_DRAIN:
            ln = ref(_line_src(ins[1]))
            emit(f"    _lg = log.get({ln})")
            emit("    if _lg:")
            emit("        for _wa, _wv in _lg:")
            emit("            pmem[_wa] = _wv")
            emit(f"        ls[{ln}] += len(_lg)")
            emit("        _lg.clear()")
        elif code == K_DRAINF:
            ln = ref(_line_src(ins[1]))
            emit(f"    _lg = log.get({ln})")
            emit("    if _lg:")
            emit("        for _wa, _wv in _lg:")
            emit("            pmem[_wa] = _wv")
            emit("        _n0 = len(_lg)")
            emit("        _lg.clear()")
            emit("    else:")
            emit("        _n0 = 0")
            for ent in ins[2]:
                if ent[0] == "w":
                    emit(f"    pmem[{ref(_addr_src(ent[1]))}] = "
                         f"{_val_src(ent[3])}")
                else:
                    vals = [repr(x) for x in ent[2]]
                    if ent[3] is not None:
                        vals[ent[3]] = "item"
                    a = ref(_addr_src(ent[1]))
                    emit(f"    pmem[{a}:{a} + {LINE_WORDS}] = "
                         f"{vals_ref(vals)}")
            emit(f"    ls[{ln}] += _n0 + {ins[3]}")
        elif code == K_NT:
            emit(f"    vis[{ref(_addr_src(ins[1]))}] = {_val_src(ins[3])}")
        elif code == K_NTAPPLY:
            emit(f"    pmem[{ref(_addr_src(ins[1]))}] = {_val_src(ins[3])}")
        elif code == K_CASTAG:
            if tracking:
                # inside `if tk:` -- must not hoist into the taken path
                emit("    if tk:")
                emit(f"        _a = {_addr_src(ins[1])}")
                emit("        cw[_a] = cw.get(_a, 0) + 1")
                if ins[2]:
                    emit(f"        le[_a // {LINE_WORDS}] = ep")
        else:   # K_STAMP
            if tracking:
                emit("    if tk:")
                emit(f"        le[{_line_src(ins[1])}] = ep")


def _emit_aux(emit, op: CompiledOp) -> None:
    for ax in op.aux_specs:
        t0 = ax[0]
        if t0 == "retire":
            # inlined SSMem.retire: limbo-append under the current epoch
            emit(f"    mem._limbo[tid].append(({_val_src(ax[1])}, "
                 "mem._epoch, 'p'))")
        elif t0 == "retire_v":
            emit(f"    mem._limbo[tid].append(({_val_src(ax[1])}, "
                 "mem._epoch, 'v'))")
        elif t0 == "slot":
            emit(f"    q.{ax[1]}[tid] = {_val_src(ax[2])}")
        elif t0 == "pdiscard":
            emit(f"    q._persisted.discard({ax[1]})")
        else:   # padd
            for s in ax[1]:
                emit(f"    q._persisted.add({s})")


def generate_fast_fn(queue, op: CompiledOp) -> Callable:
    """Translate one CompiledOp into a specialized fast-op function
    ``fn(ex, tid, item) -> time-delta | None`` via source generation
    (the legacy-record variant: per-op ``ex.record`` callback + deferred
    per-(tid, key) charge dict)."""
    w: List[str] = []
    emit = w.append
    kind = op.kind
    emit("def _fast_op(ex, tid, item):")
    emit("    nv = ex.nv")
    emit("    if nv.crashed or nv._pending[tid]:")
    emit("        return None")
    emit("    fifo = ex.fifo")
    emit("    q = ex.q")
    if kind == "deq":
        emit("    if not fifo:")
        emit("        return None")
    else:
        emit("    _t = fifo[-1] if fifo else ex.dummy")
    for g in op.guard_specs:
        if g[0] == "slot_nonnull":
            emit(f"    prev = q.{g[1]}[tid]")
            emit("    if prev == 0:")
            emit("        return None")
        else:   # tail_persisted
            emit("    if _t[0] not in q._persisted:")
            emit("        return None")
    if op.uses_ssmem:
        emit("    mem = q.mem")
    if op.allocs_p:
        emit("    if not mem._free[tid] and (not mem._areas[tid]")
        emit("            or mem._cursor[tid] >= mem.area_nodes):")
        emit("        return None")
    if op.uses_ssmem:
        emit("    mem.op_begin(tid)")
    if kind == "enq":
        emit("    tail_p = _t[0]")
        emit("    tail_v = _t[1]")
        emit("    idx = (_t[3] or 0) + 1")
    else:
        emit("    _d = ex.dummy")
        emit("    _n = fifo[0]")
        emit("    head_p = _d[0]")
        emit("    head_v = _d[1]")
        emit("    next_p = _n[0]")
        emit("    next_v = _n[1]")
        emit("    idx = _n[3]")
        emit("    result = _n[2]")
    if op.allocs_p:
        emit("    new_p = mem.alloc(tid)")
    if op.allocs_v:
        emit("    new_v = q.valloc.alloc(tid)")
    # hoist exactly the engine structures the program touches
    codes = {ins[0] for ins in op.prog}
    if codes & {K_CLASS_P, K_STATE, K_LINE}:
        emit("    lstate = nv._lstate")
    if codes & {K_CLASS_V}:
        emit("    vtouched = nv._vtouched")
    if codes & {K_VVAL}:
        emit("    vval = nv._vval")
    if codes & {K_LOGW, K_PMEMW, K_LINE, K_NT, K_PENDW}:
        emit("    vis = nv._vis")
    if codes & {K_PMEMW, K_DRAIN, K_DRAINF, K_NTAPPLY} or \
            (K_LINE in codes and any(ins[0] == K_LINE and ins[4]
                                     for ins in op.prog)):
        emit("    pmem = nv._pmem")
    if codes & {K_LOGW, K_DRAIN, K_DRAINF} or \
            (K_LINE in codes and any(ins[0] == K_LINE and not ins[4]
                                     for ins in op.prog)):
        emit("    log = nv._log")
    if codes & {K_DRAIN, K_DRAINF}:
        emit("    ls = nv._log_start")
    if codes & {K_CLASS_P, K_CASTAG, K_STAMP}:
        emit("    tk = nv.contention_tracking")
        emit("    if tk:")
        emit("        le = nv._line_epoch")
        emit("        ep = nv.epoch")
        if K_CASTAG in codes:
            emit("        cw = nv._cas_words")
    emit("    key = 0")
    _emit_prog(emit, op, tracking=True)
    # defer the count charge (flushed in bulk by the executor) and return
    # the op's exact clock advance -- see CompiledOp.time_for_key
    emit("    _k = (tid, key)")
    emit("    _n = _dc.get(_k)")
    emit("    _dc[_k] = 1 if _n is None else _n + 1")
    emit("    _t = _tc.get(key)")
    emit("    if _t is None:")
    emit("        _t = _op.time_for_key(key, nv._ns_vec)")
    if kind == "enq":
        np_src = "new_p" if op.allocs_p else "0"
        nv_src = "new_v" if op.allocs_v else "None"
        emit(f"    fifo.append(({np_src}, {nv_src}, item, idx))")
    else:
        emit("    ex.dummy = fifo.popleft()")
    _emit_aux(emit, op)
    res = "item" if kind == "enq" else "result"
    if op.event_kind is not None:
        emit(f"    q.on_event(({op.event_kind!r}, {res}))")
    emit(f"    ex.record(tid, {kind!r}, {res})")
    emit("    ex.fast_ops += 1")
    emit("    return _t")
    src = "\n".join(w)
    g = {"_op": op, "_vc": op._veccache, "_dc": op._deferred,
         "_tc": op._tcache, "_CT": TOUCH_CLASS, "_NS": TOUCH_NEXT}
    exec(compile_cached(src, f"<opsched:{type(queue).__name__}.{kind}>"), g)
    fn = g["_fast_op"]
    fn.__source__ = src
    return fn


def generate_columnar_fn(queue, op: CompiledOp, nvram: NVRAM, fifo: deque,
                         dbox: list) -> Callable:
    """Translate one CompiledOp into the columnar-record fast-op variant
    ``fn(tid, item, t_start) -> post-op clock | None``.

    The per-op tail is three plain-list appends into the attached
    :class:`repro.core.records.RecordStore` staging buffers (one packed
    ``key << META_KEY_SHIFT | tid << 1 | kind`` word, the op's item, the
    post-op clock); the whole burst is materialized and charged in one
    vector pass at :meth:`~repro.core.records.RecordStore.sync`.  Every
    engine container the body touches is bound as a keyword-only default
    (the engine's identity-stability contract makes that safe across
    crash/restore); ``sm``/``si``/``st`` start as ``None`` placeholders
    and are rebound by ``FastPathExecutor.attach_store``.  Only generated
    when the outcome key fits the staging word (``n_class <=
    MAX_STAGED_NCLASS``, ``nthreads <= MAX_STAGED_THREADS``); dispatched
    by :class:`repro.core.scheduler.ClockScheduler` only with no
    contention model and tracking off, so the epoch/CAS taps compile to
    nothing."""
    w: List[str] = []
    emit = w.append
    kind = op.kind
    codes = {ins[0] for ins in op.prog}
    params = [("nv", "_NV"), ("pending", "_PENDING"), ("fifo", "_FIFO"),
              ("dbox", "_DBOX"), ("q", "_Q")]
    if op.uses_ssmem:
        params.append(("mem", "_MEM"))
    if op.allocs_v:
        params.append(("valloc", "_VALLOC"))
    if codes & {K_CLASS_P, K_STATE, K_LINE}:
        params.append(("lstate", "_LSTATE"))
    if K_CLASS_V in codes:
        params.append(("vtouched", "_VTOUCHED"))
    if K_VVAL in codes:
        params.append(("vval", "_VVAL"))
    if codes & {K_LOGW, K_PMEMW, K_LINE, K_NT, K_PENDW}:
        params.append(("vis", "_VIS"))
    if codes & {K_PMEMW, K_DRAIN, K_DRAINF, K_NTAPPLY} or \
            any(ins[0] == K_LINE and ins[4] for ins in op.prog):
        params.append(("pmem", "_PMEM"))
    if codes & {K_LOGW, K_DRAIN, K_DRAINF} or \
            any(ins[0] == K_LINE and not ins[4] for ins in op.prog):
        params.append(("log", "_LOG"))
    if codes & {K_DRAIN, K_DRAINF}:
        params.append(("ls", "_LS"))
    if K_CLASS_P in codes:
        params += [("_CT", "_TCT"), ("_NS", "_TNS")]
    params += [("_tc", "_tc"), ("_op", "_op"),
               ("sm", "None"), ("si", "None"), ("st", "None")]
    # plain positional defaults, not keyword-only: CPython resolves them
    # from the code object's defaults tuple with no per-call dict lookups
    # (measurably cheaper at this call rate); attach_store rebinds the
    # trailing sm/si/st slots through fn.__defaults__
    sig = ", ".join(f"{n}={d}" for n, d in params)
    emit(f"def _fast_op(tid, item, t_start, {sig}):")
    emit("    if nv.crashed or pending[tid]:")
    emit("        return None")
    if kind == "deq":
        emit("    if not fifo:")
        emit("        return None")
    else:
        emit("    _t = fifo[-1] if fifo else dbox[0]")
    for g in op.guard_specs:
        if g[0] == "slot_nonnull":
            emit(f"    prev = q.{g[1]}[tid]")
            emit("    if prev == 0:")
            emit("        return None")
        else:   # tail_persisted
            emit("    if _t[0] not in q._persisted:")
            emit("        return None")
    if op.allocs_p:
        # _mf is the per-thread free list OBJECT (never rebound by ssmem,
        # only popped/appended), so reading it before op_begin is safe:
        # an epoch advance inside op_begin refills this same list
        emit("    _mf = mem._free[tid]")
        emit("    if not _mf and (not mem._areas[tid]")
        emit("            or mem._cursor[tid] >= mem.area_nodes):")
        emit("        return None")
    if op.uses_ssmem:
        # inlined SSMem.op_begin: announce under the CURRENT epoch, then
        # bump the shared op counter; the 64th op resets it and runs the
        # (rare) epoch advance.  check-then-increment here is the same
        # automaton as op_begin's increment-then-check -- state 63 maps
        # to a reset + advance either way
        emit("    mem._announced[tid] = mem._epoch")
        emit("    if mem._ops_since_adv >= 63:")
        emit("        mem._ops_since_adv = 0")
        emit("        mem._try_advance()")
        emit("    else:")
        emit("        mem._ops_since_adv += 1")
    if kind == "enq":
        emit("    tail_p = _t[0]")
        emit("    tail_v = _t[1]")
        emit("    idx = (_t[3] or 0) + 1")
    else:
        emit("    _d = dbox[0]")
        emit("    _n = fifo[0]")
        emit("    head_p = _d[0]")
        emit("    head_v = _d[1]")
        emit("    next_p = _n[0]")
        emit("    next_v = _n[1]")
        emit("    idx = _n[3]")
        emit("    result = _n[2]")
    if op.allocs_p:
        # inlined SSMem.alloc fast paths.  The pop must be decided AFTER
        # op_begin: its epoch advance can refill _mf, and the real alloc
        # would see that refill.  The bump branch never needs _new_area --
        # the guard above proved area space exists when _mf was empty, and
        # the advance only ever grows _mf
        emit("    if _mf:")
        emit("        new_p = _mf.pop()")
        emit("    else:")
        emit("        _cu = mem._cursor[tid]")
        emit(f"        new_p = mem._areas[tid][-1] + _cu * {LINE_WORDS}")
        emit("        mem._cursor[tid] = _cu + 1")
    if op.allocs_v:
        # inlined VolatileAlloc.alloc fast path (free-list pop); the
        # chunk-refill slow path stays an out-of-line call
        emit("    _vf = valloc._free[tid]")
        emit("    if _vf:")
        emit("        new_v = _vf.pop()")
        emit("    else:")
        emit("        new_v = valloc.alloc(tid)")
    emit("    key = 0")
    _emit_prog(emit, op, tracking=False)
    emit("    _t2 = _tc.get(key)")
    emit("    if _t2 is None:")
    emit("        _t2 = _op.time_for_key(key, nv._ns_vec)")
    if kind == "enq":
        np_src = "new_p" if op.allocs_p else "0"
        nv_src = "new_v" if op.allocs_v else "None"
        emit(f"    fifo.append(({np_src}, {nv_src}, item, idx))")
    else:
        emit("    dbox[0] = fifo.popleft()")
    _emit_aux(emit, op)
    emit("    _te = t_start + _t2")
    kbit = 0 if kind == "enq" else 1
    emit(f"    sm.append(key << {META_KEY_SHIFT} | tid << 1 | {kbit})")
    emit("    si.append(item)" if kind == "enq" else "    si.append(result)")
    emit("    st.append(_te)")
    emit("    return _te")
    src = "\n".join(w)
    g = {"_op": op, "_tc": op._tcache, "_TCT": TOUCH_CLASS,
         "_TNS": TOUCH_NEXT, "_NV": nvram, "_PENDING": nvram._pending,
         "_FIFO": fifo, "_DBOX": dbox, "_Q": queue,
         "_MEM": getattr(queue, "mem", None),
         "_VALLOC": getattr(queue, "valloc", None),
         "_LSTATE": nvram._lstate,
         "_VTOUCHED": nvram._vtouched, "_VVAL": nvram._vval,
         "_VIS": nvram._vis, "_PMEM": nvram._pmem, "_LOG": nvram._log,
         "_LS": nvram._log_start}
    exec(compile_cached(
        src, f"<opsched-col:{type(queue).__name__}.{kind}>"), g)
    fn = g["_fast_op"]
    fn.__source__ = src
    fn.__params__ = params      # (name, global-name) pairs, in order
    return fn


def generate_columnar_runner(cfns: dict, queue) -> Callable:
    """Merge the two columnar fast-op bodies into ONE generated function
    that owns the whole clock-heap loop.

    The per-op call frames (scheduler -> fast-op) are the last fixed cost
    once the bodies themselves are lean, so the runner splices the
    generated enq/deq sources inline -- each body's early ``return None``
    bails become breaks out of a one-shot ``while True`` block, landing in
    a shared bail arm that defers to the scheduler-provided ``bail``
    callback (staged-burst sync + real thunk + clock stitch).  Bit
    identity is untouched: the spliced text IS the fast-op bodies, only
    the calling convention changed.  ``sm``/``si``/``st`` stay the last
    three positional defaults so ``FastPathExecutor.attach_store`` rebinds
    the runner exactly like the fns it was spliced from.
    """
    fenq, fdeq = cfns["enq"], cfns["deq"]
    # merged bound-parameter spec: enq's engine params, deq-only extras,
    # the per-op caches disambiguated (_tc/_op -> _tcd/_opd for deq),
    # staging buffers last
    env: dict = {}
    params: List[Tuple[str, str]] = []
    seen = set()
    renames_deq = {"_tc": "_tcd", "_op": "_opd"}
    for fn, renames in ((fenq, {}), (fdeq, renames_deq)):
        vals = dict(zip([n for n, _ in fn.__params__], fn.__defaults__))
        for name, gname in fn.__params__:
            if name in ("sm", "si", "st"):
                continue
            tgt = renames.get(name, name)
            if tgt in seen:
                continue
            seen.add(tgt)
            g_tgt = "_G" + tgt
            params.append((tgt, g_tgt))
            env[g_tgt] = vals[name]
    params += [("sm", "None"), ("si", "None"), ("st", "None")]

    def splice(fn, renames) -> List[str]:
        out = []
        for line in fn.__source__.splitlines()[1:]:
            stripped = line.strip()
            pad = " " * (len(line) - len(line.lstrip())) + " " * 12
            for old, new in renames.items():
                line = line.replace(f"{old}.", f"{new}.")
            if stripped == "return None":
                out.append(pad + "_te = None")
                out.append(pad + "break")
            elif stripped == "return _te":
                out.append(pad + "break")
            else:
                out.append(" " * 12 + line)
        return out

    sig = ", ".join(f"{n}={d}" for n, d in params)
    w: List[str] = []
    emit = w.append
    emit(f"def _runner(heap, cursors, op_kinds, op_items, lens, bail, "
         f"nops=-1, heappop=_HPOP, heappush=_HPUSH, {sig}):")
    emit("    ops_run = 0")
    emit("    while heap and ops_run != nops:")
    emit("        t_start, tid = heappop(heap)")
    emit("        _i = cursors[tid]")
    emit("        if op_kinds[tid][_i] == 'enq':")
    emit("            item = op_items[tid][_i]")
    emit("            _te = None")
    emit("            while True:")
    w.extend(splice(fenq, {}))
    emit("                break")
    emit("            if _te is None:")
    emit("                _te = bail(tid, _i, t_start, 'enq')")
    emit("        else:")
    emit("            item = op_items[tid][_i]")
    emit("            _te = None")
    emit("            while True:")
    w.extend(splice(fdeq, renames_deq))
    emit("                break")
    emit("            if _te is None:")
    emit("                _te = bail(tid, _i, t_start, 'deq')")
    emit("        cursors[tid] = _i + 1")
    emit("        ops_run += 1")
    emit("        if _i + 1 < lens[tid]:")
    emit("            heappush(heap, (_te, tid))")
    emit("    return ops_run")
    src = "\n".join(w)
    env["_HPOP"] = heapq.heappop
    env["_HPUSH"] = heapq.heappush
    exec(compile_cached(src, f"<opsched-runner:{type(queue).__name__}>"),
         env)
    runner = env["_runner"]
    runner.__source__ = src
    return runner


def _op_value_syms(op: CompiledOp) -> set:
    """Node-local symbol names the op's *value* effects read (addresses
    and value expressions of the stores kept by ``values_only``)."""
    used: set = set()

    def _val(v) -> None:
        tag = v[0]
        if tag == "sym":
            used.add(v[1])
        elif tag == "tup":
            _val(v[1])
            _val(v[2])

    def _addr(a) -> None:
        if a is not None and a[0] == 1:
            used.add(_SYMS[a[1]])

    for ins in op.prog:
        code = ins[0]
        if code in (K_CLASS_P, K_CLASS_V, K_STATE, K_CASTAG, K_STAMP):
            continue
        _addr(ins[1])
        if code == K_DRAINF:
            for ent in ins[2]:
                _addr(ent[1])
                if ent[0] == "w":
                    _val(ent[3])
        elif code in (K_VVAL, K_LOGW, K_PMEMW, K_PENDW, K_NT, K_NTAPPLY):
            _val(ins[3])
    return used


def generate_burst_apply_fn(queue, ops: Dict[str, CompiledOp],
                            nvram: NVRAM) -> Callable:
    """Generate the burst executor's merged per-grant value loop.

    The burst path splits each compiled op body in two: everything that
    feeds the outcome key (line-state and volatile-touch transitions) is
    replayed vectorized from the fleet lowering's opcode rows, while the
    value-carrying stores -- which may move arbitrary Python payloads
    through ``vis``/``pmem``/``vval`` and the per-line write logs --
    still need sequential grant-order execution because the engine's
    value containers are plain Python lists.  This emits that sequential
    half as ONE loop over the whole burst: per grant it binds the
    planner-computed node locals from column lists and runs the
    ``values_only`` rendering of the enq or deq body (see
    :func:`_emit_prog`).  Drain branches (``K_DRAIN``/``K_DRAINF``) stay
    exact without any prediction precisely because this loop runs in
    grant order: each drain sees the log contents its predecessors left.

    Signature of the generated fn::

        _burst_apply(n, kb, tids, e_items, e_idxs, <e_syms...>,
                     d_items, d_idxs, <d_syms...>)

    ``kb`` is the per-grant kind bit (1 = deq); each kind's node-local
    columns are *per-kind* lists (indexed by separate enq/deq cursors, so
    the planner never pads the other kind's rows).  The sym column order
    per kind is published as ``fn.__cols__``.  Engine containers ride as
    positional defaults like the columnar fns.
    """
    nv = nvram
    cols = {k: sorted(_op_value_syms(ops[k])) for k in ("enq", "deq")}
    w: List[str] = []
    emit = w.append
    sig = ", ".join(
        [f"e_items, e_idxs"] + [f"e_{s}" for s in cols["enq"]] +
        [f"d_items, d_idxs"] + [f"d_{s}" for s in cols["deq"]])
    emit(f"def _burst_apply(n, kb, tids, {sig}, "
         "vis=_VIS, pmem=_PMEM, vval=_VVAL, log=_LOG, ls=_LS):")
    emit("    g = 0")
    emit("    ge = 0")
    emit("    gd = 0")
    emit("    while g < n:")
    emit("        tid = tids[g]")
    emit("        if kb[g]:")
    for kind, pfx, cur in (("deq", "d", "gd"), ("enq", "e", "ge")):
        op = ops[kind]
        body: List[str] = [f"    item = {pfx}_items[{cur}]",
                           f"    idx = {pfx}_idxs[{cur}]"]
        for s in cols[kind]:
            body.append(f"    {s} = {pfx}_{s}[{cur}]")
        _emit_prog(body.append, op, tracking=False, values_only=True)
        body.append(f"    {cur} += 1")
        w.extend("        " + line for line in body)
        if kind == "deq":
            emit("        else:")
    emit("        g += 1")
    src = "\n".join(w)
    env = {"_VIS": nv._vis, "_PMEM": nv._pmem, "_VVAL": nv._vval,
           "_LOG": nv._log, "_LS": nv._log_start}
    exec(compile_cached(src, f"<burst-apply:{type(queue).__name__}>"), env)
    fn = env["_burst_apply"]
    fn.__source__ = src
    fn.__cols__ = cols
    return fn


# --------------------------------------------------------------------------
# executor
# --------------------------------------------------------------------------
def _peek(nv: NVRAM, addr: int):
    """Raw, unaccounted read of the engine's coherent view (bootstrap and
    resync only -- never on a costed path)."""
    if addr >= NVRAM._VOLATILE_BASE:
        return nv._vval[addr - NVRAM._VOLATILE_BASE]
    return nv._vis[addr]


class FastPathExecutor:
    """Replays compiled steady-state schedules for one batched run.

    Owned by :meth:`repro.core.harness.QueueHarness.run_batched`; driven by
    :class:`repro.core.scheduler.ClockScheduler`.  ``record(tid, kind,
    item)`` is the harness's op-record callback (mirrors the per-op
    thunk's ``OpRecord`` bookkeeping).
    """

    def __init__(self, queue, nvram: NVRAM,
                 record: Optional[Callable[[int, str, Any], None]] = None,
                 backend: str = "codegen"):
        schedules = queue.op_schedule()
        if schedules is None:
            raise ScheduleError(f"{type(queue).__name__} declares no "
                                "op_schedule()")
        self.q = queue
        self.nv = nvram
        self.record = record or (lambda tid, kind, item: None)
        self.layout = schedules.layout
        self.backend = backend
        cache = queue.__dict__.setdefault("_compiled_schedules", {})
        key = nvram.model.name
        ent = cache.get(key)
        # columnar fns bind this engine's containers as keyword defaults,
        # so a cache entry is only valid against the engine it was
        # generated for; regenerate on an engine swap
        if ent is None or ent[3] is not nvram:
            ops = {k: compile_schedule(queue, schedules.of_kind(k),
                                       nvram.model)
                   for k in ("enq", "deq")}
            fns = {k: generate_fast_fn(queue, op) for k, op in ops.items()}
            fifo: deque = deque()
            dbox: list = [None]
            cfns = None
            crunner = None
            if (nvram.nthreads <= MAX_STAGED_THREADS
                    and all(o.n_class <= MAX_STAGED_NCLASS
                            for o in ops.values())):
                cfns = {k: generate_columnar_fn(queue, op, nvram, fifo,
                                                dbox)
                        for k, op in ops.items()}
                crunner = generate_columnar_runner(cfns, queue)
            ent = (ops, fns, cfns, nvram, fifo, dbox, crunner)
            cache[key] = ent
        (self.ops, self._fns, self.cfns, _, self.fifo, self._dbox,
         self.crunner) = ent
        self.env: List[Any] = [NULL] * len(_SYMS)
        self.rstore = None        # columnar RecordStore (attach_store)
        self.fast_ops = 0         # compiled replays
        self.bailed_ops = 0       # fell back to real execution
        # incremental clocks are exact (hence heap-order identical to the
        # engine's counts-dot-latency reduction) iff every latency is a
        # multiple of 0.5ns, so float sums never round
        ns2 = nvram._ns_vec * 2.0
        self.timed = bool(np.all(ns2 == np.round(ns2)))
        if backend == "codegen":
            self.try_op = self._codegen_op
        else:
            self.try_op_timed = self._interp_timed
        self._bootstrap()

    # the logical dummy node lives in a one-slot box shared with the
    # columnar fns (bound as their ``dbox`` default)
    @property
    def dummy(self) -> Optional[tuple]:
        return self._dbox[0]

    @dummy.setter
    def dummy(self, rec: Optional[tuple]) -> None:
        self._dbox[0] = rec

    def attach_store(self, store) -> bool:
        """Wire a :class:`repro.core.records.RecordStore` into this run:
        rebind the columnar fns' staging-list defaults and hand the store
        the engine + compiled ops it charges staged bursts against.
        Returns False (store not attached) when columnar dispatch is
        unavailable -- non-codegen backend, inexact latencies, or an
        outcome key that does not fit the staging word."""
        self.rstore = None
        if (store is None or self.cfns is None
                or self.backend != "codegen" or not self.timed):
            return False
        fns = list(self.cfns.values())
        if self.crunner is not None:
            fns.append(self.crunner)
        for fn in fns:
            # sm/si/st are the last three positional defaults by
            # construction (generate_columnar_fn and the merged runner
            # both append them last)
            fn.__defaults__ = fn.__defaults__[:-3] + (
                store._sm, store._si, store._st)
        store.attach_engine(
            self.nv, (self.ops["enq"], self.ops["deq"]),
            (self.ops["enq"].event_kind, self.ops["deq"].event_kind),
            executor=self)
        self.rstore = store
        return True

    def _codegen_op(self, tid: int, kind: str, item: Any) -> bool:
        """Codegen backend, eager mode (used under a contention model):
        run the generated function, then flush its deferred charge so the
        model's ``after_op`` reads up-to-date engine counts."""
        fn = self._fns.get(kind)
        if fn is None:
            return False
        if fn(self, tid, item) is None:
            return False
        self.flush_counts()
        return True

    def try_op_timed(self, tid: int, kind: str, item: Any,
                     t_start: float) -> Optional[float]:
        """Codegen backend, deferred mode: execute one compiled op and
        return the thread's post-op clock (``t_start`` + the op's exact
        time delta), or None on bail (with pending charges flushed so the
        real thunk and its engine-side clock read are exact)."""
        fn = self._fns.get(kind)
        if fn is not None:
            d = fn(self, tid, item)
            if d is not None:
                return t_start + d
        self.flush_counts()
        return None

    def _interp_timed(self, tid: int, kind: str, item: Any,
                      t_start: float) -> Optional[float]:
        if self.try_op(tid, kind, item):
            return self.nv.thread_time_ns(tid)
        return None

    def flush_counts(self) -> None:
        """Apply all deferred compiled-op charges to the engine counters
        through the charge seam (a handful of vector adds per run), and
        materialize any staged columnar burst."""
        charge = self.nv.charge_counts
        for op in self.ops.values():
            dc = op._deferred
            if dc:
                for (tid, key), n in dc.items():
                    vec = op.counts_for_key(key)
                    charge(tid, vec if n == 1 else vec * n)
                dc.clear()
        if self.rstore is not None:
            self.rstore.flush()

    # ------------------------------------------------------------ logical view
    def _read_record(self, addr: int) -> tuple:
        nv, lay = self.nv, self.layout
        item = _peek(nv, addr + lay.item_off)
        idx = _peek(nv, addr + lay.idx_off) if lay.idx_off is not None else 0
        if lay.volatile:
            p = (_peek(nv, addr + lay.pptr_off)
                 if lay.pptr_off is not None else NULL)
            return (p, addr, item, idx or 0)
        return (addr, None, item, idx or 0)

    def _next_addr(self, rec: tuple) -> int:
        lay = self.layout
        base = rec[1] if lay.volatile else rec[0]
        return _peek(self.nv, base + lay.next_off) or NULL

    def _bootstrap(self) -> None:
        """Build the logical FIFO by walking engine memory from the head
        root -- the state any prefill/recovery left behind."""
        lay = self.layout
        head = getattr(self.q, lay.head_root)
        hv = _peek(self.nv, head)
        if lay.head_is_tuple:
            hv, hidx = hv
            self.dummy = self._read_record(hv)
            self.dummy = (self.dummy[0], self.dummy[1], self.dummy[2], hidx)
        else:
            self.dummy = self._read_record(hv)
        self.fifo.clear()
        rec = self.dummy
        while True:
            nxt = self._next_addr(rec)
            if nxt == NULL:
                break
            rec = self._read_record(nxt)
            self.fifo.append(rec)

    def after_real_op(self, tid: int, kind: str) -> None:
        """Resync the logical view after a bailed (real) op: a real
        enqueue appended exactly one node after the old logical tail; a
        real dequeue consumed the head (or observed empty)."""
        self.bailed_ops += 1
        if kind == "enq":
            tail = self.fifo[-1] if self.fifo else self.dummy
            nxt = self._next_addr(tail)
            if nxt != NULL:
                self.fifo.append(self._read_record(nxt))
        elif self.fifo:
            self.dummy = self.fifo.popleft()

    # ---------------------------------------------------------------- fast op
    def try_op(self, tid: int, kind: str, item: Any) -> bool:
        """Execute one op through the compiled fast path.  Returns False
        (without any side effect) when a bail guard fires; the caller then
        runs the real per-primitive thunk."""
        op = self.ops.get(kind)
        nv = self.nv
        if op is None or nv.crashed or nv._pending[tid]:
            return False
        fifo = self.fifo
        if kind == "deq" and not fifo:
            return False          # empty dequeue: a different schedule
        for g in op.guards:
            if not g(self, tid):
                return False
        q = self.q
        mem = q.mem if op.uses_ssmem else None
        if op.allocs_p:
            # an area refill mid-op is hundreds of primitives of zeroing:
            # real execution territory
            if not mem._free[tid] and (not mem._areas[tid] or
                                       mem._cursor[tid] >= mem.area_nodes):
                return False
        if mem is not None:
            mem.op_begin(tid)
        env = self.env
        if kind == "enq":
            t = fifo[-1] if fifo else self.dummy
            env[E_TAIL_P], env[E_TAIL_V] = t[0], t[1]
            idx = (t[3] or 0) + 1
            result = item
        else:
            d, n = self.dummy, fifo[0]
            env[E_HEAD_P], env[E_HEAD_V] = d[0], d[1]
            env[E_NEXT_P], env[E_NEXT_V] = n[0], n[1]
            idx = n[3]
            result = n[2]
        if op.allocs_p:
            env[E_NEW_P] = mem.alloc(tid)
        if op.allocs_v:
            env[E_NEW_V] = q.valloc.alloc(tid)

        # ---- effect program ------------------------------------------
        vis, pmem = nv._vis, nv._pmem
        lstate = nv._lstate
        vval, vtouched = nv._vval, nv._vtouched
        log, log_start = nv._log, nv._log_start
        tracking = nv.contention_tracking
        epoch = nv.epoch
        line_epoch = nv._line_epoch
        VB = NVRAM._VOLATILE_BASE
        dyn: List[int] = []
        for ins in op.prog:
            code = ins[0]
            a = ins[1]
            m = a[0]
            if m == 0:
                ad = a[1]
            elif m == 1:
                ad = env[a[1]] + a[2]
            else:
                ad = a[1] + tid * LINE_WORDS + a[2]
            if code == K_CLASS_P:
                ln = ad // LINE_WORDS
                if tracking:
                    line_epoch[ln] = epoch
                s = lstate[ln]
                dyn.append(TOUCH_CLASS[s])
                lstate[ln] = TOUCH_NEXT[s]
            elif code == K_CLASS_V:
                i = ad - VB
                if vtouched[i]:
                    dyn.append(EV_HIT)
                else:
                    dyn.append(EV_DRAM)
                    vtouched[i] = 1
            elif code == K_LOGW:
                v = ins[2](env, item, idx, tid)
                vis[ad] = v
                ln = ad // LINE_WORDS
                lg = log.get(ln)
                if lg is None:
                    log[ln] = [(ad, v)]
                else:
                    lg.append((ad, v))
            elif code == K_VVAL:
                vval[ad - VB] = ins[2](env, item, idx, tid)
            elif code == K_PMEMW:
                v = ins[2](env, item, idx, tid)
                vis[ad] = v
                pmem[ad] = v
            elif code == K_STATE:
                ln = ad // LINE_WORDS
                mode = ins[2]
                if mode == ST_INVAL:
                    lstate[ln] = LS_FINVAL | LS_EVERFL
                elif mode == ST_EVERFL:
                    lstate[ln] |= LS_EVERFL
                else:
                    lstate[ln] = (lstate[ln] & LS_EVERFL) | LS_CACHED
            elif code == K_LINE:
                vals = list(ins[2])
                if ins[3] is not None:
                    vals[ins[3]] = item
                hi = ad + LINE_WORDS
                vis[ad:hi] = vals
                ln = ad // LINE_WORDS
                if ins[4]:                      # eADR: durable on store
                    pmem[ad:hi] = vals
                elif not ins[5]:                # materialize unless fused
                    lg = log.get(ln)
                    ents = list(zip(range(ad, hi), vals))
                    if lg is None:
                        log[ln] = ents
                    else:
                        lg.extend(ents)
                lstate[ln] = (lstate[ln] & LS_EVERFL) | LS_CACHED
            elif code == K_PENDW:
                # fused-drain write: coherent view now, persistent image
                # at the covering fence's K_DRAINF
                vis[ad] = ins[2](env, item, idx, tid)
            elif code == K_DRAIN:
                ln = ad // LINE_WORDS
                lg = log.get(ln)
                if lg:
                    for (wa, wv) in lg:
                        pmem[wa] = wv
                    log_start[ln] += len(lg)
                    lg.clear()
            elif code == K_DRAINF:
                ln = ad // LINE_WORDS
                lg = log.get(ln)
                if lg:     # pre-existing entries (recycled line): oldest first
                    for (wa, wv) in lg:
                        pmem[wa] = wv
                    n0 = len(lg)
                    lg.clear()
                else:
                    n0 = 0
                for ent in ins[2]:
                    a2d = ent[1]
                    m2 = a2d[0]
                    if m2 == 0:
                        a2 = a2d[1]
                    elif m2 == 1:
                        a2 = env[a2d[1]] + a2d[2]
                    else:
                        a2 = a2d[1] + tid * LINE_WORDS + a2d[2]
                    if ent[0] == "w":
                        pmem[a2] = ent[2](env, item, idx, tid)
                    else:
                        vals = list(ent[2])
                        if ent[3] is not None:
                            vals[ent[3]] = item
                        pmem[a2:a2 + LINE_WORDS] = vals
                log_start[ln] += n0 + ins[3]
            elif code == K_NT:
                vis[ad] = ins[2](env, item, idx, tid)
            elif code == K_NTAPPLY:
                pmem[ad] = ins[2](env, item, idx, tid)
            elif code == K_CASTAG:
                if tracking:
                    cw = nv._cas_words
                    cw[ad] = cw.get(ad, 0) + 1
                    if ins[2]:                  # volatile CAS target
                        line_epoch[ad // LINE_WORDS] = epoch
            else:   # K_STAMP
                if tracking:
                    line_epoch[ad // LINE_WORDS] = epoch

        # ---- charge the whole op in one vector add -------------------
        nv.charge_counts(tid, op.counts_for(tuple(dyn)))

        # ---- logical FIFO + aux --------------------------------------
        if kind == "enq":
            fifo.append((env[E_NEW_P] if op.allocs_p else NULL,
                         env[E_NEW_V] if op.allocs_v else None, item, idx))
        else:
            self.dummy = fifo.popleft()
        for ax in op.aux:
            t0 = ax[0]
            if t0 == "retire":
                mem.retire(tid, ax[1](env, item, idx, tid))
            elif t0 == "retire_v":
                mem.retire_volatile(tid, ax[1](env, item, idx, tid))
            elif t0 == "slot":
                ax[1][tid] = ax[2](env, item, idx, tid)
            elif t0 == "pdiscard":
                q._persisted.discard(env[ax[1]])
            else:   # padd
                q._persisted.update(env[i] for i in ax[1])
        if op.event_kind is not None:
            q.on_event((op.event_kind, result))
        self.record(tid, kind, result)
        self.fast_ops += 1
        return True
