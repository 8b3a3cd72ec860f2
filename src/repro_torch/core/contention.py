"""Contention model for the batched (clock-driven) scheduler path.

The exact OS-thread :class:`repro.core.scheduler.Scheduler` interleaves at
primitive granularity, so CAS races at the queue roots *actually happen*
there: a thread reads the tail, another thread links first, the CAS fails,
and the loser retries -- re-reading content the winner just flushed (the
paper's post-flush penalty) and, in the helping designs, persisting the
obstructing link before advancing the tail.  The batched
:class:`repro.core.scheduler.ClockScheduler` runs each operation to
completion inline, so no CAS ever fails and multi-thread sweeps model zero
contention -- understating exactly the flushed-access gap the Second
Amendment targets.

This module closes that gap *above* the cost accumulator: it never changes
how a primitive is accounted (the single-thread differential oracle stays
bit-identical); it only appends extra, pre-classified event codes for the
retries a real interleaving would have executed.

Model
-----
The batched executor pops threads in simulated-clock order, so operation
start times are globally non-decreasing.  An operation that starts at
``t_start`` is *co-scheduled* with every earlier operation whose interval is
still open (``t_end > t_start``) -- that set is the clock window.  Each
queue declares, per op kind, a :class:`RetryProfile`: which root word the
op's linearizing CAS targets (head or tail) and which event codes one failed
CAS round replays (cached re-reads, re-reads of *flushed* content,
helping-path flushes/fences, the failed CAS itself).

For an op whose profile targets root ``w``, let ``k`` be the number of
co-scheduled ops of *other* threads whose traced CASes hit ``w`` (the engine
tags CAS target words; a delta of the per-word CAS count over the op tells
which roots it really hit -- a failing dequeue that never CASes charges
nothing).  The op's CAS **failure probability** at ``w`` is

    ``p = min(retry_scale * profile.weight * k, P_CAP)``

-- under the exact scheduler's uniform interleaving, each co-scheduled
conflicting op lands its linearizing CAS inside this op's read-to-CAS race
window with a roughly constant probability (the window's fraction of the
op), so ``p`` grows linearly in ``k`` until it saturates.  Each failed
round re-opens the window, so retry rounds are geometric and the expected
count is ``E = p / (1 - p)`` -- near zero at 2 threads, steep by 8, exactly
the shape the exact scheduler exhibits.  Expected event counts (``E`` times
the profile's per-round counts, which may themselves be fractional) accrue
in deterministic per-(thread, kind, unit) fractional accumulators (no RNG
-- the batched schedule stays reproducible) and are emitted as whole
events via :meth:`repro.core.nvram.NVRAM.charge_events`, which also
advances the thread's clock so contention feeds back into the schedule
itself.

Staleness is bounded by the engine's per-line access *epochs* (the
scheduler ticks ``NVRAM.epoch`` once per executed op; while a model is
attached -- ``NVRAM.contention_tracking`` -- every touch stamps its line):
each in-flight entry records the root line's ``NVRAM.line_epoch`` at the
time of its CAS, and an entry older than ``window_ops`` epochs is dropped
even if a laggard clock keeps its interval open.

Calibration: ``tests/test_contention_calibration.py`` pins this model
against exact-scheduler ground truth (2--8 threads, all seven queues) on
persist-instruction and flushed-access totals; the default ``retry_scale``
is fit there.  ``retry_scale=0`` (or one thread) reproduces the uncontended
counts exactly -- the property suite asserts bit-equality.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from .memmodel import MemoryModel
from .nvram import (EV_CAS, EV_FENCE, EV_FENCE_LINE, EV_FLUSH, EV_HIT,
                    EV_POSTFLUSH, EV_READ, LINE_WORDS)

# Per-round CAS failure probability contributed by ONE co-scheduled
# conflicting op.  Fit against the exact scheduler (see
# tests/test_contention_calibration.py): across all seven queues the
# read->CAS race window is a similar fraction of an operation, ~0.2.
DEFAULT_RETRY_SCALE = 0.2

# Saturation for the failure probability: E = p/(1-p) must stay finite when
# many threads hammer one root (at P_CAP=0.85 an op retries ~5.7x).
P_CAP = 0.85


@dataclass(frozen=True)
class RetryProfile:
    """Event-code shape of ONE failed CAS round for one op kind.

    Queues return these from :meth:`QueueAlgorithm.retry_profile`.  The
    fields are symbolic -- :class:`ContentionModel` resolves them against
    the active :class:`repro.core.memmodel.MemoryModel` (e.g. a
    ``flushed_reads`` re-read is a post-flush access only under an
    invalidating-flush platform; helping flushes are elided under eADR,
    exactly as :meth:`QueueAlgorithm.pflush` would elide them).
    """

    root: int                 # contended root word (HEAD/TAIL address)
    reads: float = 0.0        # re-reads of still-cached content (hits)
    flushed_reads: float = 0.0  # re-reads of content the algorithm flushes
    cas: float = 1.0          # CAS rounds replayed (the failed attempt)
    flushes: float = 0.0      # helping-path flushes (persist the obstruction)
    fences: float = 0.0       # helping-path fences
    weight: float = 1.0       # race-window fraction relative to the ~0.2 norm
    # Contention decay of the post-flush fraction: a retry's re-read pays
    # the post-flush fetch only if no co-scheduled op re-fetched the
    # invalidated line first, so the effective per-round count shrinks as
    # the window widens.  Two forms:
    #   * a scalar d (the inert hand-profile default 0.0): the parametric
    #     shape flushed_reads / (1 + d * k);
    #   * a tuple shape s: a per-window-size table -- the round's count is
    #     flushed_reads * s[min(k, len(s)) - 1] for window size k >= 1 --
    #     measured directly per traced thread count by the trace fit
    #     (repro.trace.fit), which captures the faster-than-1/(1+dk)
    #     decay the exact scheduler shows at 12-16 threads.
    flushed_decay: Union[float, Tuple[float, ...]] = 0.0
    # Saturation of the expected failed rounds per op.  The geometric
    # E = p/(1-p) caps at P_CAP/(1-P_CAP) (~5.7) once many threads hammer
    # one root, but the exact scheduler saturates lower and per-queue
    # (helping drains the obstruction; the root CAS serializes).  The
    # default keeps the hand-profile behavior; the trace fit measures it.
    max_rounds: float = P_CAP / (1.0 - P_CAP)

    def flushed_scale(self, k: int) -> float:
        """Multiplier on the per-round flushed-read count at window size
        ``k`` (>= 1): the parametric 1/(1+d*k) for a scalar decay, the
        measured per-k table entry for a tuple shape."""
        d = self.flushed_decay
        if isinstance(d, tuple):
            if not d:
                return 1.0
            return d[min(k, len(d)) - 1]
        if d > 0:
            return 1.0 / (1.0 + d * k)
        return 1.0

    def event_units(self, model: MemoryModel
                    ) -> List[Tuple[Tuple[int, ...], float, bool]]:
        """(code-sequence, expected-count, decays) units for one retry round.

        Counts are *expected values per failed round* (a retry takes the
        DurableMSQ helping path only some of the time; a re-read lands on a
        still-invalidated line only when no other op re-fetched it first),
        so they are floats -- the model accrues each unit in a deterministic
        fractional accumulator and emits whole events.  ``decays`` marks
        the flushed-read unit, whose count the model additionally scales by
        ``1 / (1 + flushed_decay * k)`` at charge time.
        """
        # Re-touching a line the algorithm just flushed: the paper's
        # post-flush access under invalidating CLWB; an ordinary hit when
        # flushes retain the line (CXL) or are never issued (eADR).
        flushed_touch = (EV_POSTFLUSH if model.flush_invalidates else EV_HIT)
        units = [
            ((EV_READ, EV_HIT), self.reads, False),
            ((EV_READ, flushed_touch), self.flushed_reads, True),
            ((EV_CAS, EV_HIT), self.cas, False),
        ]
        if model.needs_flush:
            units.append(((EV_FLUSH,), self.flushes, False))
            fence_codes = ((EV_FENCE, EV_FENCE_LINE) if self.flushes
                           else (EV_FENCE,))
            units.append((fence_codes, self.fences, False))
        else:
            # eADR: helping degenerates to the ordering barrier alone
            units.append(((EV_FENCE,), self.fences, False))
        return [(codes, n, dec) for codes, n, dec in units if n > 0]


# RetryProfile numeric fields a learned profile may override (root stays
# instance-bound: addresses are allocation-order specific)
_LEARNED_FIELDS = ("reads", "flushed_reads", "cas", "flushes", "fences",
                   "weight", "flushed_decay", "max_rounds")


@dataclass(frozen=True)
class LearnedRetryProfile:
    """Per-queue retry-profile numbers measured from exact-scheduler traces.

    Produced by :mod:`repro.trace.fit` (least-squares per-round event
    counts + a race-window weight matched to observed CAS failures) and
    consumed here: pass one to :class:`ContentionModel` and
    :meth:`ContentionModel.begin_run` *binds* it against the queue's own
    :meth:`repro.core.queue_base.QueueAlgorithm.retry_profile` -- the
    declared profiles contribute only their ``root`` addresses (which are
    allocation-specific), every numeric field comes from the measurement.

    ``params`` maps op kind -> field -> value for the fields
    ``reads / flushed_reads / cas / flushes / fences / weight``;
    ``source`` carries fit provenance (thread counts, ops, residuals).
    """

    queue: str
    params: Mapping[str, Mapping[str, float]]
    source: Mapping[str, Any] = field(default_factory=dict)

    def bind(self, declared: Dict[str, RetryProfile]
             ) -> Dict[str, RetryProfile]:
        """Graft learned numbers onto the queue's declared roots."""
        def _coerce(f, v):
            # flushed_decay may be a measured per-window-size shape
            # (serialized as a list); everything else is scalar
            if f == "flushed_decay" and isinstance(v, (list, tuple)):
                return tuple(float(x) for x in v)
            return float(v)

        out: Dict[str, RetryProfile] = {}
        for kind, prof in declared.items():
            p = self.params.get(kind)
            if p is None:
                out[kind] = prof      # kind the fit never observed
                continue
            out[kind] = RetryProfile(
                root=prof.root,
                **{f: _coerce(f, p.get(f, getattr(prof, f)))
                   for f in _LEARNED_FIELDS})
        return out


class ContentionModel:
    """Charges CAS-retry costs for co-scheduled ops in the batched path.

    One instance drives one :meth:`QueueHarness.run_batched` call; pass it
    via the harness (``run_batched(plans, contention=ContentionModel())``)
    or let the harness construct the default.  See the module docstring for
    the model; the public knobs:

    ``retry_scale``
        Per-round CAS failure probability contributed by one co-scheduled
        conflicting op (scaled by the profile's ``weight``; 0 disables
        charging entirely -- bit-identical to uncontended).
    ``window_ops``
        Epoch width of the co-schedule window; entries older than this many
        executed ops are dropped regardless of clock overlap.  ``None``
        (default) sizes it to the thread count at :meth:`begin_run`.
    ``profiles``
        An optional :class:`LearnedRetryProfile` (from
        :mod:`repro.trace.fit`): at :meth:`begin_run` its measured numbers
        are bound onto the queue-declared roots, replacing the hand-fit
        per-round counts and weights.
    """

    def __init__(self, retry_scale: float = DEFAULT_RETRY_SCALE,
                 window_ops: Optional[int] = None,
                 profiles: Optional[LearnedRetryProfile] = None):
        if retry_scale < 0:
            raise ValueError("retry_scale must be >= 0")
        self.retry_scale = retry_scale
        self.learned = profiles
        self.window_ops = window_ops
        self._window_ops_fixed = window_ops is not None
        self.retries_charged = 0.0    # sum of expected failed rounds
        self.ops_seen = 0
        self.retries_by_root: Dict[int, float] = {}
        self._nv = None
        self._profiles: Dict[str, RetryProfile] = {}
        self._units: Dict[str, List[Tuple[Tuple[int, ...], float]]] = {}
        self._roots: List[int] = []
        self._last_cas_count: Dict[int, int] = {}
        # per root: open intervals of ops that CASed it: (end_ns, tid, epoch)
        self._inflight: Dict[int, List[Tuple[float, int, int]]] = {}
        # deterministic fractional accumulators, one per (tid, kind, unit)
        self._frac: Dict[Tuple[int, str, int], float] = {}

    # ------------------------------------------------------------ lifecycle
    def begin_run(self, nvram, profiles: Dict[str, RetryProfile],
                  schedules=None) -> None:
        """Bind to an engine + the queue's retry profiles for one run.

        ``schedules`` (the queue's :meth:`repro.core.queue_base.
        QueueAlgorithm.schedule_facts`) grounds the profiles in the
        queue's declared op schedule instead of hand-maintained tables:
        each kind's tracked root address comes from the schedule's root
        CAS, and a kind whose retry loop provably touches no persistent
        line gets its ``flushed_reads`` zeroed -- a volatile-only retry
        cannot re-incur the post-flush penalty, whatever a (learned or
        hand-fit) profile claims.
        """
        if not hasattr(nvram, "charge_events"):
            raise TypeError(
                "contention modeling needs the batched engine "
                "(repro.core.nvram.NVRAM); the reference oracle stays "
                "contention-free by design")
        self._nv = nvram
        nvram.contention_tracking = True   # enable epoch/CAS-tag bookkeeping
        self._profiles = dict(profiles or {})
        if self.learned is not None:
            self._profiles = self.learned.bind(self._profiles)
        if schedules:
            for kind, prof in list(self._profiles.items()):
                facts = schedules.get(kind)
                if facts is None:
                    continue
                changes = {}
                if prof.root != facts["root"]:
                    changes["root"] = facts["root"]
                if not facts["flushable_retry"] and prof.flushed_reads:
                    changes["flushed_reads"] = 0.0
                if changes:
                    self._profiles[kind] = replace(prof, **changes)
        self._units = {k: p.event_units(nvram.model)
                       for k, p in self._profiles.items()}
        self._roots = sorted({p.root for p in self._profiles.values()})
        self._last_cas_count = {w: nvram.cas_count(w) for w in self._roots}
        self._inflight = {w: [] for w in self._roots}
        self._frac = {}
        # reporting counters are per-run too: a reused model must not
        # contaminate its second run's retries_per_op with the first's
        self.retries_charged = 0.0
        self.ops_seen = 0
        self.retries_by_root = {}
        if not self._window_ops_fixed:
            self.window_ops = max(2, getattr(nvram, "nthreads", 2))

    # ------------------------------------------------------------- per - op
    def after_op(self, tid: int, kind: str, t_start: float) -> float:
        """Account one completed op; returns the thread's post-charge clock.

        Called by the ClockScheduler right after the op thunk ran, with the
        simulated time at which the op started (the heap key it was popped
        at).  Charges expected retries for the window, then records this
        op's own CASed roots as open intervals for successors.
        """
        nv = self._nv
        self.ops_seen += 1
        epoch = nv.epoch
        # which registered roots did this op actually CAS? (engine-tagged)
        hit_roots = []
        for w in self._roots:
            c = nv.cas_count(w)
            if c != self._last_cas_count[w]:
                self._last_cas_count[w] = c
                hit_roots.append(w)
        prof = self._profiles.get(kind)
        if prof is not None and prof.root in hit_roots \
                and self.retry_scale > 0:
            w = prof.root
            live = [(e, t, ep) for (e, t, ep) in self._inflight[w]
                    if e > t_start and epoch - ep <= self.window_ops]
            self._inflight[w] = live
            k = sum(1 for (_, t, _) in live if t != tid)
            if k:
                p = min(self.retry_scale * prof.weight * k, P_CAP)
                # geometric retry rounds, saturated at the profile's
                # (possibly trace-measured) per-op ceiling
                expected = min(p / (1.0 - p), prof.max_rounds)
                self.retries_charged += expected
                self.retries_by_root[w] = \
                    self.retries_by_root.get(w, 0.0) + expected
                for u, (codes, per_round, decays) in \
                        enumerate(self._units[kind]):
                    if decays:
                        # wider window => some other op likely re-fetched
                        # the invalidated line first; this round hits it
                        per_round = per_round * prof.flushed_scale(k)
                    key = (tid, kind, u)
                    acc = self._frac.get(key, 0.0) + expected * per_round
                    whole = int(acc)
                    self._frac[key] = acc - whole
                    if whole:
                        nv.charge_events(tid, list(codes), repeat=whole)
        t_end = nv.thread_time_ns(tid)   # includes any charged retries
        for w in hit_roots:
            lst = self._inflight[w]
            if len(lst) >= 4 * self.window_ops:   # keep windows bounded
                lst[:] = [x for x in lst
                          if x[0] > t_start and epoch - x[2] <= self.window_ops]
            # the entry's staleness anchor is the root line's access epoch,
            # stamped by this op's own CAS (engine-tracked)
            lst.append((t_end, tid, nv.line_epoch(w // LINE_WORDS)))
        return t_end

    # ------------------------------------------------------------ reporting
    def retries_per_op(self) -> float:
        return self.retries_charged / self.ops_seen if self.ops_seen else 0.0
