"""Simulated byte-addressable NVRAM -- batched, columnar cost engine.

This is the substrate for the faithful reproduction of
"Durable Queues: The Second Amendment" (Sela & Petrank, SPAA'21).

The model (paper §2):

* Memory is word-granular (one object slot per word), grouped into cache
  lines of ``LINE_WORDS`` words.  A word models an 8-byte slot; a double-width
  (16-byte) CAS target is modeled as a tuple stored in a single word slot.
* Two levels: a volatile cache and a persistent backing store.  Stores go to
  the cache; they reach the persistent store via explicit ``flush``
  (CLWB-like) + ``fence`` (SFENCE-like), via ``movnti`` (non-temporal store,
  bypassing the cache) + ``fence``, or -- at a crash -- via the adversarial
  application of a *prefix* of the line's outstanding stores (Assumption 1:
  cache lines evict atomically, so persistent content is always a prefix of
  the stores to that line).
* Platform behaviour (does a flush invalidate?  is a visible store already
  durable?) and all latencies come from a pluggable
  :class:`repro.core.memmodel.MemoryModel`.  Under the default
  ``optane-clwb`` model a flush **invalidates** the line (Cascade Lake CLWB,
  paper §1/§2) and the next access is counted as a **post-flush access** --
  the paper's key cost metric.

Engine representation (this file is the fast path; the original dict engine
survives as :class:`repro.core.nvram_ref.ReferenceNVRAM`, the oracle the
differential tests compare against):

* flat Python lists hold the coherent view and the persistent image
  (persistent and volatile address spaces are each dense; scalar list
  indexing beats numpy object arrays by ~2x per access, which matters on
  the compiled fast path);
* per-line flush state is ONE packed ``_lstate`` bytearray -- bit 0 cached,
  bit 1 flush-invalidated, bit 2 ever-flushed -- so an access classifies
  and transitions with two byte-table lookups (``TOUCH_CLASS`` /
  ``TOUCH_NEXT``) instead of three array reads and two writes, and bulk
  transitions (crash wipe, allocator-area init) are single
  ``bytes.translate`` passes;
* per-line *dirty prefixes* (the unapplied store logs that give Assumption-1
  crash semantics) are kept per line and only touched by stores, fences and
  crashes -- never by loads;
* cost accounting is **batched**: every primitive appends one small event
  code to a buffer; the buffer is reduced with ``numpy.bincount`` into a
  ``(nthreads, N_EV)`` counter matrix only when statistics are requested.
  Per-thread simulated time is the dot product of that matrix with the
  model's latency vector, so multi-thread throughput is
  ``ops / max(thread_clock)`` -- reproducing the paper's Fig. 2 *orderings*
  without real NVRAM hardware.

Every mutable container above is **identity-stable**: growth, restore and
crash mutate the existing list/bytearray/dict in place instead of rebinding
the attribute.  The compiled fast path (``repro.core.opsched``) binds these
containers into generated functions as defaults, and the columnar record
store batches whole bursts of ops into one ``charge_counts`` pass -- both
depend on the bindings staying live across snapshot/restore/crash.

Latency constants (ns) follow published Optane DC characterization
[van Renen et al., DaMoN'19; Yang et al., FAST'20].
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .memmodel import MemoryModel, get_memory_model

LINE_WORDS = 8  # 64-byte line / 8-byte words

NS = float

# ------------------------------------------------------------- event codes
# Each primitive logs one or two of these; counts x latency vector = time.
(EV_READ, EV_WRITE, EV_CAS, EV_FLUSH, EV_FENCE, EV_FENCE_LINE, EV_MOVNTI,
 EV_HIT, EV_DRAM, EV_COLD_DRAM, EV_COLD_NVM, EV_POSTFLUSH) = range(12)
N_EV = 12

# ------------------------------------------------- packed line-state bits
# One byte per line in NVRAM._lstate.  Reachable values are
# {0, 1, 4, 5, 6}: cached and flush-invalidated are mutually exclusive,
# and a line can only be invalidated by a flush (which also sets everfl).
LS_CACHED, LS_FINVAL, LS_EVERFL = 1, 2, 4

# Byte tables: packed state -> accounting outcome / post-access state for
# a fetching access (read/write/CAS RFO).  Shared with the codegen backend
# in repro.core.opsched, which inlines the same two lookups per line step.
TOUCH_CLASS = [
    EV_HIT if s & LS_CACHED else
    EV_POSTFLUSH if s & LS_FINVAL else
    EV_COLD_NVM if s & LS_EVERFL else
    EV_COLD_DRAM
    for s in range(256)]
TOUCH_NEXT = [s if s & LS_CACHED else (s & LS_EVERFL) | LS_CACHED
              for s in range(256)]

# bytes.translate tables for bulk line-state transitions
_T_EVERFL_ONLY = bytes(s & LS_EVERFL for s in range(256))      # crash wipe
_T_RECACHE = bytes((s & LS_EVERFL) | LS_CACHED for s in range(256))

# -------------------------------------------------- trace primitive codes
# Consumed by the opt-in trace tap (repro.trace.recorder.TraceRecorder).
# These are observation codes, deliberately separate from the EV_* cost
# codes: the tap sits BESIDE the cost accumulator and never feeds it.
(TR_READ, TR_WRITE, TR_WRITE_LINE, TR_CAS, TR_FLUSH, TR_FENCE,
 TR_MOVNTI) = range(7)

# Line flush-state at the moment of an access, classified BEFORE the access
# mutates cache metadata.  TS_INVALIDATED on a fetching primitive is exactly
# the engine's post-flush access (the paper's key cost).
(TS_VOLATILE, TS_CACHED, TS_COLD_DRAM, TS_COLD_NVM, TS_INVALIDATED) = range(5)


def _latency_vector(m: MemoryModel) -> np.ndarray:
    v = np.zeros(N_EV, dtype=np.float64)
    v[EV_FLUSH] = m.flush_issue_ns
    v[EV_FENCE] = m.fence_base_ns
    v[EV_FENCE_LINE] = m.fence_per_line_ns
    v[EV_MOVNTI] = m.movnti_ns
    v[EV_HIT] = m.cache_hit_ns
    v[EV_DRAM] = m.dram_miss_ns
    v[EV_COLD_DRAM] = m.dram_miss_ns
    v[EV_COLD_NVM] = m.nvram_read_ns
    v[EV_POSTFLUSH] = m.nvram_read_ns
    return v


class ThreadCrashed(Exception):
    """Raised inside a simulated thread when a crash is injected."""


@dataclass(frozen=True)
class CrashChoices:
    """Explicit adversarial crash outcome, applied by ``crash(mode='subset')``.

    The 'random' crash mode draws three kinds of decisions; this pins each
    one so the crash sweep can *enumerate* the full outcome space at a
    boundary instead of sampling it:

    * ``flush_survivors`` -- the set of ``(tid, pending-index)`` flush
      entries that reach NVRAM;
    * ``nt_prefix`` -- per ``(tid, line)``, how many of the thread's
      pending NT stores to that line persist (a *prefix*: WC buffers drain
      in issue order and the line evicts atomically);
    * ``log_prefix`` -- per line, how many of its unapplied stores persist
      (a prefix, Assumption 1).

    Prefixes are clamped to what actually remains once the surviving
    flushes have been applied, so enumerating against the pre-crash log
    lengths over-covers harmlessly (duplicate outcomes, never missed ones).
    """
    flush_survivors: frozenset = frozenset()   # {(tid, pending_index)}
    nt_prefix: tuple = ()                      # (((tid, line), k), ...)
    log_prefix: tuple = ()                     # ((line, k), ...)


class EngineSnapshot:
    """Frozen copy of an engine's *memory* state -- never its accounting.

    Captured by :meth:`NVRAM.snapshot`, reapplied by :meth:`NVRAM.restore`.
    The event buffer and counter matrix are deliberately excluded: Stats
    are monotonic instruments of work *performed*, and restoring memory
    state must not rewind or perturb them (the crash-sweep tests assert a
    snapshot/restore round-trip leaves Stats bit-identical).  Op-record
    cursors live one layer up, in :class:`repro.core.records.RecordStore`
    (snapshotted alongside this by the crash capture seam).

    ``volatile=False`` captures a crash-sufficient snapshot only (the
    persistent image, store logs, pending-persist sets and line history --
    ``lstate`` is masked down to the ever-flushed bit): restoring one is
    only meaningful when immediately followed by :meth:`NVRAM.crash`,
    which discards volatile state anyway.  The crash sweep takes one such
    snapshot per scheduler step, so the smaller footprint matters.
    """

    __slots__ = ("nthreads", "brk", "vbrk", "regions", "pmem", "log",
                 "log_start", "pending", "lstate", "crashed", "has_volatile",
                 "vis", "vval", "vtouched")

    def __init__(self, nv: "NVRAM", volatile: bool = True):
        self.nthreads = nv.nthreads
        self.brk = nv._brk
        self.vbrk = nv._vbrk
        self.regions = tuple(nv.regions)
        self.pmem = nv._pmem[:nv._brk]          # list slice == copy
        self.log = {ln: list(entries) for ln, entries in nv._log.items()
                    if entries}
        nl = -(-nv._brk // LINE_WORDS)
        self.log_start = nv._log_start[:nl]      # list slice == copy
        self.pending = {t: list(pl) for t, pl in nv._pending.items()}
        self.crashed = nv.crashed
        self.has_volatile = volatile
        if volatile:
            self.lstate = bytes(nv._lstate[:nl])
            self.vis = nv._vis[:nv._brk]
            vused = nv._vbrk - NVRAM._VOLATILE_BASE
            self.vval = nv._vval[:vused].copy()   # ndarray slice is a view
            self.vtouched = bytes(nv._vtouched[:vused])
        else:
            # crash-sufficient: only the ever-flushed history matters
            self.lstate = bytes(nv._lstate[:nl]).translate(_T_EVERFL_ONLY)


@dataclass
class Stats:
    """Per-thread persistence/cost counters (paper metrics)."""
    reads: int = 0
    writes: int = 0
    cas: int = 0
    flushes: int = 0
    fences: int = 0
    movntis: int = 0
    post_flush_accesses: int = 0   # accesses to a line invalidated by CLWB
    cold_misses: int = 0
    time_ns: NS = 0.0

    def snapshot(self) -> "Stats":
        return Stats(**self.__dict__)

    def minus(self, other: "Stats") -> "Stats":
        return Stats(**{k: getattr(self, k) - getattr(other, k)
                        for k in self.__dict__})

    def add(self, other: "Stats") -> None:
        for k in self.__dict__:
            setattr(self, k, getattr(self, k) + getattr(other, k))


class NVRAM:
    """Two-level (cache + persistent) memory simulator, columnar state."""

    _VOLATILE_BASE = 1 << 40   # volatile addresses live far above

    def __init__(self, nthreads: int = 1,
                 step_hook: Optional[Callable[[int, str], None]] = None,
                 model: Union[str, MemoryModel, None] = None):
        self.nthreads = nthreads
        self.step_hook = step_hook          # scheduler yield point
        self.model = get_memory_model(model)
        self._ns_vec = _latency_vector(self.model)
        # --- persistent space (dense, addr is the index) ------------------
        # All containers below are identity-stable: grown/cleared in place,
        # never rebound (compiled fast-path functions hold them as bound
        # defaults across snapshot/restore/crash).
        cap = 1024
        self._pcap = cap
        # the persistent planes stay plain lists: the compiled per-op
        # paths do dozens of scalar/slice accesses per op and lists are
        # measurably faster there (ndarray slice-assign alone costs ~2.5x).
        # The burst executor batches its p-plane stores with C-level
        # map(list.__setitem__) passes instead of fancy indexing.
        self._pmem: List[Any] = [None] * cap        # persistent image
        self._vis: List[Any] = [None] * cap         # coherent (cached) view
        # packed per-line flush state (LS_CACHED|LS_FINVAL|LS_EVERFL bits)
        self._lstate = bytearray(cap // LINE_WORDS)
        # per-line dirty prefix: unapplied stores (crash Assumption 1)
        self._log: Dict[int, List[Tuple[int, Any]]] = {}
        # absolute log position already persisted, indexed by line.  Stays
        # a plain list: the per-op paths do scalar `+=` on it (ndarray
        # scalar read-modify-write is ~3x slower and leaks np.int64 into
        # downstream arithmetic); the burst path batches its updates with
        # one C-level map(__setitem__) pass instead.
        self._log_start: List[int] = [0] * (cap // LINE_WORDS)
        # pending persists per thread: ('flush', line, upto) | ('nt', addr, v)
        self._pending: Dict[int, List[Tuple]] = {t: [] for t in range(nthreads)}
        # --- volatile space (dense above _VOLATILE_BASE) ------------------
        vcap = 1024
        self._vcap = vcap
        # the volatile value plane IS an object ndarray: the volatile-only
        # fast paths touch it a handful of times per op (cheap either
        # way), and it is exactly where the burst executor's vectorized
        # apply lands whole bursts of stores as one fancy-indexed scatter.
        # np.empty(object) initializes to None.
        self._vval = np.empty(vcap, dtype=object)
        self._vtouched = bytearray(vcap)
        # --- address-space management (address 0 is reserved as NULL) -----
        self._brk = LINE_WORDS
        self._vbrk = self._VOLATILE_BASE
        self.regions: List[Tuple[str, int, int, bool]] = []
        # --- contention bookkeeping (read by repro.core.contention; never
        # consulted by the cost accounting itself).  Tag/epoch stamping is
        # gated on contention_tracking (set by ContentionModel.begin_run) so
        # uncontended runs and the exact scheduler pay nothing for it.
        self.contention_tracking = False
        self.epoch = 0                        # clock-window tick (scheduler)
        self._line_epoch: Dict[int, int] = {}   # line -> last access epoch
        self._cas_words: Dict[int, int] = {}    # CAS target word -> attempts
        # --- trace tap (read-only observer; see repro.trace) --------------
        # When attached, every primitive reports (tid, TR_* code, addr,
        # TS_* pre-access line state, aux) to the tap.  The tap never
        # touches the event buffer or counters, so Stats are bit-identical
        # with and without it; when None the cost is one predicate per
        # primitive.
        self._tap = None
        # Benchmarking escape hatch: False forces allocator-area zeroing
        # back onto the per-primitive path (the seed behavior), so the
        # fastpath smoke can report an honest fully-per-op baseline.
        self.enable_bulk_init = True
        # --- batched cost accumulator -------------------------------------
        self._ebuf: List[int] = []            # packed tid * N_EV + code
        self._counts = np.zeros((nthreads, N_EV), dtype=np.int64)
        self._tls = threading.local()
        self.crashed = False
        # recovery-work tallies (crash-sweep reporting axis; not Stats)
        self.pread_count = 0
        self.pwrite_count = 0
        self._lock = threading.Lock()   # guards structural mutation (alloc)

    # ------------------------------------------------------------ thread id
    def set_tid(self, tid: int) -> None:
        self._tls.tid = tid

    @property
    def tid(self) -> int:
        return getattr(self._tls, "tid", 0)

    def _step(self, kind: str) -> None:
        if self.step_hook is not None:
            self.step_hook(self.tid, kind)

    # ------------------------------------------------------------ trace tap
    def set_trace_tap(self, tap) -> None:
        """Attach/detach (None) a trace observer (repro.trace recorder).

        The tap receives ``on_prim(tid, prim, addr, state, aux)`` per
        primitive -- a pure observation seam above/beside the cost
        accumulator; attaching one cannot perturb Stats.
        """
        self._tap = tap

    def _line_state(self, addr: int) -> int:
        """TS_* classification of `addr`'s line, pre-access (tap only)."""
        if addr >= self._VOLATILE_BASE:
            return TS_VOLATILE
        s = self._lstate[addr // LINE_WORDS]
        if s & LS_CACHED:
            return TS_CACHED
        if s & LS_FINVAL:
            return TS_INVALIDATED
        if s & LS_EVERFL:
            return TS_COLD_NVM
        return TS_COLD_DRAM

    # --------------------------------------------------------- address space
    def _grow_p(self, need: int) -> None:
        cap = self._pcap
        while cap < need:
            cap *= 2
        add = cap - self._pcap
        self._pmem.extend([None] * add)
        self._vis.extend([None] * add)
        self._lstate.extend(bytes(add // LINE_WORDS))
        self._log_start.extend([0] * (add // LINE_WORDS))
        self._pcap = cap

    def _grow_v(self, need: int) -> None:
        cap = self._vcap
        while cap < need:
            cap *= 2
        add = cap - self._vcap
        # in-place growth: ndarray.resize keeps the array object itself
        # (the compiled fast path holds it as a bound default); the new
        # cells must be re-initialized to None (resize zero-fills)
        self._vval.resize(cap, refcheck=False)
        self._vval[self._vcap:] = None
        self._vtouched.extend(bytes(add))
        self._vcap = cap

    def alloc_region(self, nwords: int, name: str = "region",
                     persistent: bool = True) -> int:
        """Allocate a line-aligned region; returns base address."""
        with self._lock:
            if persistent:
                base = (self._brk + LINE_WORDS - 1) // LINE_WORDS * LINE_WORDS
                self._brk = base + nwords
                if self._brk > self._pcap:
                    self._grow_p(self._brk)
            else:
                base = (self._vbrk + LINE_WORDS - 1) // LINE_WORDS * LINE_WORDS
                self._vbrk = base + nwords
                if self._vbrk - self._VOLATILE_BASE > self._vcap:
                    self._grow_v(self._vbrk - self._VOLATILE_BASE)
            self.regions.append((name, base, nwords, persistent))
            return base

    def is_persistent_addr(self, addr: int) -> bool:
        return addr < self._VOLATILE_BASE

    @staticmethod
    def line_of(addr: int) -> int:
        return addr // LINE_WORDS

    # ------------------------------------------------------- cache mechanics
    def _touch(self, line: int, tid: int) -> None:
        """Account for bringing `line` into cache (persistent space)."""
        if self.contention_tracking:
            self._line_epoch[line] = self.epoch
        s = self._lstate[line]
        self._ebuf.append(tid * N_EV + TOUCH_CLASS[s])
        self._lstate[line] = TOUCH_NEXT[s]

    # ------------------------------------------------------------ primitives
    def read(self, addr: int) -> Any:
        self._step("read")
        tid = self.tid
        if self._tap is not None:
            self._tap.on_prim(tid, TR_READ, addr, self._line_state(addr), -1)
        self._ebuf.append(tid * N_EV + EV_READ)
        if addr >= self._VOLATILE_BASE:
            i = addr - self._VOLATILE_BASE
            if self._vtouched[i]:
                self._ebuf.append(tid * N_EV + EV_HIT)
            else:
                self._ebuf.append(tid * N_EV + EV_DRAM)
                self._vtouched[i] = 1
            return self._vval[i]
        self._touch(addr // LINE_WORDS, tid)
        return self._vis[addr]

    def write(self, addr: int, value: Any) -> None:
        self._step("write")
        tid = self.tid
        if self._tap is not None:
            self._tap.on_prim(tid, TR_WRITE, addr, self._line_state(addr), -1)
        self._ebuf.append(tid * N_EV + EV_WRITE)
        if addr >= self._VOLATILE_BASE:
            i = addr - self._VOLATILE_BASE
            if self._vtouched[i]:
                self._ebuf.append(tid * N_EV + EV_HIT)
            else:
                self._ebuf.append(tid * N_EV + EV_DRAM)
                self._vtouched[i] = 1
            self._vval[i] = value
            return
        line = addr // LINE_WORDS
        self._touch(line, tid)              # write-allocate (RFO)
        self._vis[addr] = value
        if self.model.persist_on_store:
            self._pmem[addr] = value        # visible => durable: no log
        else:
            self._log.setdefault(line, []).append((addr, value))

    def write_full_line(self, base_addr: int, values: List[Any]) -> None:
        """Full-line store without read-for-ownership (models allocator /
        node initialization via fast-string or full-line NT stores -- no
        fetch, hence *not* a post-flush access).  Used only when every word
        of the line is overwritten."""
        self._step("write")
        tid = self.tid
        if self._tap is not None:
            # no fetch: the pre-state is recorded but a full-line store is
            # never a post-flush access (analysis treats it as non-fetching)
            self._tap.on_prim(tid, TR_WRITE_LINE, base_addr,
                              self._line_state(base_addr), -1)
        self._ebuf.append(tid * N_EV + EV_WRITE)
        self._ebuf.append(tid * N_EV + EV_HIT)
        assert base_addr % LINE_WORDS == 0 and len(values) <= LINE_WORDS
        if base_addr >= self._VOLATILE_BASE:
            i = base_addr - self._VOLATILE_BASE
            for k, v in enumerate(values):
                self._vval[i + k] = v
                self._vtouched[i + k] = 1
            return
        line = base_addr // LINE_WORDS
        self._lstate[line] = (self._lstate[line] & LS_EVERFL) | LS_CACHED
        if self.model.persist_on_store:
            for k, v in enumerate(values):
                self._vis[base_addr + k] = v
                self._pmem[base_addr + k] = v
            return
        log = self._log.setdefault(line, [])
        for k, v in enumerate(values):
            self._vis[base_addr + k] = v
            log.append((base_addr + k, v))

    def cas(self, addr: int, expected: Any, new: Any) -> bool:
        """Atomic compare-and-swap (one scheduler step).  Double-width CAS is
        modeled by storing a tuple at a single word address (paper §5.1.2)."""
        self._step("cas")
        tid = self.tid
        tap = self._tap
        state = self._line_state(addr) if tap is not None else 0
        self._ebuf.append(tid * N_EV + EV_CAS)
        # tag the CAS target word + stamp its line's access epoch (contention
        # bookkeeping; persistent-space lines are stamped inside _touch)
        if self.contention_tracking:
            self._cas_words[addr] = self._cas_words.get(addr, 0) + 1
            if addr >= self._VOLATILE_BASE:
                self._line_epoch[addr // LINE_WORDS] = self.epoch
        if addr >= self._VOLATILE_BASE:
            i = addr - self._VOLATILE_BASE
            if self._vtouched[i]:
                self._ebuf.append(tid * N_EV + EV_HIT)
            else:
                self._ebuf.append(tid * N_EV + EV_DRAM)
                self._vtouched[i] = 1
            ok = self._vval[i] == expected
            if ok:
                self._vval[i] = new
        else:
            line = addr // LINE_WORDS
            self._touch(line, tid)
            ok = self._vis[addr] == expected
            if ok:
                self._vis[addr] = new
                if self.model.persist_on_store:
                    self._pmem[addr] = new
                else:
                    self._log.setdefault(line, []).append((addr, new))
        if tap is not None:
            tap.on_prim(tid, TR_CAS, addr, state, 1 if ok else 0)
        return bool(ok)

    def flush(self, addr: int) -> None:
        """Asynchronous CLWB: schedule write-back of the whole containing
        line; under an invalidating model (Cascade Lake) also evict it."""
        self._step("flush")
        tid = self.tid
        if self._tap is not None:
            self._tap.on_prim(tid, TR_FLUSH, addr, self._line_state(addr), -1)
        self._ebuf.append(tid * N_EV + EV_FLUSH)
        assert addr < self._VOLATILE_BASE, "flushing volatile memory"
        line = addr // LINE_WORDS
        upto_abs = self._log_start[line] + len(self._log.get(line, ()))
        self._pending[tid].append(("flush", line, upto_abs))
        if self.model.flush_invalidates:
            self._lstate[line] = LS_FINVAL | LS_EVERFL
        else:
            self._lstate[line] |= LS_EVERFL

    def movnti(self, addr: int, value: Any) -> None:
        """Non-temporal store: straight to the memory write queue; does not
        touch or pollute the cache (paper §6.3).  Needs a fence to complete.
        NT stores are globally visible immediately (x86 coherence)."""
        self._step("movnti")
        tid = self.tid
        if self._tap is not None:
            self._tap.on_prim(tid, TR_MOVNTI, addr, self._line_state(addr), -1)
        self._ebuf.append(tid * N_EV + EV_MOVNTI)
        assert addr < self._VOLATILE_BASE
        self._vis[addr] = value
        self._pending[tid].append(("nt", addr, value))

    def fence(self) -> None:
        """SFENCE: block until all of this thread's outstanding flushes and
        NT stores are persistent."""
        self._step("fence")
        tid = self.tid
        if self._tap is not None:
            # aux = outstanding persist entries this fence will drain
            self._tap.on_prim(tid, TR_FENCE, -1, -1, len(self._pending[tid]))
        self._ebuf.append(tid * N_EV + EV_FENCE)
        pend = self._pending[tid]
        if pend:
            # drain cost scales with distinct lines: WC buffers combine NT
            # stores to one line, and flush entries of a line coalesce
            lines = {(e[1] if e[0] == "flush" else e[1] // LINE_WORDS)
                     for e in pend}
            self._counts[tid, EV_FENCE_LINE] += len(lines)
            for ent in pend:
                self._apply_persist(ent)
            pend.clear()

    def persist(self, addr: int) -> None:
        """flush + fence convenience (the paper's 'persisting a location')."""
        self.flush(addr)
        self.fence()

    # --------------------------------------------------------------- persist
    def _apply_persist(self, ent: Tuple) -> None:
        if ent[0] == "flush":
            _, line, upto_abs = ent
            log = self._log.get(line, [])
            start = self._log_start[line]
            count = upto_abs - start
            if count <= 0:
                return          # already applied by a later/earlier fence
            count = min(count, len(log))
            for (a, v) in log[:count]:
                self._pmem[a] = v
            del log[:count]
            self._log_start[line] = start + count
        else:
            _, addr, v = ent
            self._pmem[addr] = v

    # ------------------------------------------------------ snapshot/restore
    def snapshot(self, volatile: bool = True) -> EngineSnapshot:
        """Capture this engine's memory state (see :class:`EngineSnapshot`).

        Pure observation: nothing is appended to the event buffer and no
        counter moves, so taking a snapshot cannot perturb Stats.  With
        ``volatile=False`` only the crash-relevant state is copied (the
        persistent image, per-line store logs, pending-persist sets and
        ever-flushed history) -- restore such a snapshot only to crash() it.
        """
        return EngineSnapshot(self, volatile=volatile)

    def restore(self, snap: EngineSnapshot) -> None:
        """Reapply a snapshot's memory state in place.

        The address space (break pointers + region table) rewinds to the
        snapshot's, so regions allocated afterwards are forgotten -- their
        addresses will be handed out again and rewritten before any read
        (the allocators zero or fully initialize before use).  Cost
        accounting is untouched: Stats remain whatever the engine has
        accumulated, because restore models *state transplantation*, not
        un-executing work.  Every container is refilled in place (the
        compiled fast path holds them as bound defaults).
        """
        if snap.nthreads != self.nthreads:
            raise ValueError(
                f"snapshot taken with nthreads={snap.nthreads}, "
                f"engine has {self.nthreads}")
        if snap.brk > self._pcap:
            self._grow_p(snap.brk)
        vused = snap.vbrk - self._VOLATILE_BASE
        if vused > self._vcap:
            self._grow_v(vused)
        self._brk = snap.brk
        self._vbrk = snap.vbrk
        self.regions = list(snap.regions)
        self._pmem[:snap.brk] = snap.pmem
        nl = len(snap.log_start)
        ls = self._log_start
        ls[:] = [0] * len(ls)
        ls[:nl] = snap.log_start
        self._log.clear()
        for ln, entries in snap.log.items():
            self._log[ln] = list(entries)
        for t, pl in snap.pending.items():
            self._pending[t][:] = pl
        self.crashed = snap.crashed
        st = self._lstate
        st[:] = bytes(len(st))
        st[:nl] = snap.lstate          # full bits, or everfl-only (crash-
        vt = self._vtouched            # sufficient snapshot)
        if snap.has_volatile:
            self._vis[:snap.brk] = snap.vis
            self._vval[:vused] = snap.vval
            vt[:] = bytes(len(vt))
            vt[:vused] = snap.vtouched
        else:
            # crash-only snapshot: give the volatile level a post-crash-like
            # default (coherent view = persistent image, cold caches) so a
            # restore is well-defined even before crash() wipes it for real
            self._vis[:snap.brk] = snap.pmem
            vt[:] = bytes(len(vt))
        # contention bookkeeping is a per-run measurement aid, not memory
        # state: clear it rather than time-travel it
        self._line_epoch.clear()
        self._cas_words.clear()

    # ----------------------------------------------------------------- crash
    def crash(self, mode: str = "random", seed: int = 0,
              choices: Optional[CrashChoices] = None) -> None:
        """Full-system crash (paper §2 failure model).

        mode='min'    -- nothing beyond fenced state survives (pending flushes
                         and NT stores are dropped; un-flushed stores lost).
        mode='random' -- each pending flush/NT store independently survives;
                         additionally each line persists a random *prefix* of
                         its remaining stores (implicit eviction, Assumption 1).
        mode='max'    -- everything reaches NVRAM (all stores applied).
        mode='subset' -- the outcome pinned by ``choices`` (a
                         :class:`CrashChoices`): the crash sweep uses this to
                         exhaustively enumerate every adversarial outcome at
                         a boundary when the pending set is small.
        Under a persist-on-store model (eADR) every visible store is durable,
        so all modes behave like 'max'.  Volatile memory (cache + DRAM space)
        is wiped regardless.
        """
        rng = random.Random(seed)
        self.crashed = True
        if mode == "max" or self.model.persist_on_store:
            for plist in self._pending.values():
                for ent in plist:
                    self._apply_persist(ent)
            for line, log in self._log.items():
                for (a, v) in log:
                    self._pmem[a] = v
        elif mode == "random":
            for plist in self._pending.values():
                # flush entries may survive independently: applying a later
                # flush of a line subsumes earlier ones (prefix-safe).
                for ent in plist:
                    if ent[0] == "flush" and rng.random() < 0.5:
                        self._apply_persist(ent)
                # NT stores to the same line combine in the WC buffer and the
                # line evicts atomically (Assumption 1): per line, a *prefix*
                # of the thread's NT stores survives, in issue order.
                nt_by_line: Dict[int, List[Tuple]] = {}
                for ent in plist:
                    if ent[0] == "nt":
                        nt_by_line.setdefault(ent[1] // LINE_WORDS,
                                              []).append(ent)
                for line, ents in nt_by_line.items():
                    k = rng.randint(0, len(ents))
                    for ent in ents[:k]:
                        self._apply_persist(ent)
            for line, log in list(self._log.items()):
                if log:
                    k = rng.randint(0, len(log))  # prefix (Assumption 1)
                    for (a, v) in log[:k]:
                        self._pmem[a] = v
        elif mode == "subset":
            # same decision structure as 'random', but every draw is pinned
            # by `choices`; prefixes clamp to what remains after the chosen
            # flushes applied (see CrashChoices)
            ch = choices if choices is not None else CrashChoices()
            nt_pref = dict(ch.nt_prefix)
            for t in sorted(self._pending):
                plist = self._pending[t]
                nt_by_line: Dict[int, List[Tuple]] = {}
                for i, ent in enumerate(plist):
                    if ent[0] == "flush":
                        if (t, i) in ch.flush_survivors:
                            self._apply_persist(ent)
                    else:
                        nt_by_line.setdefault(ent[1] // LINE_WORDS,
                                              []).append(ent)
                for line, ents in nt_by_line.items():
                    k = min(nt_pref.get((t, line), 0), len(ents))
                    for ent in ents[:k]:
                        self._apply_persist(ent)
            log_pref = dict(ch.log_prefix)
            for line, log in list(self._log.items()):
                k = min(log_pref.get(line, 0), len(log))
                for (a, v) in log[:k]:
                    self._pmem[a] = v
        elif mode == "min":
            pass
        else:
            raise ValueError(mode)
        # volatile state is gone: the coherent view collapses onto the
        # persistent image, DRAM space and all cache metadata are wiped
        # (in place: the compiled fast path holds these containers)
        for plist in self._pending.values():
            plist.clear()
        self._log.clear()
        self._log_start[:] = [0] * len(self._log_start)
        self._vis[:] = self._pmem
        self._lstate[:] = self._lstate.translate(_T_EVERFL_ONLY)
        self._vval[:] = [None] * len(self._vval)
        self._vtouched[:] = bytes(len(self._vtouched))

    # ------------------------------------------------------ recovery access
    def pread(self, addr: int) -> Any:
        """Recovery-time direct read of the persistent image (not on the
        fast path; costs are accounted separately by the harness).  The
        plain `pread_count` tally feeds the crash sweep's recovery-work
        axis; it is not part of Stats."""
        self.pread_count += 1
        return self._pmem[addr]

    def pwrite(self, addr: int, value: Any) -> None:
        """Recovery-time direct persistent write (recovery persists its
        reconstruction before normal operation resumes)."""
        self.pwrite_count += 1
        self._pmem[addr] = value
        self._vis[addr] = value

    def reset_after_recovery(self) -> None:
        """Recovery is complete: resume normal (cached) operation."""
        self.crashed = False

    # --------------------------------------------------------- state export
    def line_state_arrays(self, nlines: int) -> Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]:
        """Unpack the first `nlines` of ``_lstate`` into (cached, finval,
        everfl) ``uint8`` arrays -- the fleet state exporter's layout
        (:mod:`repro.fleet.state` tiles these across instances)."""
        s = np.frombuffer(bytes(self._lstate[:nlines]), dtype=np.uint8)
        return ((s & LS_CACHED).astype(np.uint8),
                ((s & LS_FINVAL) >> 1).astype(np.uint8),
                ((s & LS_EVERFL) >> 2).astype(np.uint8))

    def vtouched_array(self, nwords: int) -> np.ndarray:
        """First `nwords` of the volatile touched map as a ``uint8`` copy."""
        return np.frombuffer(bytes(self._vtouched[:nwords]),
                             dtype=np.uint8).copy()

    # ---------------------------------------------------- contention seam
    # The contention layer (repro.core.contention) lives ABOVE this cost
    # accumulator: it reads the tags/epochs below and feeds extra event
    # codes through charge_events -- it never alters how a primitive is
    # accounted, so single-thread runs stay bit-identical to the oracle.
    def cas_count(self, addr: int) -> int:
        """How many CAS attempts have targeted `addr` (tagged in cas())."""
        return self._cas_words.get(addr, 0)

    def cas_targets(self) -> Dict[int, int]:
        """All tagged CAS target words with their attempt counts."""
        return dict(self._cas_words)

    def line_epoch(self, line: int) -> int:
        """Last clock-window epoch at which `line` was accessed (-1 never).

        Epochs are ticked by the batched scheduler (one per executed op);
        under the exact scheduler they stay 0 and this bookkeeping is inert.
        """
        return self._line_epoch.get(line, -1)

    def charge_events(self, tid: int, codes: List[int],
                      repeat: int = 1) -> None:
        """Append pre-classified event codes to thread `tid`'s account.

        `codes` are EV_* values (one retry round's shape); they flow into
        the same bincount reduction as real primitives, so charged retries
        advance the thread's simulated clock and all Stats counters.
        """
        buf = self._ebuf
        base = tid * N_EV
        for _ in range(repeat):
            for c in codes:
                buf.append(base + c)

    # ------------------------------------------------- compiled-op seam
    # The schedule compiler (repro.core.opsched) replays a queue op's
    # event shape as ONE pre-reduced count vector instead of dozens of
    # event-buffer appends.  Charging goes straight into the counter
    # matrix -- the same destination the bincount reduction feeds -- so
    # compiled and per-primitive execution produce identical counts and
    # identical (dot-product) thread clocks.  The columnar record store
    # (repro.core.records.RecordStore) batches a whole burst of compiled
    # ops into a handful of charge_counts calls (one per distinct
    # (outcome-key, tid, kind) triple).
    def charge_counts(self, tid: int, vec: np.ndarray) -> None:
        """Add one compiled op's (N_EV,) event-count vector to `tid`."""
        self._counts[tid] += vec

    def bulk_line_init(self, base: int, nlines: int) -> None:
        """Vectorized allocator-area init: the exact accounting + state
        effects of, per line, ``write_full_line(a, [0]*LINE_WORDS)`` (+
        ``flush(a)`` when the model needs flushes) followed by ONE
        ``fence()`` -- the ssmem designated-area zeroing schedule (paper
        §5.1.3).  Event counts, line state, the persistent image and the
        per-line ``_log_start`` positions come out bit-identical to the
        per-primitive sequence; only the Python-loop overhead (tens of
        milliseconds per 4096-node area) is removed.

        Callers (``SSMem._new_area``) must only use this when no
        scheduler step hook and no trace tap are attached: the compiled
        form has no per-primitive yield points to report.
        """
        assert self.step_hook is None and self._tap is None
        tid = self.tid
        lo, hi = base, base + nlines * LINE_WORDS
        line0 = base // LINE_WORDS
        self._drain()
        c = self._counts[tid]
        c[EV_WRITE] += nlines          # one full-line store per line
        c[EV_HIT] += nlines
        zeros = [0] * (hi - lo)
        self._vis[lo:hi] = zeros
        self._pmem[lo:hi] = zeros
        seg = slice(line0, line0 + nlines)
        if self.model.persist_on_store:
            # eADR: stores persist on visibility; pflush is elided and the
            # fence drains nothing
            self._lstate[seg] = self._lstate[seg].translate(_T_RECACHE)
            c[EV_FENCE] += 1
            return
        # flush-based platforms: every line is flushed once, then one
        # fence drains all nlines distinct lines
        c[EV_FLUSH] += nlines
        c[EV_FENCE] += 1
        c[EV_FENCE_LINE] += nlines
        if self.model.flush_invalidates:
            self._lstate[seg] = bytes([LS_FINVAL | LS_EVERFL]) * nlines
        else:
            self._lstate[seg] = bytes([LS_CACHED | LS_EVERFL]) * nlines
        # the LINE_WORDS zero-stores per line were logged and drained by
        # the fence: logs end empty with the start cursor advanced (past
        # any pre-existing unapplied entries too -- the zeros overwrote
        # whatever values those would have applied)
        ls = self._log_start
        log = self._log
        for ln in range(line0, line0 + nlines):
            pre = log.get(ln)
            ls[ln] += LINE_WORDS + (len(pre) if pre else 0)
            if pre:
                pre.clear()

    # ------------------------------------------------------------- reporting
    def _drain(self) -> None:
        """Reduce the event buffer into the counter matrix (vectorized)."""
        if self._ebuf:
            cnt = np.bincount(np.asarray(self._ebuf, dtype=np.int64),
                              minlength=self.nthreads * N_EV)
            self._counts += cnt.reshape(self.nthreads, N_EV)
            self._ebuf.clear()

    def _stats_of(self, c: np.ndarray) -> Stats:
        return Stats(
            reads=int(c[EV_READ]), writes=int(c[EV_WRITE]),
            cas=int(c[EV_CAS]), flushes=int(c[EV_FLUSH]),
            fences=int(c[EV_FENCE]), movntis=int(c[EV_MOVNTI]),
            post_flush_accesses=int(c[EV_POSTFLUSH]),
            cold_misses=int(c[EV_COLD_DRAM] + c[EV_COLD_NVM]),
            time_ns=float(c @ self._ns_vec))

    @property
    def stats(self) -> Dict[int, Stats]:
        """Per-thread Stats, materialized on demand from the counter matrix."""
        self._drain()
        return {t: self._stats_of(self._counts[t])
                for t in range(self.nthreads)}

    def total_stats(self) -> Stats:
        self._drain()
        return self._stats_of(self._counts.sum(axis=0))

    def thread_time_ns(self, tid: int) -> float:
        """Simulated clock of one thread (drains the event buffer)."""
        self._drain()
        return float(self._counts[tid] @ self._ns_vec)

    def thread_times_ns(self) -> np.ndarray:
        """All per-thread clocks at once (vectorized)."""
        self._drain()
        return self._counts @ self._ns_vec

    def sim_time_ns(self) -> NS:
        """Makespan across per-thread clocks."""
        times = self.thread_times_ns()
        return float(times.max()) if len(times) else 0.0
