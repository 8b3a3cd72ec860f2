"""Columnar op-record / event store -- the batched engine's bookkeeping.

Per-op Python bookkeeping (an ``OpRecord`` object + a list append + an
event-tuple append per op) was the ~10µs/op floor under the compiled fast
path once the memory simulation itself got cheap.  This module replaces it
with a **columnar store**: preallocated numpy columns + cursors for op
records (tid, kind, per-thread seq, start/end clock, per-op event-count
vector, item, completed) and for linearization events (interned kind code +
payload), with two write paths:

* **staged** (the compiled fast path): each generated op function appends
  one packed integer ``key << 9 | tid << 1 | kind`` plus the item and the
  post-op clock to three staging buffers (two typed ``array`` buffers + an
  item list) -- ~3 appends per op, no objects.  :meth:`RecordStore.sync`
  then materializes a whole burst in one vector pass: the typed buffers
  convert to numpy through the buffer protocol (a memcpy, not a
  per-element walk), then column scatter, per-thread seq/clock chains,
  event rows, and the engine charge -- one
  :meth:`repro.core.nvram.NVRAM.charge_counts` call per distinct
  (outcome-key, tid, kind) triple instead of per op.

* **direct** (real per-primitive execution, recovery, the exact
  scheduler): :meth:`begin_op` / :meth:`complete_op` /
  :meth:`append_event` append single rows under a lock, flushing any
  staged burst first so global order is preserved.

Capacity is preallocated and **auto-grows by doubling, preserving
contents**; a ``max_records`` bound makes exhaustion an explicit
:class:`RecordCapacityError` -- never a silent truncation.  Cursors
snapshot/restore with memory state (:meth:`snapshot` / :meth:`restore`),
the seam the crash sweep rides.

The legacy list-of-``OpRecord`` path survives behind
``QueueHarness(records="legacy")`` as the differential reference; the
equivalence suite (``tests/test_columnar_equivalence.py``) pins both
representations bit-identical.  :class:`OpsView` / :class:`EventsView`
give the store the mutable-list surface the rest of the repo programs
against (``harness.ops`` / ``harness.events``).
"""
from __future__ import annotations

import threading
from array import array
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from .nvram import N_EV

KIND_NAMES = ("enq", "deq")
KIND_CODES = {"enq": 0, "deq": 1}

# staging-word layout: key << META_KEY_SHIFT | tid << 1 | kind-bit.
# tid must fit 8 bits and key must leave the int64 sign bit clear, hence
# the executor only stages when nthreads <= 256 and n_class <= MAX_NCLASS
# (4 bits per classification nibble: 9 + 4*13 = 61 bits).
META_KEY_SHIFT = 9
MAX_STAGED_NCLASS = 13
MAX_STAGED_THREADS = 256

_UNSET = object()


class RecordCapacityError(RuntimeError):
    """The store needs more rows than its explicit ``max_records`` bound.

    Raised instead of dropping records: capacity exhaustion must never
    silently truncate an op history the linearizability checker reads.
    """


@dataclass
class OpRecord:
    tid: int
    kind: str            # 'enq' | 'deq'
    item: Any = None     # for enq: item; for deq: returned item (or None)
    completed: bool = False


def _grown(a: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + a.shape[1:], dtype=a.dtype) \
        if a.dtype != object else np.empty((cap,) + a.shape[1:], dtype=object)
    out[:len(a)] = a
    return out


class RecordStore:
    """Preallocated op/event columns + cursors (see module docstring)."""

    def __init__(self, nthreads: int, op_capacity: int = 1024,
                 event_capacity: int = 1024,
                 max_records: Optional[int] = None):
        self.nthreads = nthreads
        self.max_records = max_records
        op_capacity = max(1, min(op_capacity, max_records or op_capacity))
        event_capacity = max(1, event_capacity)
        # ---- op columns (row = one enqueue/dequeue) ----------------------
        self.tid = np.zeros(op_capacity, dtype=np.int32)
        self.kind = np.zeros(op_capacity, dtype=np.uint8)      # KIND_CODES
        self.seq = np.zeros(op_capacity, dtype=np.int64)       # per-thread
        self.t_start = np.zeros(op_capacity, dtype=np.float64)
        self.t_end = np.zeros(op_capacity, dtype=np.float64)
        self.completed = np.zeros(op_capacity, dtype=np.uint8)
        # per-op event-count vector: populated for compiled (staged) ops --
        # base counts + dynamic outcomes; direct rows account through the
        # engine's event buffer instead and stay zero here
        self.ev = np.zeros((op_capacity, N_EV), dtype=np.int64)
        self.items = np.empty(op_capacity, dtype=object)
        self.n_ops = 0
        # ---- event columns (row = one serialized event tuple) ------------
        self.ev_code = np.zeros(event_capacity, dtype=np.int32)
        # 1 = (name,);  2 = (name, payload);  -1 = payload is the raw tuple
        self.ev_arity = np.zeros(event_capacity, dtype=np.int8)
        self.ev_payload = np.empty(event_capacity, dtype=object)
        self.n_events = 0
        # event-kind interning
        self._codes: dict = {}
        self._names: List[str] = []
        # ---- staging (compiled fast path; identity-stable buffers bound
        # into the generated op functions as positional defaults).  The
        # meta/clock buffers are typed arrays so sync() converts them to
        # numpy via the buffer protocol instead of walking Python ints ----
        self._sm = array("q")         # packed key/tid/kind words
        self._si: List[Any] = []      # op items (enq item / deq result)
        self._st = array("d")         # post-op thread clocks
        # burst item chunks: (stream position, object ndarray) -- whole
        # bursts stay as arrays so sync() block-copies them instead of
        # converting a giant Python list element-wise
        self._si_chunks: List[Tuple[int, Any]] = []
        # ---- per-thread chain carries ------------------------------------
        self._nextseq = np.zeros(nthreads, dtype=np.int64)
        self._last_tend = np.zeros(nthreads, dtype=np.float64)
        # ---- charge seam (attach_engine) ---------------------------------
        self._nv = None               # engine staged charges land on
        self._cops: Tuple = (None, None)   # CompiledOp per kind bit
        self._evk: Tuple[int, int] = (-1, -1)  # event code per kind bit
        self._ex = None               # executor whose fast_ops we advance
        self.version = 0              # bumped on any mutation (view caches)
        self._lock = threading.Lock()
        # optional observation-only phase profiler (duck-typed push/pop,
        # e.g. repro.obs.PhaseProfiler): when attached, sync() charges its
        # vector pass to the "record-charging" phase.  Never affects the
        # records or engine charges themselves.
        self.profiler = None

    # ------------------------------------------------------------- capacity
    def _ensure_ops(self, need: int) -> None:
        # the bound check comes before the capacity short-circuit: a
        # max_records below the preallocated capacity must still trip
        if self.max_records is not None and need > self.max_records:
            raise RecordCapacityError(
                f"op-record store needs {need} rows but max_records="
                f"{self.max_records}")
        cap = len(self.tid)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        if self.max_records is not None:
            cap = min(cap, self.max_records)
        self.tid = _grown(self.tid, cap)
        self.kind = _grown(self.kind, cap)
        self.seq = _grown(self.seq, cap)
        self.t_start = _grown(self.t_start, cap)
        self.t_end = _grown(self.t_end, cap)
        self.completed = _grown(self.completed, cap)
        self.ev = _grown(self.ev, cap)
        self.items = _grown(self.items, cap)

    def _ensure_events(self, need: int) -> None:
        if self.max_records is not None and need > self.max_records:
            raise RecordCapacityError(
                f"event store needs {need} rows but max_records="
                f"{self.max_records}")
        cap = len(self.ev_code)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        if self.max_records is not None:
            cap = min(cap, self.max_records)
        self.ev_code = _grown(self.ev_code, cap)
        self.ev_arity = _grown(self.ev_arity, cap)
        self.ev_payload = _grown(self.ev_payload, cap)

    # ------------------------------------------------------------ interning
    def _intern(self, name: str) -> int:
        c = self._codes.get(name)
        if c is None:
            c = len(self._names)
            self._codes[name] = c
            self._names.append(name)
        return c

    # ----------------------------------------------------------- charge seam
    def attach_engine(self, nv, cops: Tuple, event_kinds: Tuple[
            Optional[str], Optional[str]], executor=None) -> None:
        """Bind the engine + compiled ops staged bursts resolve against.

        ``cops`` is (enq CompiledOp, deq CompiledOp) -- their
        ``counts_for_key`` caches turn packed outcome keys back into event
        vectors; ``event_kinds`` the linearization-event kind per op kind
        (None = the op emits no event).  Called by
        ``FastPathExecutor.attach_store`` at the start of every batched
        run; also re-seeds the per-thread clock chain from the engine's
        current thread clocks.
        """
        if self.nthreads > MAX_STAGED_THREADS:
            raise ValueError(
                f"staged records support at most {MAX_STAGED_THREADS} "
                f"threads, got {self.nthreads}")
        self.flush()
        self._nv = nv
        self._cops = cops
        self._ex = executor
        self._evk = tuple(-1 if k is None else self._intern(k)
                          for k in event_kinds)
        self._last_tend[:] = nv.thread_times_ns()

    # ------------------------------------------------------------- staging
    def extend_staged(self, metas: bytes, items, tends: bytes) -> None:
        """Append a whole committed burst to the staging arrays in one
        bulk copy -- ``metas`` / ``tends`` are the packed int64 meta
        words and float64 post-op clocks as raw bytes, ``items`` the
        per-op payloads (an object ndarray, kept whole as a chunk, or a
        plain list).  The rows are materialized and charged by the next
        :meth:`sync`, exactly as per-op staged rows are; used by the
        burst executor (:mod:`repro.core.burst`)."""
        if isinstance(items, np.ndarray):
            self._si_chunks.append((len(self._sm), items))
        else:
            self._si.extend(items)
        self._sm.frombytes(metas)
        self._st.frombytes(tends)

    def sync(self) -> None:
        """Materialize the staged burst into the columns and charge the
        engine -- one vector pass, one ``charge_counts`` per distinct
        (outcome-key, tid, kind) triple.  Caller holds the lock or is the
        single-threaded batched scheduler."""
        if not self._sm:
            return
        prof = self.profiler
        if prof is None:
            return self._sync_impl()
        prof.push("record-charging")
        try:
            self._sync_impl()
        finally:
            prof.pop()

    def _sync_impl(self) -> None:
        sm = self._sm
        n = len(sm)
        c = self.n_ops
        self._ensure_ops(c + n)
        m = np.frombuffer(sm, dtype=np.int64).copy()
        kb = (m & 1).astype(np.uint8)
        tids = ((m >> 1) & 0xFF).astype(np.int64)
        sl = slice(c, c + n)
        self.tid[sl] = tids
        self.kind[sl] = kb
        self.completed[sl] = 1
        icol = self.items[sl]
        if self._si_chunks:
            li = cur = 0
            si = self._si
            for pos, chunk in self._si_chunks:
                if pos > cur:
                    icol[cur:pos] = si[li:li + pos - cur]
                    li += pos - cur
                    cur = pos
                k = len(chunk)
                icol[cur:cur + k] = chunk
                cur += k
            if cur < n:
                icol[cur:] = si[li:]
        else:
            icol[:] = self._si
        te = np.frombuffer(self._st, dtype=np.float64).copy()
        self.t_end[sl] = te
        # per-thread seq numbers + start-clock chain: a thread's clock only
        # advances inside ops, so op i's start clock is op i-1's end clock
        # (the carry bridges bursts and real-execution ops)
        order = np.argsort(tids.astype(np.uint8), kind="stable")
        ts_ = tids[order]
        gstart = np.empty(n, dtype=bool)
        gstart[0] = True
        gstart[1:] = ts_[1:] != ts_[:-1]
        starts = np.nonzero(gstart)[0]
        gtids = ts_[starts]
        cnt = np.empty(starts.size, np.int64)
        cnt[:-1] = starts[1:] - starts[:-1]
        cnt[-1] = n - starts[-1]
        within = np.arange(n, dtype=np.int64) - np.repeat(starts, cnt)
        seq_s = np.repeat(self._nextseq[gtids], cnt) + within
        self._nextseq[gtids] += cnt
        te_s = te[order]
        ts_chain = np.empty(n, dtype=np.float64)
        ts_chain[1:] = te_s[:-1]
        ts_chain[starts] = self._last_tend[gtids]
        self._last_tend[gtids] = te_s[starts + cnt - 1]
        self.seq[sl][order] = seq_s
        self.t_start[sl][order] = ts_chain
        # event-count columns + engine charge, one pass per distinct word
        uniq, inv, counts = np.unique(m, return_inverse=True,
                                      return_counts=True)
        vecs = np.empty((uniq.size, N_EV), dtype=np.int64)
        nv = self._nv
        cops = self._cops
        for j in range(uniq.size):
            meta = int(uniq[j])
            vec = cops[meta & 1].counts_for_key(meta >> META_KEY_SHIFT)
            vecs[j] = vec
            nv.charge_counts((meta >> 1) & 0xFF, vec * int(counts[j]))
        self.ev[sl] = vecs[inv]
        # linearization events: compiled ops of a kind either always emit
        # (event kind, item) or never emit -- derived, not recorded
        e0, e1 = self._evk
        if e0 >= 0 or e1 >= 0:
            codes = np.where(kb == 1, e1, e0).astype(np.int32)
            mask = codes >= 0
            ne = int(mask.sum())
            if ne:
                ec = self.n_events
                self._ensure_events(ec + ne)
                esl = slice(ec, ec + ne)
                self.ev_code[esl] = codes[mask]
                self.ev_arity[esl] = 2
                self.ev_payload[esl] = self.items[sl][mask]
                self.n_events = ec + ne
        self.n_ops = c + n
        if self._ex is not None:
            self._ex.fast_ops += n
        del sm[:]
        del self._si[:]
        del self._st[:]
        self._si_chunks.clear()
        self.version += 1

    def flush(self) -> None:
        """Thread-safe sync (the harness's end-of-run seam)."""
        with self._lock:
            self.sync()

    # --------------------------------------------------------- direct rows
    def begin_op(self, tid: int, kind: str, item: Any = None,
                 completed: bool = False) -> int:
        """Append one op row (real per-primitive execution path); returns
        its row index for :meth:`complete_op`.  Flushes any staged burst
        first so rows land in global execution order."""
        with self._lock:
            self.sync()
            i = self.n_ops
            self._ensure_ops(i + 1)
            self.tid[i] = tid
            self.kind[i] = KIND_CODES[kind]
            self.seq[i] = self._nextseq[tid]
            self._nextseq[tid] += 1
            self.t_start[i] = self.t_end[i] = self._last_tend[tid]
            self.completed[i] = 1 if completed else 0
            self.ev[i] = 0
            self.items[i] = item
            self.n_ops = i + 1
            self.version += 1
            return i

    def complete_op(self, i: int, item: Any = _UNSET) -> None:
        with self._lock:
            self.completed[i] = 1
            if item is not _UNSET:
                self.items[i] = item
            self.version += 1

    def add_completed_op(self, tid: int, kind: str, item: Any) -> int:
        """One-shot completed row (the eager fast-path record callback)."""
        return self.begin_op(tid, kind, item, completed=True)

    def note_real_clocks(self, tid: int, t_start: float,
                         t_end: float) -> None:
        """Fix up the clock columns of the row a just-bailed real op
        appended (always the latest row) and re-seed the thread's chain."""
        i = self.n_ops - 1
        self.t_start[i] = t_start
        self.t_end[i] = t_end
        self._last_tend[tid] = t_end

    def append_event(self, ev: tuple) -> None:
        """Append one serialized event (``q.on_event`` / crash markers)."""
        with self._lock:
            self.sync()
            i = self.n_events
            self._ensure_events(i + 1)
            if (type(ev) is tuple and 1 <= len(ev) <= 2
                    and isinstance(ev[0], str)):
                self.ev_code[i] = self._intern(ev[0])
                self.ev_arity[i] = len(ev)
                self.ev_payload[i] = ev[1] if len(ev) == 2 else None
            else:
                # arbitrary event shape: store verbatim
                self.ev_code[i] = self._intern("<raw>")
                self.ev_arity[i] = -1
                self.ev_payload[i] = ev
            self.n_events = i + 1
            self.version += 1

    # ---------------------------------------------------------- observation
    def op_count(self) -> int:
        with self._lock:
            self.sync()
            return self.n_ops

    def event_count(self) -> int:
        with self._lock:
            self.sync()
            return self.n_events

    def completed_count(self) -> int:
        with self._lock:
            self.sync()
            return int(self.completed[:self.n_ops].sum())

    def op_record(self, i: int) -> OpRecord:
        return OpRecord(tid=int(self.tid[i]), kind=KIND_NAMES[self.kind[i]],
                        item=self.items[i], completed=bool(self.completed[i]))

    def op_records(self) -> List[OpRecord]:
        with self._lock:
            self.sync()
            kn = KIND_NAMES
            tid, kind = self.tid, self.kind
            items, comp = self.items, self.completed
            return [OpRecord(tid=int(tid[i]), kind=kn[kind[i]],
                             item=items[i], completed=bool(comp[i]))
                    for i in range(self.n_ops)]

    def event_tuples(self) -> List[tuple]:
        with self._lock:
            self.sync()
            names = self._names
            out = []
            for i in range(self.n_events):
                a = self.ev_arity[i]
                if a == 2:
                    out.append((names[self.ev_code[i]], self.ev_payload[i]))
                elif a == 1:
                    out.append((names[self.ev_code[i]],))
                else:
                    out.append(self.ev_payload[i])
            return out

    # ------------------------------------------------------ snapshot/restore
    def snapshot(self) -> Tuple[int, int]:
        """(op cursor, event cursor) -- taken alongside an
        :class:`repro.core.nvram.EngineSnapshot` so the crash seam can
        rewind records with memory state."""
        with self._lock:
            self.sync()
            return (self.n_ops, self.n_events)

    def restore(self, snap: Tuple[int, int]) -> None:
        """Truncate back to a snapshot's cursors (contents up to the
        cursors are untouched; per-thread chain carries are recomputed
        from the surviving rows)."""
        oc, ec = snap
        with self._lock:
            self.sync()
            if oc > self.n_ops or ec > self.n_events or oc < 0 or ec < 0:
                raise ValueError(
                    f"record snapshot ({oc}, {ec}) does not fit store with "
                    f"({self.n_ops}, {self.n_events}) rows")
            self.items[oc:self.n_ops] = None
            self.ev_payload[ec:self.n_events] = None
            self.n_ops = oc
            self.n_events = ec
            tids = self.tid[:oc]
            self._nextseq[:] = np.bincount(tids, minlength=self.nthreads
                                           )[:self.nthreads]
            self._last_tend[:] = 0.0
            for t in range(self.nthreads):
                idx = np.nonzero(tids == t)[0]
                if idx.size:
                    self._last_tend[t] = self.t_end[idx[-1]]
            self.version += 1

    # ----------------------------------------------------------- mutation
    def clear_ops(self) -> None:
        with self._lock:
            self.sync()
            self.items[:self.n_ops] = None
            self.n_ops = 0
            self._nextseq[:] = 0
            self._last_tend[:] = 0.0
            self.version += 1

    def clear_events(self) -> None:
        with self._lock:
            self.sync()
            self.ev_payload[:self.n_events] = None
            self.n_events = 0
            self.version += 1

    def reset_ops(self, records) -> None:
        """Replace op contents wholesale (``harness.ops = [...]``)."""
        self.clear_ops()
        for r in records:
            self.begin_op(r.tid, r.kind, r.item, completed=r.completed)


class _ViewBase:
    """Mutable list-like surface over one of the store's record families.

    Materialization is cached against the store's version counter, so
    repeated reads (equality checks, membership, slicing) cost one list
    build per mutation epoch."""

    __slots__ = ("_s", "_cache", "_cver")

    def __init__(self, store: RecordStore):
        self._s = store
        self._cache: Optional[list] = None
        self._cver = -1

    def _materialize(self) -> list:
        raise NotImplementedError

    def _list(self) -> list:
        if self._cver != self._s.version:
            self._cache = self._materialize()
            self._cver = self._s.version
        return self._cache

    def __iter__(self):
        return iter(self._list())

    def __getitem__(self, i):
        return self._list()[i]

    def __contains__(self, x):
        return x in self._list()

    def index(self, x, *args):
        return self._list().index(x, *args)

    def count(self, x):
        return self._list().count(x)

    def __eq__(self, other):
        if isinstance(other, _ViewBase):
            other = other._list()
        if isinstance(other, list):
            return self._list() == other
        return NotImplemented

    def __ne__(self, other):
        r = self.__eq__(other)
        return r if r is NotImplemented else not r

    def __repr__(self):
        return repr(self._list())

    def __delitem__(self, key):
        if not (isinstance(key, slice) and key.start in (None, 0)
                and key.stop is None and key.step is None):
            raise TypeError("record views support full-slice deletion only "
                            "(del view[:])")
        self.clear()

    def extend(self, it):
        for x in it:
            self.append(x)

    # views are truthy iff non-empty, like lists
    def __bool__(self):
        return len(self) > 0


class OpsView(_ViewBase):
    """``harness.ops`` surface: a live list of :class:`OpRecord`."""

    __slots__ = ()

    def __len__(self):
        return self._s.op_count()

    def _materialize(self) -> list:
        return self._s.op_records()

    def append(self, rec: OpRecord) -> None:
        self._s.begin_op(rec.tid, rec.kind, rec.item,
                         completed=rec.completed)

    def clear(self) -> None:
        self._s.clear_ops()


class EventsView(_ViewBase):
    """``harness.events`` surface: a live list of event tuples."""

    __slots__ = ()

    def __len__(self):
        return self._s.event_count()

    def _materialize(self) -> list:
        return self._s.event_tuples()

    def append(self, ev: tuple) -> None:
        self._s.append_event(ev)

    def clear(self) -> None:
        self._s.clear_events()
