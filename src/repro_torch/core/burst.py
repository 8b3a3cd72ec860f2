"""Vectorized burst execution -- optimistic interleaving prediction.

The merged columnar runner (PR 7) still walks the clock heap one op at a
time: per grant it pops the heap, runs one interpreted compiled-op body
(~45-50 lines of CPython at ~50ns/line) and pushes the thread back.
That per-op body is the ~4.5µs/op floor.  This module breaks it by
executing whole multi-thread bursts as array programs:

* **predict** -- per-op durations of compiled fast-path ops are pure
  functions of the packed outcome key, and in steady state the key per
  (tid, kind) is stable.  Seeding each live thread's next keys from its
  last committed ones, the whole grant order and every clock window of
  the next K ops is computable up front with a segmented ``cumsum`` +
  one ``lexsort`` -- no heap operations at all (the grant sequence of a
  clock heap over per-thread monotone streams is exactly the merge by
  ``(start, tid)``).
* **plan** -- a generated per-queue planner walks the predicted grant
  sequence once and performs the *real* allocator work (free-list pops,
  area-cursor bumps, limbo retires, epoch announces and the 64-op
  ``_try_advance`` boundaries) against the live ``SSMem`` /
  ``VolatileAlloc`` state, after snapshotting it.  Everything else
  about the op bodies is reconstructed vectorized: FIFO tail/head
  chains, per-record indices and dequeue results are prefix shifts and
  gathers over the planned allocation columns.
* **verify** -- the op bodies' line-state and volatile-touch
  transitions are replayed as a vector automaton over the fleet
  lowering's opcode tables (:func:`repro.fleet.lowering.encode_program`
  applied to the ``pin_tid=False`` lowering of the same compiled ops).
  One composite argsort groups every touched line's events in burst
  order; a segmented scan reconstructs each touch's outcome nibble and
  each line's final state *exactly* (the engine's ``TOUCH_CLASS`` /
  ``TOUCH_NEXT`` transition algebra decomposes into "last non-EVERFL
  event" + "any INVAL/EVERFL so far", both O(n) scans).  The
  recomputed keys are compared against the predicted ones.
* **commit** -- on full agreement the burst is committed: staged
  ``RecordStore`` rows (:meth:`~repro.core.records.RecordStore.
  extend_staged`), the generated values-only grant loop for the
  Python-valued stores (:func:`~repro.core.opsched.
  generate_burst_apply_fn`), one scatter each for final line states and
  volatile touch bits, the FIFO splice, and a heap rebuild from the
  committed clocks (the allocator state is already final -- the planner
  mutated the real thing).
* **mispredict** -- any key disagreement discards the speculative
  allocator state (snapshot restore) and either re-predicts with the
  learned keys (bounded fixpoint) or truncates the burst at the first
  disagreeing grant and commits the verified prefix with that grant's
  clock fixed to its true duration.  Structural hazards (empty dequeue,
  allocator exhaustion that would carve a new area/chunk mid-burst) are
  detected *before* planning and truncate the burst conservatively; the
  scheduler replays rejected bursts through the merged columnar runner,
  which handles bails bit-identically.

Bit identity is the contract: every committed burst produces exactly
the staged rows, engine mutations and queue state the merged columnar
runner would have -- gated by the burst equivalence suite across all
queues, models and contention settings.
"""
from __future__ import annotations

import heapq
from collections import deque
from itertools import islice, repeat
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .nvram import (EV_COLD_DRAM, EV_COLD_NVM, EV_DRAM, EV_HIT,
                    EV_POSTFLUSH, LINE_WORDS, NVRAM)
from .opsched import (K_CASTAG, K_CLASS_P, K_CLASS_V, K_DRAIN, K_DRAINF,
                      K_LINE, K_LOGW, K_NT, K_NTAPPLY, K_PENDW, K_PMEMW,
                      K_STAMP, K_STATE, K_VVAL, _SYMS, _op_value_syms,
                      compile_cached, generate_burst_apply_fn)
from .records import META_KEY_SHIFT

_ST_INVAL, _ST_EVERFL, _ST_RECACHE = 0, 1, 2
_VB = NVRAM._VOLATILE_BASE

# symbol sets a burst-eligible op may reference, per kind: the planner
# can reconstruct exactly these node-locals (allocation columns, FIFO
# tail/head/next chains)
_ENQ_SYMS = frozenset({"new_p", "new_v", "tail_p", "tail_v"})
_DEQ_SYMS = frozenset({"head_p", "head_v", "next_p", "next_v"})
_V_SYMS = frozenset({"new_v", "tail_v", "head_v", "next_v"})


class _KindTables:
    """Static per-(queue, kind, model) burst tables: the opcode rows
    split into persistent-line events and volatile-touch events, with
    per-row address modes and key-nibble shifts."""

    __slots__ = ("kbit", "syms", "n_rows",
                 "p_amode", "p_sym", "p_off", "p_const", "p_pos",
                 "p_c", "p_b", "p_touch", "p_shift",
                 "v_amode", "v_sym", "v_off", "v_const", "v_pos", "v_shift")

    def __init__(self, kbit: int):
        self.kbit = kbit
        self.syms: set = set()


def _build_kind_tables(op, fp, oprog) -> Optional[_KindTables]:
    """Lower one compiled op's fleet micro rows into burst event tables.
    Returns None when the op shape is outside the supported matrix.

    Event algebra (exact on the engine's reachable line states
    {0, 1, 4, 5, 6}): every micro row maps to a low-bits transition code
    ``c`` (1 = leaves the line cached, 2 = flush-invalidated,
    0 = EVERFL-only, transparent) plus a sticky ``b`` bit (the line has
    ever been flushed).  ``K_LINE`` and ``ST_RECACHE`` both reduce to
    the ``TOUCH_NEXT`` transition ``(s & 4) | 1`` -- for ``ST_RECACHE``
    that equivalence needs the row to follow its own op's ``ST_INVAL``
    on the same address (the compiler guarantees it; verified here)."""
    kt = _KindTables(0 if op.kind == "enq" else 1)
    allowed = _ENQ_SYMS if op.kind == "enq" else _DEQ_SYMS
    p_rows: List[tuple] = []     # (c, b, touch, ref, pos, slot)
    v_rows: List[tuple] = []     # (ref, pos, slot)
    n_class = 0
    seen_inval: set = set()
    for pos, m in enumerate(fp.micro):
        tag = m[0]
        ref = m[1]
        if ref.mode == "sym":
            name = _SYMS[ref.sym]
            if name not in allowed:
                return None
            kt.syms.add(name)
        if tag == "class_p":
            p_rows.append((1, 0, 1, ref, pos, n_class))
            n_class += 1
        elif tag == "class_v":
            v_rows.append((ref, pos, n_class))
            n_class += 1
        elif tag == "line":
            p_rows.append((1, 0, 0, ref, pos, -1))
        elif tag == "state":
            mode = m[2]
            if mode == _ST_INVAL:
                p_rows.append((2, 1, 0, ref, pos, -1))
                seen_inval.add(ref)
            elif mode == _ST_EVERFL:
                p_rows.append((0, 1, 0, ref, pos, -1))
            elif mode == _ST_RECACHE:
                if ref not in seen_inval:
                    return None
                p_rows.append((1, 0, 0, ref, pos, -1))
            else:
                return None
        else:
            return None
    if n_class != op.n_class or oprog.n_micro != len(fp.micro):
        return None

    def _pack(ref) -> Tuple[int, Optional[str], int, int]:
        # (amode, sym-name, off, const); v-space consts and per-tid
        # roots are already _VOLATILE_BASE-relative (fleet _lower_addr)
        if ref.mode == "const":
            return 0, None, 0, ref.const
        if ref.mode == "tid":
            return 2, None, 0, ref.const
        return 1, _SYMS[ref.sym], ref.off, 0

    kt.n_rows = len(fp.micro)
    pk = [_pack(r[3]) for r in p_rows]
    kt.p_amode = np.array([p[0] for p in pk], np.int64)
    kt.p_sym = [p[1] for p in pk]
    kt.p_off = np.array([p[2] for p in pk], np.int64)
    kt.p_const = np.array([p[3] for p in pk], np.int64)
    kt.p_pos = np.array([r[4] for r in p_rows], np.int64)
    kt.p_c = np.array([r[0] for r in p_rows], np.int64)
    kt.p_b = np.array([r[1] for r in p_rows], np.int64)
    kt.p_touch = np.array([r[2] for r in p_rows], bool)
    slots = np.array([r[5] for r in p_rows], np.int64)
    kt.p_shift = np.where(slots >= 0, 4 * (n_class - 1 - slots), -1)
    vk = [_pack(r[0]) for r in v_rows]
    kt.v_amode = np.array([p[0] for p in vk], np.int64)
    kt.v_sym = [p[1] for p in vk]
    kt.v_off = np.array([p[2] for p in vk], np.int64)
    kt.v_const = np.array([p[3] for p in vk], np.int64)
    kt.v_pos = np.array([r[1] for r in v_rows], np.int64)
    kt.v_shift = 4 * (n_class - 1 - np.array([r[2] for r in v_rows],
                                             np.int64))
    return kt


# --------------------------------------------------------------------------
# generated planner
# --------------------------------------------------------------------------
def _retire_specs(op) -> Optional[List[Tuple[str, str]]]:
    """aux_specs as [(sym_name, "p"|"v")], or None when unsupported."""
    out: List[Tuple[str, str]] = []
    allowed = _ENQ_SYMS if op.kind == "enq" else _DEQ_SYMS
    for ax in op.aux_specs:
        if ax[0] not in ("retire", "retire_v"):
            return None
        val = ax[1]
        if not (isinstance(val, tuple) and val[0] == "sym"
                and val[1] in allowed):
            return None
        out.append((val[1], "p" if ax[0] == "retire" else "v"))
    return out


def generate_plan_fn(queue, ops: Dict, mem, valloc,
                     retires: Dict[str, List[Tuple[str, str]]]) -> Callable:
    """Generate the burst planner: one pass over the predicted grant
    sequence doing only the sequential allocator work, against the live
    (snapshotted) allocator state.

    ``_plan(n, kb, tids, d0, exist_p, exist_v, h_p, h_v, t_p, t_v,
    badv, e_np, e_nv)`` -- ``badv`` is the grant index whose op_begin
    crosses the 64-op epoch-advance boundary (>= n when none does),
    ``h_*`` / ``t_*`` the current head/tail record fields, ``exist_*``
    the pre-burst FIFO columns, and ``e_np`` / ``e_nv`` output lists
    receiving the allocated node addresses in enqueue order."""
    enq = ops["enq"]
    uses_ss = enq.uses_ssmem
    d_ret = retires["deq"]
    e_ret = retires["enq"]
    any_ret = bool(d_ret or e_ret)
    need_r_p = any(s == "next_p" for s, _ in d_ret) or \
        any(s == "head_p" for s, _ in d_ret)
    need_r_v = any(s == "next_v" for s, _ in d_ret) or \
        any(s == "head_v" for s, _ in d_ret)
    need_h = any(s in ("head_p", "head_v") for s, _ in d_ret)
    need_t = any(s in ("tail_p", "tail_v") for s, _ in e_ret)
    w: List[str] = []
    emit = w.append
    emit("def _plan(n, kb, tids, d0, exist_p, exist_v, h_p, h_v, t_p, t_v,"
         " badv, e_np, e_nv):")
    if uses_ss:
        emit("    ann = mem._announced")
    if any_ret:
        emit("    lb = mem._limbo")
    if uses_ss or any_ret:
        emit("    ep = mem._epoch")
    if enq.allocs_p:
        emit("    mf = mem._free")
        emit("    mcur = mem._cursor")
        emit("    mar = mem._areas")
        emit("    ena = e_np.append")
    if enq.allocs_v:
        emit("    vf = valloc._free")
        emit("    vcur = valloc._cursor")
        emit("    vbase = valloc._base")
        emit(f"    _NW = {valloc.node_words if valloc is not None else LINE_WORDS}")
        emit("    enva = e_nv.append")
    if d_ret:
        emit("    j = 0")
    emit("    g = 0")
    emit("    while g < n:")
    emit("        t = tids[g]")
    if uses_ss:
        emit("        ann[t] = ep")
        emit("        if g == badv:")
        emit("            mem._try_advance()")
        emit("            ep = mem._epoch")
        emit("            badv += 64")
    emit("        if kb[g]:")
    deq_body: List[str] = []
    if d_ret:
        if need_r_p or need_r_v:
            deq_body.append("if j < d0:")
            fields = []
            if need_r_p:
                fields.append("_rp = exist_p[j]")
            if need_r_v:
                fields.append("_rv = exist_v[j]")
            deq_body.append("    " + "; ".join(fields))
            deq_body.append("else:")
            deq_body.append("    _m = j - d0")
            fields = []
            if need_r_p:
                fields.append("_rp = e_np[_m]")
            if need_r_v:
                fields.append("_rv = e_nv[_m]")
            deq_body.append("    " + "; ".join(fields))
        src = {"head_p": "h_p", "head_v": "h_v",
               "next_p": "_rp", "next_v": "_rv"}
        for name, space in d_ret:
            deq_body.append(f"lb[t].append(({src[name]}, ep, {space!r}))")
        if need_h:
            if need_r_p:
                deq_body.append("h_p = _rp")
            if need_r_v:
                deq_body.append("h_v = _rv")
        deq_body.append("j += 1")
    else:
        deq_body.append("pass")
    for line in deq_body:
        emit("            " + line)
    emit("        else:")
    enq_body: List[str] = []
    if enq.allocs_p:
        enq_body += ["_f = mf[t]",
                     "if _f:",
                     "    _x = _f.pop()",
                     "else:",
                     "    _cu = mcur[t]",
                     f"    _x = mar[t][-1] + _cu * {LINE_WORDS}",
                     "    mcur[t] = _cu + 1",
                     "ena(_x)"]
    if enq.allocs_v:
        enq_body += ["_f2 = vf[t]",
                     "if _f2:",
                     "    _y = _f2.pop()",
                     "else:",
                     "    _cv = vcur[t]",
                     "    _y = vbase[t] + _cv * _NW",
                     "    vcur[t] = _cv + 1",
                     "enva(_y)"]
    if e_ret:
        src_e = {"new_p": "_x", "new_v": "_y", "tail_p": "t_p",
                 "tail_v": "t_v"}
        for name, space in e_ret:
            enq_body.append(f"lb[t].append(({src_e[name]}, ep, {space!r}))")
    if need_t:
        if enq.allocs_p:
            enq_body.append("t_p = _x")
        if enq.allocs_v:
            enq_body.append("t_v = _y")
    if not enq_body:
        enq_body.append("pass")
    for line in enq_body:
        emit("            " + line)
    emit("        g += 1")
    src = "\n".join(w)
    env = {"mem": mem, "valloc": valloc}
    exec(compile_cached(src, f"<burst-plan:{type(queue).__name__}>"), env)
    fn = env["_plan"]
    fn.__source__ = src
    return fn


# --------------------------------------------------------------------------
# row-batched value application
# --------------------------------------------------------------------------
# The generated per-grant value loop (generate_burst_apply_fn) is exact
# but sequential CPython.  Every values_only program is *straight-line*
# (each grant executes each store row), so the same effects can also be
# applied row-batched: one fancy scatter (the ``vval`` object ndarray)
# or one C-level ``map(list.__setitem__, ...)`` pass (the ``vis`` /
# ``pmem`` lists) per program row, rows in program order, enqueue rows
# before dequeue rows.  Batching "row-major" instead of "grant-major"
# reorders writes, which is safe exactly when:
#
# * same-row duplicates resolve last-wins in grant order (columns are
#   built in grant order; const-addressed rows collapse to one scalar
#   store of the last grant's value, tid-addressed rows to one store
#   per thread of that thread's last value);
# * cross-row conflicts within a kind only pair an earlier row with a
#   LATER grant: statically, no allocation-addressed row (``new_*``)
#   may follow a chain-addressed row (``tail_*``) on the same plane --
#   a tail address is the previous grant's allocation, so tail rows
#   overwrite new rows, never the reverse;
# * dequeue programs address stores only through constants or the
#   per-tid scratch mode (queue-header regions, disjoint from node
#   areas by region construction), never node symbols;
# * no node address is both consumed/free and re-allocated inside one
#   burst (checked per burst: allocated addresses must be unique and
#   disjoint from the burst's consumed records and the pre-burst
#   tail/head records -- the tail is a retired dummy when the FIFO
#   starts empty);
# * drained lines are clean at burst start and stay clean (checked per
#   burst against the live log; lines this burst itself appends to
#   count as dirty);
# * log appends and line-start counters are per-line aggregations:
#   appends extend in grant order (one appending row per line,
#   enforced statically), counters sum.
#
# Static ineligibility keeps the per-grant loop permanently (``vap`` is
# None); a dynamic hazard falls back for that one burst.
_K_SKIP = frozenset({K_CLASS_P, K_CLASS_V, K_STATE, K_CASTAG, K_STAMP})
_NEW_SYMS = frozenset({"new_p", "new_v"})
_TAIL_SYMS = frozenset({"tail_p", "tail_v"})
_PLANES = ("vis", "pmem", "vval")

_SINK = deque(maxlen=0)
_consume = _SINK.extend        # run a map() at C speed, discard results


class _VecApply:
    """Static row-batched application program for one (queue, model)."""

    __slots__ = ("streams", "drains", "logls", "check_p", "check_v")

    def __init__(self):
        # per kind: [(target, amode, sym, off, const, vtag, vpayload)]
        self.streams: Dict[str, list] = {}
        self.drains: Dict[str, list] = {}   # packed drain-target addrs
        self.logls: frozenset = frozenset()  # lines K_LOGW appends to
        self.check_p = False
        self.check_v = False


def _vec_pack_addr(a) -> Tuple[int, Optional[str], int, int]:
    if a[0] == 0:
        return (0, None, 0, a[1])
    if a[0] == 1:
        return (1, _SYMS[a[1]], a[2], 0)
    return (2, None, 0, a[1] + a[2])


def _vec_pack_val(v):
    tag = v[0]
    if tag == "c":
        return ("c", v[1])
    if tag in ("item", "idx"):
        return (tag, None)
    if tag == "sym":
        return ("sym", v[1])
    return None                  # tup / slot values: per-grant only


def _vec_streams_for(op):
    """Lower one values_only program to row-batched stream specs, or
    None when any row resists batching."""
    streams: list = []
    drains: list = []
    logls: list = []

    def store(target, a, v, k=0) -> bool:
        if v is None:
            return False
        am, sym, off, const = a
        if am == 1:
            off += k
        else:
            const += k
        streams.append((target, am, sym, off, const) + v)
        return True

    for ins in op.prog:
        code = ins[0]
        if code in _K_SKIP:
            continue
        a = _vec_pack_addr(ins[1])
        if code == K_VVAL:
            if not store("vval", a, _vec_pack_val(ins[3])):
                return None
        elif code in (K_PENDW, K_NT):
            if not store("vis", a, _vec_pack_val(ins[3])):
                return None
        elif code == K_PMEMW:
            v = _vec_pack_val(ins[3])
            if not (store("vis", a, v) and store("pmem", a, v)):
                return None
        elif code == K_NTAPPLY:
            if not store("pmem", a, _vec_pack_val(ins[3])):
                return None
        elif code == K_LOGW:
            if a[0] != 0:
                return None      # per-line append order needs a const
            v = _vec_pack_val(ins[3])
            if not (store("vis", a, v) and store("logext", a, v)):
                return None
            logls.append(a[3] // LINE_WORDS)
        elif code == K_LINE:
            if not (ins[4] or ins[5]):
                return None      # materializing line write
            for k in range(LINE_WORDS):
                v = ("item", None) if ins[3] == k else ("c", ins[2][k])
                store("vis", a, v, k)
                if ins[4]:
                    store("pmem", a, v, k)
        elif code == K_DRAIN:
            drains.append(a)
        elif code == K_DRAINF:
            drains.append(a)
            for ent in ins[2]:
                ea = _vec_pack_addr(ent[1])
                if ent[0] == "w":
                    if not store("pmem", ea, _vec_pack_val(ent[3])):
                        return None
                else:
                    for k in range(LINE_WORDS):
                        v = ("item", None) if ent[3] == k else \
                            ("c", ent[2][k])
                        store("pmem", ea, v, k)
            streams.append(("ls", a[0], a[1], a[2], a[3], "c", ins[3]))
        else:
            return None
    return streams, drains, logls


def _fixed_collide(s1, s2, nthreads: int) -> bool:
    """Whether two const/tid-addressed streams can touch one address."""
    am1, c1 = s1[1], s1[4]
    am2, c2 = s2[1], s2[4]
    if am1 == 0 and am2 == 0:
        return c1 == c2
    d = c1 - c2
    if d % LINE_WORDS:
        return False
    t = abs(d) // LINE_WORDS
    return t < nthreads


def _build_vector_apply(ops, nthreads: int) -> Optional[_VecApply]:
    per = {}
    for kind in ("enq", "deq"):
        r = _vec_streams_for(ops[kind])
        if r is None:
            return None
        per[kind] = r
    # dequeues may not address stores through node symbols: the
    # enq-batch-then-deq-batch order is only safe for header writes
    if any(st[1] == 1 and st[0] in _PLANES for st in per["deq"][0]):
        return None
    # within a kind, no allocation-addressed row after a chain row
    for kind in ("enq", "deq"):
        seen_tail = set()
        for st in per[kind][0]:
            if st[1] == 1 and st[0] in _PLANES:
                if st[2] in _TAIL_SYMS:
                    seen_tail.add(st[0])
                elif st[2] in _NEW_SYMS and st[0] in seen_tail:
                    return None
    # const/tid-addressed collisions: forbidden across kinds always,
    # and within a kind unless the two rows address identically (then
    # row order == per-grant order and last-wins is preserved)
    fixed = {k: [st for st in per[k][0]
                 if st[1] != 1 and st[0] in _PLANES]
             for k in ("enq", "deq")}
    for s1 in fixed["enq"]:
        for s2 in fixed["deq"]:
            if s1[0] == s2[0] and _fixed_collide(s1, s2, nthreads):
                return None
    for kind in ("enq", "deq"):
        sts = fixed[kind]
        for i, s1 in enumerate(sts):
            for s2 in sts[i + 1:]:
                if s1[0] == s2[0] and (s1[1], s1[4]) != (s2[1], s2[4]) \
                        and _fixed_collide(s1, s2, nthreads):
                    return None
    # at most one appending row per log line, across both kinds
    all_logls = per["enq"][2] + per["deq"][2]
    if len(all_logls) != len(set(all_logls)):
        return None
    vap = _VecApply()
    for kind in ("enq", "deq"):
        vap.streams[kind] = per[kind][0]
        vap.drains[kind] = per[kind][1]
    vap.logls = frozenset(all_logls)
    syms = {st[2] for k in ("enq", "deq") for st in per[k][0]
            if st[1] == 1 and st[0] in _PLANES}
    vap.check_p = bool(syms & {"new_p", "tail_p"})
    vap.check_v = bool(syms & {"new_v", "tail_v"})
    return vap


# --------------------------------------------------------------------------
# program build + support detection
# --------------------------------------------------------------------------
class BurstProgram:
    """Everything static about bursting one (queue, model): the per-kind
    event tables, the generated planner and values-only apply loop, and
    the feature flags the executor branches on."""

    __slots__ = ("kts", "plan_fn", "apply_fn", "cols", "uses_ssmem",
                 "allocs_p", "allocs_v", "retires", "max_rows",
                 "need_syms", "vap", "vplan")

    def __init__(self):
        self.kts: Dict[str, _KindTables] = {}


def build_burst_program(fast) -> Optional[BurstProgram]:
    """Build (or fetch cached) the burst program for ``fast``'s queue on
    its engine's model; None when the queue/model is outside the burst
    support matrix (the scheduler then stays on the columnar runner)."""
    nv = fast.nv
    cache = fast.q.__dict__.setdefault("_burst_programs", {})
    key = nv.model.name
    ent = cache.get(key)
    if ent is not None and ent[1] is nv:
        return ent[0]
    prog = _build_program(fast)
    cache[key] = (prog, nv)
    return prog


def _build_program(fast) -> Optional[BurstProgram]:
    from ..fleet.lowering import (FleetLoweringError, encode_program,
                                      lower_op)
    if fast.crunner is None or not fast.timed:
        return None
    q = fast.q
    ops = fast.ops
    mem = getattr(q, "mem", None)
    valloc = getattr(q, "valloc", None)
    if ops["enq"].uses_ssmem != ops["deq"].uses_ssmem:
        return None
    bp = BurstProgram()
    bp.retires = {}
    bp.need_syms = {}
    for kind in ("enq", "deq"):
        op = ops[kind]
        if op.guard_specs:
            return None
        rets = _retire_specs(op)
        if rets is None or (rets and mem is None):
            return None
        bp.retires[kind] = rets
        vcols = _op_value_syms(op)
        allowed = _ENQ_SYMS if kind == "enq" else _DEQ_SYMS
        if not vcols <= allowed:
            return None
        try:
            fp = lower_op(op, frozenset(), pin_tid=False)
            oprog = encode_program(fp, ())
        except FleetLoweringError:
            return None
        kt = _build_kind_tables(op, fp, oprog)
        if kt is None:
            return None
        bp.kts[kind] = kt
        bp.need_syms[kind] = kt.syms | vcols | {s for s, _ in rets}
    enq = ops["enq"]
    if (enq.allocs_p or enq.uses_ssmem) and mem is None:
        return None
    if enq.allocs_v and valloc is None:
        return None
    # volatile record fields only exist when the enqueue allocates them
    if (bp.need_syms["deq"] & _V_SYMS or "tail_v" in bp.need_syms["enq"]) \
            and not enq.allocs_v:
        return None
    bp.uses_ssmem = enq.uses_ssmem
    bp.allocs_p = enq.allocs_p
    bp.allocs_v = enq.allocs_v
    bp.max_rows = max(kt.n_rows for kt in bp.kts.values()) or 1
    bp.apply_fn = generate_burst_apply_fn(q, ops, fast.nv)
    bp.cols = bp.apply_fn.__cols__
    bp.plan_fn = generate_plan_fn(q, ops, mem, valloc, bp.retires)
    bp.vap = _build_vector_apply(ops, fast.nv.nthreads)
    # the vectorized planner covers pure-enqueue bursts; enqueues that
    # retire records need the sequential planner's limbo walk
    bp.vplan = not bp.retires["enq"]
    return bp


# --------------------------------------------------------------------------
# the vector automaton
# --------------------------------------------------------------------------
def _p_automaton(lv: np.ndarray, lines: np.ndarray, seq: np.ndarray,
                 c: np.ndarray, b: np.ndarray, span: int):
    """Replay all persistent-line events of a burst at once.

    ``lv`` is a live uint8 view of the engine's packed ``_lstate``; the
    events are (line, global seq, c-code, flushed-bit).  Returns (touch
    outcome nibble per event in input order, per-touched-line final
    lines, final states), or None when an initial line state falls
    outside the reachable set {0, 1, 4, 5, 6}."""
    n = lines.size
    order = np.argsort(lines * span + seq)
    ls_ = lines[order]
    c_ = c[order]
    b_ = b[order]
    start = np.empty(n, dtype=bool)
    start[0] = True
    start[1:] = ls_[1:] != ls_[:-1]
    gstart = np.nonzero(start)[0]
    grp = np.cumsum(start) - 1
    gs = gstart[grp]
    glines = ls_[gstart]
    init_g = lv[glines].astype(np.int64)
    # the engine only reaches {0,1,4,5,6}: FINVAL is always set together
    # with EVERFL and never alongside CACHED -- anything else means the
    # decomposition below doesn't apply, so the burst bails out
    if ((((init_g & 3) == 3) | ((init_g & 6) == 2)) | (init_g > 7)).any():
        return None
    init = init_g[grp]
    idx = np.arange(n, dtype=np.int64)
    nz = np.where(c_ != 0, idx, -1)
    m = np.maximum.accumulate(nz)
    m_strict = np.empty(n, np.int64)
    m_strict[0] = -1
    m_strict[1:] = m[:-1]
    has_p = m_strict >= gs
    pc = c_[np.where(has_p, m_strict, 0)]
    low = np.where(has_p, np.where(pc == 2, 2, 1), init & 3)
    cb = np.cumsum(b_)
    cb_strict = cb - b_
    bit4 = ((cb_strict - cb_strict[gs]) > 0) | ((init & 4) != 0)
    nib = np.where(low & 1, EV_HIT,
                   np.where(low & 2, EV_POSTFLUSH,
                            np.where(bit4, EV_COLD_NVM, EV_COLD_DRAM)))
    out = np.empty(n, np.int64)
    out[order] = nib
    ge = np.empty(gstart.size, np.int64)
    ge[:-1] = gstart[1:] - 1
    ge[-1] = n - 1
    has_c = m[ge] >= gstart
    pcf = c_[np.where(has_c, m[ge], 0)]
    lowf = np.where(has_c, np.where(pcf == 2, 2, 1), init_g & 3)
    b4f = ((cb[ge] - cb_strict[gstart]) > 0) | ((init_g & 4) != 0)
    fin = lowf | (b4f.astype(np.int64) << 2)
    return out, glines, fin


def _v_automaton(vtv: np.ndarray, vis: np.ndarray, seq: np.ndarray,
                 span: int, scratch: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """Volatile-touch nibbles (EV_DRAM on the burst's first touch of an
    untouched word, EV_HIT otherwise) per event in input order.

    With ``scratch`` (an int64 array covering the volatile word space)
    the events are promised already seq-ordered -- the first occurrence
    of each address is found with three linear passes instead of a
    sort: a reversed fancy write leaves each address holding the index
    of its *first* occurrence (duplicate-index assignment is last-wins).
    """
    n = vis.size
    if scratch is not None:
        idx = np.arange(n, dtype=np.int64)
        scratch[vis[::-1]] = idx[::-1]
        first = scratch[vis] == idx
        return np.where(first, EV_DRAM - vtv[vis].astype(np.int64),
                        EV_HIT)
    order = np.argsort(vis * span + seq)
    vs_ = vis[order]
    start = np.empty(n, dtype=bool)
    start[0] = True
    start[1:] = vs_[1:] != vs_[:-1]
    nib = np.where(start, EV_DRAM - vtv[vs_].astype(np.int64), EV_HIT)
    out = np.empty(n, np.int64)
    out[order] = nib
    return out


def predict_grants(dur: np.ndarray, seg_len_a: np.ndarray,
                   seg_t0_a: np.ndarray, pool_tid: np.ndarray,
                   more: np.ndarray):
    """Pure clock-heap prediction over per-op durations.

    ``dur`` holds each pooled op's predicted latency, segmented by
    thread (``seg_len_a`` ops per segment, thread clocks starting at
    ``seg_t0_a``, thread ids repeated in ``pool_tid``).  Returns
    ``(order, g_tid, g_start, g_end, N)``: the permutation sorting the
    pool into clock-heap grant order, the per-grant clock windows, and
    the count ``N`` of leading grants that remain valid given ``more``
    (per-segment flag: the thread has unpooled ops and re-enters the
    heap at its last pooled end; grants are valid only while they sort
    strictly before the earliest such re-entry point).

    This is exactly the order ``ClockScheduler``'s ``(time, tid)`` heap
    would produce: every latency is a multiple of 0.5ns, so the float
    cumsums are exact and association-free (the same invariant the
    per-op incremental clocks rely on), and the lexsort's tid tiebreak
    matches the heap's tuple comparison.
    """
    cs = np.cumsum(dur)
    seg_start = np.concatenate(([0], np.cumsum(seg_len_a)[:-1]))
    offs = np.repeat(cs[seg_start] - dur[seg_start], seg_len_a)
    t0_rep = np.repeat(seg_t0_a, seg_len_a)
    ends = t0_rep + (cs - offs)
    starts = ends - dur
    order = np.lexsort((pool_tid, starts))
    g_tid = pool_tid[order]
    g_start = starts[order]
    g_end = ends[order]
    N = int(dur.size)
    if more.any():
        seg_last = seg_start + seg_len_a - 1
        ce = ends[seg_last[more]]
        ct = pool_tid[seg_start][more]
        cut_e = ce.min()
        cut_t = int(ct[ce == cut_e].min())
        keep = (g_start < cut_e) | ((g_start == cut_e) & (g_tid < cut_t))
        N = int(keep.sum())
    return order, g_tid, g_start, g_end, N


# --------------------------------------------------------------------------
# the executor
# --------------------------------------------------------------------------
class BurstExecutor:
    """Drives burst prediction/commit for one batched columnar run.

    Created by :class:`repro.core.scheduler.ClockScheduler` when the run
    is dispatched columnar and ``burst`` is enabled; shares the
    scheduler's live ``heap`` / ``cursors``.  :meth:`try_burst` returns
    the number of ops committed (0 = this burst could not be predicted;
    the scheduler then replays a bounded chunk through the merged
    columnar runner)."""

    #: ops replayed per merged-runner chunk after a burst rejection
    REPLAY_CHUNK = 256

    def __init__(self, prog: BurstProgram, fast, op_kinds, op_items, lens,
                 profile=None, window: int = 8192, min_ops: int = 33,
                 max_fixpoint_iters: int = 3,
                 force_mispredict_every: int = 0,
                 force_reject_every: int = 0):
        self.prog = prog
        self.fast = fast
        self.nv = fast.nv
        self.mem = getattr(fast.q, "mem", None)
        self.valloc = getattr(fast.q, "valloc", None)
        self.fifo = fast.fifo
        self.dbox = fast._dbox
        self.rs = fast.rstore
        self.op_kinds = op_kinds
        self.op_items = op_items
        self.lens = lens
        self.profile = profile
        self.window = window
        self.min_ops = min_ops
        self.max_iters = max(1, max_fixpoint_iters)
        self.force_mispredict_every = force_mispredict_every
        self.force_reject_every = force_reject_every
        nthreads = self.nv.nthreads
        self._seed = np.full((nthreads, 2), -1, dtype=np.int64)
        self._kb: List[Optional[np.ndarray]] = [None] * nthreads
        self._it: List[Optional[np.ndarray]] = [None] * nthreads
        self._ns_vec = self.nv._ns_vec
        self._vscr: Optional[np.ndarray] = None
        # counters (read by benchmarks/tests; replayed_ops is driver-fed)
        self.n_bursts = 0
        self.n_commits = 0
        self.n_mispredicts = 0
        self.n_truncations = 0
        self.n_rejects = 0
        self.ops_bursted = 0
        self.replayed_ops = 0
        self.n_vec_plans = 0      # bursts planned by _vector_plan
        self.n_vec_applies = 0    # commits applied row-batched

    def stats(self) -> Dict[str, int]:
        return {"bursts": self.n_bursts, "commits": self.n_commits,
                "mispredicts": self.n_mispredicts,
                "truncations": self.n_truncations,
                "rejects": self.n_rejects,
                "ops_bursted": self.ops_bursted,
                "replayed_ops": self.replayed_ops,
                "vec_plans": self.n_vec_plans,
                "vec_applies": self.n_vec_applies}

    # -- per-thread static columns ---------------------------------------
    def _thread_cols(self, t: int):
        kb = self._kb[t]
        if kb is None:
            kinds = self.op_kinds[t]
            n = len(kinds)
            c = kinds.count("deq") if isinstance(kinds, list) else -1
            if c == 0:
                kb = np.zeros(n, np.int64)
            elif c == n:
                kb = np.ones(n, np.int64)
            else:
                kb = (np.array(kinds, dtype="U3") == "deq") \
                    .astype(np.int64)
            items = np.empty(n, dtype=object)
            items[:] = self.op_items[t]
            self._kb[t] = kb
            self._it[t] = items
        return kb, self._it[t]

    def _harvest_seeds(self) -> None:
        """Seed per-(tid, kind) keys from the staged rows the columnar
        runner (or prior bursts) already produced."""
        sm = self.rs._sm
        if not len(sm):
            return
        m = np.frombuffer(sm, dtype=np.int64)
        combo = ((m >> 1) & 0xFF) * 2 + (m & 1)
        uniq, ridx = np.unique(combo[::-1], return_index=True)
        last = m.size - 1 - ridx
        self._seed[uniq // 2, uniq % 2] = m[last] >> META_KEY_SHIFT

    # -- speculative allocator state -------------------------------------
    def _snapshot(self):
        mem, valloc = self.mem, self.valloc
        ms = vs = None
        if mem is not None:
            ms = ({t: list(l) for t, l in mem._free.items()},
                  dict(mem._cursor), dict(mem._announced),
                  {t: list(l) for t, l in mem._limbo.items()},
                  mem._epoch, mem._ops_since_adv)
        if valloc is not None:
            vs = ({t: list(l) for t, l in valloc._free.items()},
                  dict(valloc._cursor))
        return ms, vs

    def _restore(self, snap) -> None:
        ms, vs = snap
        mem, valloc = self.mem, self.valloc
        if ms is not None:
            free, cursor, ann, limbo, epoch, osa = ms
            for t, l in free.items():
                mem._free[t][:] = l
            mem._cursor.update(cursor)
            mem._announced.clear()
            mem._announced.update(ann)
            for t, l in limbo.items():
                mem._limbo[t][:] = l
            mem._epoch = epoch
            mem._ops_since_adv = osa
        if vs is not None:
            vfree, vcursor = vs
            for t, l in vfree.items():
                valloc._free[t][:] = l
            valloc._cursor.update(vcursor)

    # -- core -------------------------------------------------------------
    def try_burst(self, heap, cursors) -> int:
        nv = self.nv
        if nv.crashed:
            return 0
        pending = nv._pending
        for _, t in heap:
            if pending.get(t):
                return 0
        return self._try_burst_inner(heap, cursors)

    def _try_burst_inner(self, heap, cursors) -> int:
        self.n_bursts += 1
        prof = self.profile
        lens = self.lens
        wper = max(16, self.window // len(heap))
        if prof is not None:
            prof.push("burst-predict")
        # ---- pool: per live thread, up to wper pending ops -------------
        seg_tid: List[int] = []
        seg_t0: List[float] = []
        seg_len: List[int] = []
        kb_parts = []
        it_parts = []
        for t0, t in heap:
            c = cursors[t]
            k = min(lens[t] - c, wper)
            kb, items = self._thread_cols(t)
            kb_parts.append(kb[c:c + k])
            it_parts.append(items[c:c + k])
            seg_tid.append(t)
            seg_t0.append(t0)
            seg_len.append(k)
        P = int(sum(seg_len))
        if P < self.min_ops:
            if prof is not None:
                prof.pop()
            self.n_rejects += 1
            return 0
        pool_kb = np.concatenate(kb_parts)
        pool_tid = np.repeat(np.array(seg_tid, np.int64),
                             np.array(seg_len, np.int64))
        it_pool = np.concatenate(it_parts)
        seg_len_a = np.array(seg_len, np.int64)
        seg_t0_a = np.array(seg_t0, np.float64)
        keys_pool = self._seed[pool_tid, pool_kb]
        if np.any(keys_pool < 0):
            # only the (tid, kind) pairs actually pooled need seeds: an
            # enqueue-only phase must not re-harvest forever for the
            # dequeue seeds it will never use
            self._harvest_seeds()
            keys_pool = self._seed[pool_tid, pool_kb]
        if prof is not None:
            prof.pop()
        snap = None
        force_trunc = (self.force_mispredict_every
                       and self.n_bursts % self.force_mispredict_every == 0)
        force_reject = (self.force_reject_every
                        and self.n_bursts % self.force_reject_every == 0)
        try:
            for it in range(self.max_iters):
                if prof is not None:
                    prof.push("burst-predict")
                plan = self._predict(pool_kb, pool_tid, keys_pool,
                                     seg_len_a, seg_t0_a, cursors,
                                     from_seed=(it == 0))
                if prof is not None:
                    prof.pop()
                if plan is None:
                    break
                order_idx, g_tid, g_kb, g_start, g_end, N = plan
                if N < self.min_ops:
                    break
                if snap is None:
                    snap = self._snapshot()
                if prof is not None:
                    prof.push("burst-verify")
                state = self._plan_and_classify(g_tid, g_kb, order_idx,
                                                it_pool, N)
                if state is None:
                    if prof is not None:
                        prof.pop()
                    self._restore(snap)
                    break
                autokeys = state["keys"]
                predicted = keys_pool[order_idx[:N]]
                mis = np.nonzero(autokeys != predicted)[0]
                bad = int(mis[0]) if mis.size else -1
                if prof is not None:
                    prof.pop()
                if force_trunc:
                    bad = 0
                if bad < 0:
                    if force_reject:
                        self._restore(snap)
                        self.n_rejects += 1
                        return 0
                    return self._commit(heap, cursors, state, g_tid, g_kb,
                                        g_start, g_end, N, autokeys,
                                        fixed_last=False)
                # mispredict: discard the speculative allocator state
                self._restore(snap)
                self.n_mispredicts += 1
                if it < self.max_iters - 1 and not force_trunc:
                    # learn the observed keys, re-predict the interleave
                    keys_pool[order_idx[:N]] = autokeys
                    continue
                # truncate at the first disagreeing grant and commit the
                # verified prefix, that grant's clock fixed to its true
                # duration
                N2 = bad + 1
                if prof is not None:
                    prof.push("burst-verify")
                state2 = self._plan_and_classify(g_tid, g_kb, order_idx,
                                                 it_pool, N2)
                ok = state2 is not None and np.array_equal(
                    state2["keys"][:bad], predicted[:bad])
                if prof is not None:
                    prof.pop()
                if not ok:
                    if state2 is not None:
                        self._restore(snap)
                    self.n_rejects += 1
                    return 0
                self.n_truncations += 1
                return self._commit(heap, cursors, state2, g_tid, g_kb,
                                    g_start, g_end, N2, state2["keys"],
                                    fixed_last=True)
        except Exception:
            if snap is not None:
                self._restore(snap)
            raise
        self.n_rejects += 1
        return 0

    def _vscratch(self, n: int) -> np.ndarray:
        s = self._vscr
        if s is None or s.size < n:
            s = self._vscr = np.empty(n, np.int64)
        return s

    # -- prediction -------------------------------------------------------
    def _dur_key_vec(self, kind: str, keys_arr) -> np.ndarray:
        op = self.fast.ops[kind]
        tc = op._tcache
        uk, inv = np.unique(keys_arr, return_inverse=True)
        ud = np.empty(uk.size, np.float64)
        for j, k in enumerate(uk.tolist()):
            if k < 0:
                ud[j] = 1.0         # unseeded: placeholder pace (iter 1)
                continue
            d = tc.get(k)
            if d is None:
                d = op.time_for_key(k, self._ns_vec)
            ud[j] = d
        return ud[inv]

    def _durations(self, kb_arr, keys_arr, tid_arr=None) -> np.ndarray:
        if tid_arr is not None:
            # keys straight from the per-(tid, kind) seed table: one
            # duration per table cell, gathered per op
            dtab = np.empty(self._seed.shape, np.float64)
            for kbit, kind in ((0, "enq"), (1, "deq")):
                dtab[:, kbit] = self._dur_key_vec(kind,
                                                  self._seed[:, kbit])
            return dtab[tid_arr, kb_arr]
        dur = np.empty(kb_arr.size, np.float64)
        for kbit, kind in ((0, "enq"), (1, "deq")):
            sel = np.nonzero(kb_arr == kbit)[0]
            if sel.size:
                dur[sel] = self._dur_key_vec(kind, keys_arr[sel])
        return dur

    def _predict(self, pool_kb, pool_tid, keys_pool, seg_len_a, seg_t0_a,
                 cursors, from_seed: bool = False):
        """Durations from predicted keys -> per-thread clock windows ->
        global grant order -> hazard truncation.  Pure numpy."""
        dur = self._durations(pool_kb, keys_pool,
                              pool_tid if from_seed else None)
        seg_start = np.concatenate(([0], np.cumsum(seg_len_a)[:-1]))
        first_tid = pool_tid[seg_start]
        lens_a = np.array([self.lens[t] for t in first_tid], np.int64)
        cur_a = np.array([cursors[t] for t in first_tid], np.int64)
        more = (lens_a - cur_a) > seg_len_a
        order, g_tid, g_start, g_end, N = predict_grants(
            dur, seg_len_a, seg_t0_a, pool_tid, more)
        g_kb = pool_kb[order]
        if N == 0:
            return None
        # empty-dequeue hazard: truncate before the first dequeue that
        # would find the FIFO empty (the columnar runner bails there)
        d0 = len(self.fifo)
        isq = g_kb[:N] == 1
        eb = np.cumsum(~isq) - ~isq
        jseq = np.cumsum(isq) - isq
        hzi = np.nonzero(isq & (jseq >= d0 + eb))[0]
        if hzi.size:
            N = int(hzi[0])
            if N == 0:
                return None
        # allocator-exhaustion hazard: conservatively require that each
        # thread's enqueue demand fits its current free list + area/chunk
        # headroom (epoch advances only ever ADD supply), so the planner
        # never needs a mid-burst _new_area / chunk carve
        N = self._alloc_cut(g_tid, g_kb, N)
        if N == 0:
            return None
        return order, g_tid, g_kb, g_start, g_end, N

    def _alloc_cut(self, g_tid, g_kb, N: int) -> int:
        prog = self.prog
        if not (prog.allocs_p or prog.allocs_v):
            return N
        enq_sel = g_kb[:N] == 0
        if not enq_sel.any():
            return N
        demand = np.bincount(g_tid[:N][enq_sel],
                             minlength=self.nv.nthreads)
        mem, valloc = self.mem, self.valloc
        for t in np.nonzero(demand)[0].tolist():
            need = int(demand[t])
            sups = []
            if prog.allocs_p:
                sup = len(mem._free[t])
                if mem._areas[t]:
                    sup += mem.area_nodes - mem._cursor[t]
                sups.append(sup)
            if prog.allocs_v:
                sup = len(valloc._free[t])
                if valloc._base[t] is not None:
                    sup += valloc.chunk_nodes - valloc._cursor[t]
                sups.append(sup)
            sup = min(sups)
            if need > sup:
                pos = np.nonzero((g_tid[:N] == t) & (g_kb[:N] == 0))[0]
                if pos.size > sup:
                    N = int(pos[sup])
        return N

    # -- vectorized planner (pure-enqueue bursts) -------------------------
    def _vector_plan(self, tidN, N: int, badv: int, e_np, e_nv,
                     arrs_e) -> bool:
        """Plan an all-enqueue burst without the per-grant loop.

        When every participating thread's free list is empty (and, with
        epochs in play, no limbo entry exists anywhere) the sequential
        planner reduces to per-thread cursor bumps -- a stable sort by
        tid plus a within-thread ordinal -- and the epoch walk to one
        advance test per 64-op boundary.  Mutates the allocator state
        exactly as the generated planner would; returns False leaving
        it untouched (the caller then runs the sequential planner)."""
        prog = self.prog
        mem, valloc = self.mem, self.valloc
        counts = np.bincount(tidN, minlength=self.nv.nthreads)
        active = np.nonzero(counts)[0]
        act_l = active.tolist()
        if (prog.allocs_p or prog.uses_ssmem) and \
                any(map(bool, mem._limbo.values())):
            return False
        if prog.allocs_p:
            free, areas = mem._free, mem._areas
            if any(free[t] or not areas[t] for t in act_l):
                return False
        if prog.allocs_v:
            vfree, vbase = valloc._free, valloc._base
            if any(vfree[t] or vbase[t] is None for t in act_l):
                return False
        order = np.argsort(tidN, kind="stable")
        cnt_a = counts[active]
        starts = np.concatenate(([0], np.cumsum(cnt_a)[:-1]))
        within = np.arange(N, dtype=np.int64) - np.repeat(starts, cnt_a)
        if prog.allocs_p:
            cur = mem._cursor
            base = np.fromiter(
                (areas[t][-1] + cur[t] * LINE_WORDS for t in act_l),
                np.int64, active.size)
            vals = np.repeat(base, cnt_a) + LINE_WORDS * within
            out = np.empty(N, np.int64)
            out[order] = vals
            arrs_e["new_p"] = out
            e_np.extend(out.tolist())
            for i, t in enumerate(act_l):
                cur[t] += int(cnt_a[i])
        if prog.allocs_v:
            nw = valloc.node_words
            vcur = valloc._cursor
            base = np.fromiter(
                (vbase[t] + vcur[t] * nw for t in act_l),
                np.int64, active.size)
            vals = np.repeat(base, cnt_a) + nw * within
            out = np.empty(N, np.int64)
            out[order] = vals
            arrs_e["new_v"] = out
            e_nv.extend(out.tolist())
            for i, t in enumerate(act_l):
                vcur[t] += int(cnt_a[i])
        if prog.uses_ssmem:
            # each grant announces the epoch current at its turn; the
            # boundary grant announces first, then tests the advance.
            # With no limbo anywhere _try_advance is only the test.
            ann = mem._announced
            nt = mem.nthreads
            ann_arr = np.fromiter(ann.values(), np.int64, nt)
            ep = mem._epoch
            prev, b = 0, badv
            while b < N:
                ann_arr[tidN[prev:b + 1]] = ep
                if int(ann_arr.min()) >= ep:
                    ep += 1
                prev = b + 1
                b += 64
            if prev < N:
                ann_arr[tidN[prev:N]] = ep
            mem._epoch = ep
            ann.update(enumerate(ann_arr.tolist()))
        return True

    # -- plan + classify --------------------------------------------------
    def _plan_and_classify(self, g_tid, g_kb, order_idx, it_pool,
                           N: int) -> Optional[dict]:
        prog = self.prog
        mem = self.mem
        fifo = self.fifo
        kbN = g_kb[:N]
        tidN = g_tid[:N]
        sel_e = np.nonzero(kbN == 0)[0]
        sel_d = np.nonzero(kbN == 1)[0]
        ne = int(sel_e.size)
        nd = int(sel_d.size)
        d0 = len(fifo)
        # current tail/head records (the columnar fns' _t / dbox[0])
        trec = fifo[-1] if fifo else self.dbox[0]
        drec = self.dbox[0]
        t0_p, t0_v, t0_idx = trec[0], trec[1], (trec[3] or 0)
        exist = list(islice(fifo, min(nd, d0)))
        exist_p = [r[0] for r in exist]
        exist_v = [r[1] for r in exist]
        exist_it = [r[2] for r in exist]
        exist_ix = [r[3] for r in exist]
        # epoch-advance boundary (grant whose op_begin advances)
        badv = N + 1
        if prog.uses_ssmem:
            badv = 63 - mem._ops_since_adv
        e_np: List[int] = []
        e_nv: List[Any] = []
        cols_e: Dict[str, list] = {}
        cols_d: Dict[str, list] = {}
        arrs_e: Dict[str, np.ndarray] = {}
        arrs_d: Dict[str, np.ndarray] = {}
        kb_l = tid_l = None     # lazily materialized (sequential paths)
        planned = nd == 0 and prog.vplan and \
            self._vector_plan(tidN, N, badv, e_np, e_nv, arrs_e)
        if planned:
            self.n_vec_plans += 1
        else:
            kb_l = kbN.tolist()
            tid_l = tidN.tolist()
            prog.plan_fn(N, kb_l, tid_l, d0, exist_p, exist_v,
                         drec[0], drec[1], t0_p, t0_v, badv, e_np, e_nv)
        if prog.uses_ssmem:
            # counter after N check-then-increment steps from its
            # pre-burst value (reset at each boundary grant)
            if badv >= N:
                mem._ops_since_adv += N
            else:
                last_b = badv + 64 * ((N - 1 - badv) // 64)
                mem._ops_since_adv = N - 1 - last_b
        if not prog.allocs_p:
            e_np = [0] * ne
        if not prog.allocs_v:
            e_nv = [None] * ne
        # ---- vectorized node-local columns -----------------------------
        need_e = prog.need_syms["enq"]
        need_d = prog.need_syms["deq"]

        def _col_e(name: str, lst: list) -> None:
            cols_e[name] = lst
            if name not in arrs_e:     # the vector planner pre-stashes
                arrs_e[name] = np.fromiter(lst, np.int64, ne) if ne else \
                    np.empty(0, np.int64)

        def _col_d(name: str, lst: list) -> None:
            cols_d[name] = lst
            arrs_d[name] = np.fromiter(lst, np.int64, nd) if nd else \
                np.empty(0, np.int64)

        if "new_p" in need_e:
            _col_e("new_p", e_np)
        if "new_v" in need_e:
            _col_e("new_v", e_nv)
        if "tail_p" in need_e:
            a = arrs_e.get("new_p")
            if a is not None and ne:
                t = np.empty(ne, np.int64)
                t[0] = t0_p
                t[1:] = a[:-1]
                arrs_e["tail_p"] = t
            _col_e("tail_p", [t0_p] + e_np[:-1])
        if "tail_v" in need_e:
            a = arrs_e.get("new_v")
            if a is not None and ne:
                t = np.empty(ne, np.int64)
                t[0] = t0_v
                t[1:] = a[:-1]
                arrs_e["tail_v"] = t
            _col_e("tail_v", [t0_v] + e_nv[:-1])
        e_idx = list(range(t0_idx + 1, t0_idx + 1 + ne))
        # consumed-record chains (source enqueues always precede their
        # dequeue in grant order -- guaranteed by the hazard cut)
        if nd:
            cat_p = exist_p + e_np
            cat_v = exist_v + e_nv
            d_idx = (exist_ix + e_idx)[:nd]
        else:
            cat_p = cat_v = []
            d_idx = []
        if "next_p" in need_d:
            _col_d("next_p", cat_p[:nd])
        if "head_p" in need_d:
            _col_d("head_p", ([drec[0]] + cat_p[:nd - 1]) if nd else [])
        if "next_v" in need_d:
            _col_d("next_v", cat_v[:nd])
        if "head_v" in need_d:
            _col_d("head_v", ([drec[1]] + cat_v[:nd - 1]) if nd else [])
        # items in grant order; dequeue results from the consumed chain
        items_o = it_pool[order_idx[:N]]
        if nd:
            e_items = items_o[sel_e]
            d_items = items_o[sel_d]
            d_res = (exist_it + e_items.tolist())[:nd]
        else:
            e_items = items_o
            d_items = items_o[:0]
            d_res = []
        keys = self._classify(tidN, sel_e, sel_d, arrs_e, arrs_d)
        if keys is None:
            return None
        autokeys, p_fin, v_idx = keys
        return {"keys": autokeys, "p_fin": p_fin, "v_idx": v_idx,
                "sel_e": sel_e, "sel_d": sel_d, "ne": ne, "nd": nd,
                "e_np": e_np, "e_nv": e_nv, "e_idx": e_idx,
                "d_idx": d_idx, "cols_e": cols_e, "cols_d": cols_d,
                "arrs_e": arrs_e, "arrs_d": arrs_d,
                "cons_p": cat_p[:nd] + [t0_p],
                "cons_v": cat_v[:nd] + [t0_v],
                "e_items": e_items, "d_items": d_items, "d_res": d_res,
                "kb_l": kb_l, "tid_l": tid_l}

    def _classify(self, tidN, sel_e, sel_d, arrs_e, arrs_d):
        prog = self.prog
        nv = self.nv
        N = tidN.size
        maxr = prog.max_rows
        span = N * maxr + 1
        p_lines, p_seq, p_c, p_b = [], [], [], []
        p_chunks = []
        v_vis, v_seq = [], []
        v_chunks = []
        off_p = off_v = 0
        for kind, sel, arrs in (("enq", sel_e, arrs_e),
                                ("deq", sel_d, arrs_d)):
            kt = prog.kts[kind]
            ng = sel.size
            if ng == 0:
                continue
            tids_k = tidN[sel]
            R = kt.p_amode.size
            if R:
                A = np.empty((ng, R), np.int64)
                for r in range(R):
                    am = kt.p_amode[r]
                    if am == 0:
                        A[:, r] = kt.p_const[r] // LINE_WORDS
                    elif am == 1:
                        A[:, r] = (arrs[kt.p_sym[r]] + kt.p_off[r]) \
                            // LINE_WORDS
                    else:
                        A[:, r] = (kt.p_const[r]
                                   + tids_k * LINE_WORDS) // LINE_WORDS
                seq = sel[:, None] * maxr + kt.p_pos[None, :]
                p_lines.append(A.ravel())
                p_seq.append(seq.ravel())
                p_c.append(np.broadcast_to(kt.p_c, (ng, R)).ravel())
                p_b.append(np.broadcast_to(kt.p_b, (ng, R)).ravel())
                p_chunks.append((kind, sel, ng, R, off_p))
                off_p += ng * R
            Rv = kt.v_amode.size
            if Rv:
                V = np.empty((ng, Rv), np.int64)
                for r in range(Rv):
                    am = kt.v_amode[r]
                    if am == 0:
                        V[:, r] = kt.v_const[r] + kt.v_off[r]
                    elif am == 1:
                        V[:, r] = arrs[kt.v_sym[r]] + kt.v_off[r] - _VB
                    else:
                        V[:, r] = kt.v_const[r] + tids_k * LINE_WORDS
                # V.ravel() is already seq-ordered (grants ascending,
                # rows in program order); seq is only materialized when
                # two kinds must be merged
                v_vis.append(V.ravel())
                v_seq.append((sel, kt.v_pos))
                v_chunks.append((kind, sel, ng, Rv, off_v))
                off_v += ng * Rv
        keys = np.zeros(N, np.int64)
        p_fin = None
        v_idx = None
        if off_p:
            lv = np.frombuffer(nv._lstate, dtype=np.uint8)
            res = _p_automaton(lv, np.concatenate(p_lines),
                               np.concatenate(p_seq),
                               np.concatenate(p_c),
                               np.concatenate(p_b), span)
            if res is None:
                return None
            out_p, glines, gfin = res
            p_fin = (glines, gfin)
            for kind, sel, ng, R, off in p_chunks:
                kt = prog.kts[kind]
                o2 = out_p[off:off + ng * R]
                contrib = np.zeros(ng, np.int64)
                for r in np.nonzero(kt.p_touch)[0].tolist():
                    contrib += o2[r::R] << kt.p_shift[r]
                keys[sel] += contrib
        if off_v:
            vtv = np.frombuffer(nv._vtouched, dtype=np.uint8)
            if len(v_vis) == 1:
                vis_all = v_vis[0]
                out_v = _v_automaton(vtv, vis_all, None, span,
                                     scratch=self._vscratch(vtv.size))
            else:
                vis_all = np.concatenate(v_vis)
                seq_all = np.concatenate(
                    [(s[:, None] * maxr + pos[None, :]).ravel()
                     for s, pos in v_seq])
                out_v = _v_automaton(vtv, vis_all, seq_all, span)
            v_idx = vis_all
            for kind, sel, ng, Rv, off in v_chunks:
                kt = prog.kts[kind]
                o2 = out_v[off:off + ng * Rv]
                contrib = np.zeros(ng, np.int64)
                for r in range(Rv):
                    contrib += o2[r::Rv] << kt.v_shift[r]
                keys[sel] += contrib
        return keys, p_fin, v_idx

    # -- row-batched value application ------------------------------------
    def _vec_hazards(self, state, tidN) -> bool:
        """Per-burst dynamic safety of the row-batched apply."""
        vap = self.prog.vap
        ne, nd = state["ne"], state["nd"]
        # freshness: no node address both consumed/free and allocated
        # inside the burst (row batching would misorder their writes)
        for check, col, ecol, cons in (
                (vap.check_p, "new_p", "e_np", "cons_p"),
                (vap.check_v, "new_v", "e_nv", "cons_v")):
            if not (check and ne):
                continue
            a = state["arrs_e"].get(col)
            if a is None:
                a = np.fromiter(state[ecol], np.int64, ne)
            u = np.unique(a)
            if u.size != a.size:
                return False
            if np.isin(np.asarray(state[cons], np.int64), u).any():
                return False
        # drains must only meet clean lines: none already dirty, none
        # this burst appends to
        if (ne and vap.drains["enq"]) or (nd and vap.drains["deq"]):
            hazard = {ln for ln, lst in self.nv._log.items() if lst}
            hazard |= vap.logls
            if hazard:
                hz = np.fromiter(hazard, np.int64, len(hazard))
                arrs_all = {"enq": state["arrs_e"], "deq": state["arrs_d"]}
                for kind, sel in (("enq", state["sel_e"]),
                                  ("deq", state["sel_d"])):
                    if not sel.size:
                        continue
                    arrs = arrs_all[kind]
                    tids_k = None
                    for am, sym, off, const in vap.drains[kind]:
                        if am == 0:
                            if const // LINE_WORDS in hazard:
                                return False
                            continue
                        if am == 1:
                            lines = (arrs[sym] + off) // LINE_WORDS
                        else:
                            if tids_k is None:
                                tids_k = tidN[sel]
                            lines = (const + tids_k * LINE_WORDS) \
                                // LINE_WORDS
                        if np.isin(lines, hz).any():
                            return False
        return True

    def _apply_vector(self, state, tidN) -> bool:
        """Apply the burst's value stores row-batched (see the module
        section above); False falls back to the per-grant loop."""
        if not self._vec_hazards(state, tidN):
            return False
        vap = self.prog.vap
        nv = self.nv
        vis, pmem, vval = nv._vis, nv._pmem, nv._vval
        log, ls_obj = nv._log, nv._log_start
        ls_lines, ls_tots, ls_scalar = [], [], {}
        for kind in ("enq", "deq"):
            if kind == "enq":
                sel, arrs, cols = state["sel_e"], state["arrs_e"], \
                    state["cols_e"]
                items_arr, idx_list = state["e_items"], state["e_idx"]
            else:
                sel, arrs, cols = state["sel_d"], state["arrs_d"], \
                    state["cols_d"]
                items_arr, idx_list = state["d_items"], state["d_idx"]
            n_k = int(sel.size)
            if not n_k or not vap.streams[kind]:
                continue
            tids_k = None
            items_list = state.get("e_items_l") if kind == "enq" else None
            obj_cache: dict = {}
            tl = [None]        # lazily computed (ut, lastpos)

            def _list_vals(vt, vp):
                nonlocal items_list
                if vt == "c":
                    return repeat(vp)
                if vt == "item":
                    if items_list is None:
                        items_list = items_arr.tolist()
                    return items_list
                return idx_list if vt == "idx" else cols[vp]

            def _obj_col(vt, vp):
                col = obj_cache.get((vt, vp))
                if col is None:
                    if vt == "item":
                        col = items_arr
                    else:
                        col = np.empty(n_k, dtype=object)
                        if vt == "c":
                            col.fill(vp)
                        else:
                            col[:] = idx_list if vt == "idx" else cols[vp]
                    obj_cache[(vt, vp)] = col
                return col

            def _last_val(vt, vp):
                if vt == "c":
                    return vp
                if vt == "item":
                    return items_arr[-1]
                return (idx_list if vt == "idx" else cols[vp])[-1]

            def _tid_last():
                nonlocal tids_k
                if tl[0] is None:
                    if tids_k is None:
                        tids_k = tidN[sel]
                    ut, rti = np.unique(tids_k[::-1], return_index=True)
                    tl[0] = (ut, n_k - 1 - rti)
                return tl[0]

            for target, am, sym, off, const, vt, vp in vap.streams[kind]:
                if target == "ls":
                    if am == 0:
                        ln = const // LINE_WORDS
                        ls_scalar[ln] = ls_scalar.get(ln, 0) + vp * n_k
                    else:
                        if am == 1:
                            lines = (arrs[sym] + off) // LINE_WORDS
                        else:
                            if tids_k is None:
                                tids_k = tidN[sel]
                            lines = (const + tids_k * LINE_WORDS) \
                                // LINE_WORDS
                        ls_lines.append(lines)
                        ls_tots.append(np.full(n_k, vp, np.int64))
                elif target == "logext":
                    ln = const // LINE_WORDS
                    if vt == "c":
                        ents = [(const, vp)] * n_k
                    else:
                        ents = list(zip(repeat(const), _list_vals(vt, vp)))
                    lg = log.get(ln)
                    if lg is None:
                        log[ln] = ents
                    else:
                        lg.extend(ents)
                elif target == "vval":
                    if am == 0:
                        vval[const - _VB] = _last_val(vt, vp)
                    elif am == 1:
                        vval[arrs[sym] + off - _VB] = _obj_col(vt, vp)
                    else:
                        ut, lastpos = _tid_last()
                        vval[const + ut * LINE_WORDS - _VB] = \
                            _obj_col(vt, vp)[lastpos]
                else:
                    plane = vis if target == "vis" else pmem
                    if am == 0:
                        plane[const] = _last_val(vt, vp)
                    elif am == 1:
                        _consume(map(plane.__setitem__,
                                     (arrs[sym] + off).tolist(),
                                     _list_vals(vt, vp)))
                    else:
                        ut, lastpos = _tid_last()
                        _consume(map(
                            plane.__setitem__,
                            (const + ut * LINE_WORDS).tolist(),
                            _obj_col(vt, vp)[lastpos].tolist()))
        for ln, add in ls_scalar.items():
            ls_obj[ln] += add
        if ls_lines:
            lines = np.concatenate(ls_lines)
            u, inv = np.unique(lines, return_inverse=True)
            sums = np.bincount(inv, weights=np.concatenate(ls_tots))
            ul = u.tolist()
            new = (np.fromiter(map(ls_obj.__getitem__, ul),
                               np.int64, u.size)
                   + sums.astype(np.int64)).tolist()
            _consume(map(ls_obj.__setitem__, ul, new))
        return True

    # -- commit -----------------------------------------------------------
    def _commit(self, heap, cursors, state, g_tid, g_kb, g_start, g_end,
                N: int, autokeys, fixed_last: bool) -> int:
        prof = self.profile
        if prof is not None:
            prof.push("burst-vector-apply")
        try:
            return self._commit_inner(heap, cursors, state, g_tid, g_kb,
                                      g_start, g_end, N, autokeys,
                                      fixed_last)
        finally:
            if prof is not None:
                prof.pop()

    def _commit_inner(self, heap, cursors, state, g_tid, g_kb, g_start,
                      g_end, N: int, autokeys, fixed_last: bool) -> int:
        nv = self.nv
        prog = self.prog
        fifo = self.fifo
        tidN = g_tid[:N]
        kbN = g_kb[:N]
        ends = g_end[:N]
        if fixed_last:
            kind = "deq" if int(kbN[N - 1]) else "enq"
            op = self.fast.ops[kind]
            k = int(autokeys[N - 1])
            d = op._tcache.get(k)
            if d is None:
                d = op.time_for_key(k, self._ns_vec)
            ends = ends.copy()
            ends[N - 1] = g_start[N - 1] + d
        sel_e, sel_d = state["sel_e"], state["sel_d"]
        ne, nd = state["ne"], state["nd"]
        # staged record rows (materialized + charged at the next sync)
        metas = (autokeys << META_KEY_SHIFT) | (tidN << 1) | kbN
        e_items_l = state["e_items"].tolist()
        state["e_items_l"] = e_items_l
        if nd:
            si = np.empty(N, dtype=object)
            si[sel_e] = state["e_items"]
            dr = np.empty(nd, dtype=object)
            dr[:] = state["d_res"]
            si[sel_d] = dr
        else:
            si = state["e_items"]
        self.rs.extend_staged(metas.tobytes(), si, ends.tobytes())
        # value stores: row-batched when the static program and this
        # burst's hazards allow it, else the sequential per-grant loop
        if prog.vap is not None and self._apply_vector(state, tidN):
            self.n_vec_applies += 1
        else:
            cols = prog.cols
            kb_l = state["kb_l"]
            if kb_l is None:
                kb_l, state["tid_l"] = kbN.tolist(), tidN.tolist()
            args = [N, kb_l, state["tid_l"], e_items_l, state["e_idx"]]
            args += [state["cols_e"][s] for s in cols["enq"]]
            args += [state["d_items"].tolist(), state["d_idx"]]
            args += [state["cols_d"][s] for s in cols["deq"]]
            prog.apply_fn(*args)
        # line-state / volatile-touch finals, one scatter each
        if state["p_fin"] is not None:
            glines, gfin = state["p_fin"]
            lv = np.frombuffer(nv._lstate, dtype=np.uint8)
            lv[glines] = gfin.astype(np.uint8)
        if state["v_idx"] is not None:
            vtv = np.frombuffer(nv._vtouched, dtype=np.uint8)
            vtv[state["v_idx"]] = 1
        # FIFO splice: append the burst's records, consume nd from the
        # left, the last consumed record becomes the dummy
        if ne:
            fifo.extend(zip(state["e_np"], state["e_nv"],
                            e_items_l, state["e_idx"]))
        if nd:
            popleft = fifo.popleft
            for _ in range(nd):
                last = popleft()
            self.dbox[0] = last
        # cursors + per-(tid, kind) seeds + heap rebuild
        counts = np.bincount(tidN, minlength=self.nv.nthreads)
        combo = tidN * 2 + kbN
        uniq, ridx = np.unique(combo[::-1], return_index=True)
        lastpos = N - 1 - ridx
        self._seed[uniq // 2, uniq % 2] = autokeys[lastpos]
        rev_t = tidN[::-1]
        ut, rti = np.unique(rev_t, return_index=True)
        last_end = dict(zip(ut.tolist(), ends[N - 1 - rti].tolist()))
        lens = self.lens
        newheap = []
        for t0, t in heap:
            k = int(counts[t])
            if k:
                c = cursors[t] + k
                cursors[t] = c
                if c < lens[t]:
                    newheap.append((last_end[t], t))
            else:
                newheap.append((t0, t))
        heap[:] = newheap
        heapq.heapify(heap)
        self.n_commits += 1
        self.ops_bursted += N
        return N
