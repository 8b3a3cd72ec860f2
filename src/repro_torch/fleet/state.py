"""Fleet state: one warmed template instance, replicated N times.

Queue construction is deterministic: building the same queue class on a
fresh engine always produces the same region layout, the same dummy node,
the same allocator cursors.  The fleet exploits this by building **one**
template harness (construction + prefill + warmup), exporting its integer
state, and replicating it across N instances -- every instance then shares
the template's address map, so the lowered programs' constant addresses are
valid fleet-wide.

What gets exported is exactly the state the Stats-only programs read or
write (see :mod:`repro.fleet.lowering`):

* per-line cached/finval/everfl bits and per-word volatile touched bits;
* the logical FIFO (pnode/vnode rings + dummy) -- the executor's
  ``(pnode, vnode, item, idx)`` records minus items/indices, which feed
  value stores only;
* ssmem state: free stack, area cursor, limbo ring, epoch, op counter
  (64-op advance cadence), and the VolatileAlloc twin;
* guard slots, the persisted set (as a line bitmap), per-thread counts.

``export_instance`` is also the **rejoin** path: after a bailed instance is
replayed on a real per-instance harness, its state is exported back into
the fleet arrays -- provided its layout still matches the template (an
instance that grew a new area/chunk mid-run stays resident on the Python
path; ``export_instance`` returns None for it).

The ``prefill + warmup`` protocol mirrors the benchmark harness: prefill
enqueues give dequeues something to consume, and one warmup
enqueue+dequeue pair retires the sentinel state that would otherwise make
every instance's first ops bail (NULL retire/flush slots, non-durable walk
anchors -- the fast path's documented warmup bails).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.harness import ALL_QUEUES, QueueHarness
from ..core.nvram import LINE_WORDS, NVRAM
from ..core.opsched import NULL, FastPathExecutor
from .lowering import FleetPrograms, lower_queue

_VB = NVRAM._VOLATILE_BASE

DEFAULT_PREFILL = 10


@dataclass(frozen=True)
class FleetDims:
    """Template-wide constants every instance shares."""
    nl: int                  # persistent lines tracked
    nvw: int                 # volatile words tracked (>= 1)
    cap: int                 # FIFO ring capacity
    fcap: int                # persistent free-stack capacity
    vfcap: int               # volatile free-stack capacity
    lcap: int                # limbo ring capacity
    area_base: int           # the single ssmem area's base address
    area_cap: int            # area_nodes
    chunk_base: int          # volatile chunk base offset (-1: no valloc)
    chunk_cap: int           # usable chunk nodes (conservative)
    node_words: int          # valloc node width
    p_brk: int               # template persistent brk (layout fingerprint)
    v_brk: int               # template volatile brk
    slot_attrs: Tuple[str, ...]
    needs_persisted: bool
    uses_valloc: bool
    uses_ssmem: bool


@dataclass
class FleetState:
    """Struct-of-arrays over N instances (numpy, instance axis first)."""
    n: int
    dims: FleetDims
    cached: np.ndarray       # uint8 [N, nl]
    finval: np.ndarray
    everfl: np.ndarray
    persisted: np.ndarray    # uint8 [N, nl] (or [N, 1] when unused)
    vtouched: np.ndarray     # uint8 [N, nvw]
    ring_p: np.ndarray       # int32 [N, cap]
    ring_v: np.ndarray
    free_p: np.ndarray       # int32 [N, fcap]
    vfree: np.ndarray        # int32 [N, vfcap]
    limbo_a: np.ndarray      # int32 [N, lcap]
    limbo_e: np.ndarray      # int32 [N, lcap]
    limbo_k: np.ndarray      # uint8 [N, lcap]  (0 = p, 1 = v)
    counts: np.ndarray       # int64 [N, N_EV]
    head: np.ndarray         # int32 [N] -- ring read position
    length: np.ndarray       # int32 [N] -- logical FIFO length
    dummy_p: np.ndarray
    dummy_v: np.ndarray
    nfree: np.ndarray
    cursor: np.ndarray
    nvfree: np.ndarray
    vcursor: np.ndarray
    nlimbo: np.ndarray
    epoch: np.ndarray
    opsctr: np.ndarray
    active: np.ndarray       # bool [N]
    bail_at: np.ndarray      # int32 [N]: global op index of first bail, -1
    slots: Dict[str, np.ndarray] = field(default_factory=dict)

    def set_row(self, i: int, row: dict) -> None:
        for name, val in row.items():
            if name == "slots":
                for attr, v in val.items():
                    self.slots[attr][i] = v
            else:
                getattr(self, name)[i] = val

    def get_counts(self, i: int) -> np.ndarray:
        return self.counts[i]


def make_instance_harness(queue_cls, model, area_nodes: int,
                          prefill: int = DEFAULT_PREFILL) -> QueueHarness:
    """The shared builder: the fleet template, the per-instance
    equivalence-check harnesses and the bail-replay harnesses all come
    from here, so construction + prefill + warmup are identical."""
    h = QueueHarness(queue_cls, nthreads=1, area_nodes=area_nodes,
                     model=model)
    for i in range(prefill):
        h.queue.enqueue(0, ("pre", i))
    # warmup: one enq+deq pair populates the per-thread retire/flush slots
    # and durable-walk anchors so instance op #1 doesn't warmup-bail
    h.queue.enqueue(0, ("warm", 0))
    h.queue.dequeue(0)
    return h


def area_nodes_for(ops: int, prefill: int = DEFAULT_PREFILL) -> int:
    """An area large enough that no instance ever hits a refill bail:
    total persistent allocations are bounded by dummy + prefill + warmup +
    one per op (frees only shrink demand)."""
    return prefill + ops + 16


@dataclass
class Template:
    queue_name: str
    model_name: str
    prefill: int
    ops: int
    harness: QueueHarness
    programs: FleetPrograms
    dims: FleetDims
    row: dict                      # exported instance-0 state


def derive_dims(h: QueueHarness, programs: FleetPrograms,
                ops: int) -> FleetDims:
    nv, q, mem = h.nvram, h.queue, h.mem
    nl = -(-nv._brk // LINE_WORDS)
    uses_ssmem = programs.enq.uses_ssmem or programs.deq.uses_ssmem
    valloc = getattr(q, "valloc", None)
    uses_valloc = valloc is not None
    if uses_valloc:
        chunk_abs = valloc._base[0]
        assert chunk_abs is not None, "valloc chunk not allocated at warmup"
        chunk_base = chunk_abs - _VB
        node_words = valloc.node_words
        chunk_cap = min(valloc.chunk_nodes, valloc._cursor[0] + ops + 4)
        nvw = chunk_base + chunk_cap * node_words
        if chunk_base + valloc.chunk_nodes * node_words < nv._vbrk - _VB:
            # chunk is not the last volatile region: track the full span
            nvw = nv._vbrk - _VB
    else:
        chunk_base, chunk_cap, node_words = -1, 0, 1
        nvw = nv._vbrk - _VB
    areas = mem._areas[0]
    # MSQ never allocates persistent nodes: no ssmem area at all
    assert len(areas) <= 1, "template must have at most one ssmem area"
    area_base = areas[0] if areas else 0
    area_cap = mem.area_nodes if areas else 0
    fifo_len = _walk_fifo_len(h)
    free0 = len(mem._free[0])
    vfree0 = len(valloc._free[0]) if uses_valloc else 0
    limbo0 = len(mem._limbo[0])
    return FleetDims(
        nl=nl,
        nvw=max(nvw, 1),
        cap=fifo_len + ops + 2,
        fcap=free0 + limbo0 + ops + 6,
        vfcap=vfree0 + limbo0 + ops + 6,
        lcap=limbo0 + 2 * ops + 6,
        area_base=area_base,
        area_cap=area_cap,
        chunk_base=chunk_base,
        chunk_cap=chunk_cap,
        node_words=node_words,
        p_brk=nv._brk,
        v_brk=nv._vbrk,
        slot_attrs=programs.guard_slot_attrs,
        needs_persisted=programs.needs_persisted,
        uses_valloc=uses_valloc,
        uses_ssmem=uses_ssmem,
    )


def _walk_fifo_len(h: QueueHarness) -> int:
    ex = FastPathExecutor(h.queue, h.nvram)
    return len(ex.fifo)


def export_instance(h: QueueHarness, dims: FleetDims) -> Optional[dict]:
    """Harness -> one fleet state row (dict of scalars / padded arrays).

    Returns None when the harness no longer matches the template layout
    (grew an area or a chunk, or has leftover unfenced persists) -- the
    instance must then stay resident on the Python path.
    """
    nv, q, mem = h.nvram, h.queue, h.mem
    if nv._brk != dims.p_brk or nv._vbrk != dims.v_brk:
        return None
    if nv._pending.get(0):
        return None
    areas = mem._areas[0]
    if dims.area_cap:
        if len(areas) != 1 or areas[0] != dims.area_base:
            return None
    elif areas:
        return None
    valloc = getattr(q, "valloc", None)
    if dims.uses_valloc and valloc._base[0] - _VB != dims.chunk_base:
        return None
    ex = FastPathExecutor(h.queue, h.nvram)
    if len(ex.fifo) >= dims.cap:
        return None
    nv._drain()
    row: dict = {}
    # the engine packs line state into one byte array; the fleet lowering
    # keeps separate planes, so unpack through the export seam
    cached, finval, everfl = nv.line_state_arrays(dims.nl)
    row["cached"] = _pad_u8(cached, dims.nl)
    row["finval"] = _pad_u8(finval, dims.nl)
    row["everfl"] = _pad_u8(everfl, dims.nl)
    row["vtouched"] = _pad_u8(nv.vtouched_array(dims.nvw), dims.nvw)
    pers = np.zeros(dims.nl if dims.needs_persisted else 1, dtype=np.uint8)
    if dims.needs_persisted:
        for addr in getattr(q, "_persisted", ()):
            ln = addr // LINE_WORDS
            if ln >= dims.nl:
                return None
            pers[ln] = 1
    row["persisted"] = pers
    # logical FIFO
    ring_p = np.zeros(dims.cap, dtype=np.int32)
    ring_v = np.zeros(dims.cap, dtype=np.int32)
    for j, rec in enumerate(ex.fifo):
        ring_p[j] = rec[0] or 0
        ring_v[j] = (rec[1] - _VB) if rec[1] else 0
    row["ring_p"], row["ring_v"] = ring_p, ring_v
    row["head"], row["length"] = 0, len(ex.fifo)
    d = ex.dummy
    row["dummy_p"] = d[0] or 0
    row["dummy_v"] = (d[1] - _VB) if d[1] else 0
    # ssmem
    free0 = mem._free[0]
    if len(free0) > dims.fcap:
        return None
    fp = np.zeros(dims.fcap, dtype=np.int32)
    fp[:len(free0)] = free0
    row["free_p"], row["nfree"] = fp, len(free0)
    row["cursor"] = mem._cursor[0]
    limbo = mem._limbo[0]
    if len(limbo) > dims.lcap:
        return None
    la = np.zeros(dims.lcap, dtype=np.int32)
    le = np.zeros(dims.lcap, dtype=np.int32)
    lk = np.zeros(dims.lcap, dtype=np.uint8)
    for j, (addr, ep, kind) in enumerate(limbo):
        la[j] = addr - _VB if kind == "v" else addr
        le[j] = ep
        lk[j] = 1 if kind == "v" else 0
    row["limbo_a"], row["limbo_e"], row["limbo_k"] = la, le, lk
    row["nlimbo"] = len(limbo)
    row["epoch"], row["opsctr"] = mem._epoch, mem._ops_since_adv
    # valloc
    vf = np.zeros(dims.vfcap, dtype=np.int32)
    if dims.uses_valloc:
        vfree0 = valloc._free[0]
        if len(vfree0) > dims.vfcap:
            return None
        vf[:len(vfree0)] = [a - _VB for a in vfree0]
        row["nvfree"] = len(vfree0)
        row["vcursor"] = valloc._cursor[0]
    else:
        row["nvfree"] = 0
        row["vcursor"] = 0
    row["vfree"] = vf
    # guard slots
    slots = {}
    for attr in dims.slot_attrs:
        v = getattr(q, attr)[0]
        slots[attr] = int(v) if v else NULL
    row["slots"] = slots
    row["counts"] = nv._counts[0].astype(np.int64).copy()
    return row


def _pad_u8(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.uint8)
    out[:len(a)] = a[:n]
    return out


def replicate(row: dict, dims: FleetDims, n: int) -> FleetState:
    """Tile one exported instance row across N instances."""
    def tile(v, dtype):
        if np.isscalar(v):
            return np.full(n, v, dtype=dtype)
        return np.repeat(np.asarray(v, dtype=dtype)[None, :], n, axis=0)

    slots = {attr: np.full(n, val, dtype=np.int32)
             for attr, val in row["slots"].items()}
    return FleetState(
        n=n, dims=dims,
        cached=tile(row["cached"], np.uint8),
        finval=tile(row["finval"], np.uint8),
        everfl=tile(row["everfl"], np.uint8),
        persisted=tile(row["persisted"], np.uint8),
        vtouched=tile(row["vtouched"], np.uint8),
        ring_p=tile(row["ring_p"], np.int32),
        ring_v=tile(row["ring_v"], np.int32),
        free_p=tile(row["free_p"], np.int32),
        vfree=tile(row["vfree"], np.int32),
        limbo_a=tile(row["limbo_a"], np.int32),
        limbo_e=tile(row["limbo_e"], np.int32),
        limbo_k=tile(row["limbo_k"], np.uint8),
        counts=tile(row["counts"], np.int64),
        head=tile(row["head"], np.int32),
        length=tile(row["length"], np.int32),
        dummy_p=tile(row["dummy_p"], np.int32),
        dummy_v=tile(row["dummy_v"], np.int32),
        nfree=tile(row["nfree"], np.int32),
        cursor=tile(row["cursor"], np.int32),
        nvfree=tile(row["nvfree"], np.int32),
        vcursor=tile(row["vcursor"], np.int32),
        nlimbo=tile(row["nlimbo"], np.int32),
        epoch=tile(row["epoch"], np.int32),
        opsctr=tile(row["opsctr"], np.int32),
        active=np.ones(n, dtype=bool),
        bail_at=np.full(n, -1, dtype=np.int32),
        slots=slots,
    )


def build_template(queue_name: str, model, ops: int,
                   prefill: int = DEFAULT_PREFILL) -> Template:
    """Build + warm one template instance and lower its schedules."""
    queue_cls = ALL_QUEUES[queue_name]
    h = make_instance_harness(queue_cls, model, area_nodes_for(ops, prefill),
                              prefill)
    programs = lower_queue(h.queue, h.nvram.model)
    dims = derive_dims(h, programs, ops)
    row = export_instance(h, dims)
    assert row is not None, "template instance must export cleanly"
    return Template(queue_name=queue_name, model_name=h.nvram.model.name,
                    prefill=prefill, ops=ops, harness=h, programs=programs,
                    dims=dims, row=row)
