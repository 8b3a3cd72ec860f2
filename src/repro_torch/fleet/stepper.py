"""Numpy reference stepper: the fleet's semantics, mask-vectorized.

Executes one lowered op (:class:`repro.fleet.lowering.FleetProgram`) for
every active instance whose next plan step is that op kind, with boolean
masks standing in for control flow.  The order of effects per op mirrors
the generated fast-path function exactly (``repro.core.opsched.
generate_fast_fn``):

1. bail detection (empty dequeue, guard failures, allocator refills) --
   **before** any state change, so a bailing op leaves its instance
   untouched for the Python-path replay;
2. ``op_begin``: epoch announce + the 64-op advance cadence (limbo entries
   two epochs stale move to the free stacks, in retirement order);
3. env binding (FIFO tail/head records, guard slot) + allocations
   (free-stack pop, else cursor bump);
4. the classification/state micro-ops, charging dynamic outcomes;
5. the static base-count vector;
6. the logical FIFO update, then aux effects (retire -> limbo, slot
   stores, persisted-set bits) -- in that order, as in the fast path.

This backend is the semantic reference for :mod:`repro.fleet.jaxexec`
(cross-checked by ``tests/test_fleet_equivalence.py``) and the fallback
when jax is unavailable.  The effect order spelled out above is a
three-way contract: the unrolled jax stepper, the opcode interpreter
(``jax-opcode``) and the Pallas chunk kernel (``pallas``) all replay it
exactly -- anything reordered here must be reordered there, and the
opcode encoding in :mod:`repro.fleet.lowering` must keep round-tripping.
"""
from __future__ import annotations

import numpy as np

from ..core.nvram import (EV_COLD_DRAM, EV_COLD_NVM, EV_DRAM, EV_HIT,
                          EV_POSTFLUSH, LINE_WORDS)
from ..core.opsched import NULL, ST_EVERFL, ST_INVAL
from .lowering import KIND_DEQ, KIND_ENQ, SYM, FleetPrograms
from .state import FleetDims, FleetState

E_NEW_P, E_NEW_V = SYM["new_p"], SYM["new_v"]
E_TAIL_P, E_TAIL_V = SYM["tail_p"], SYM["tail_v"]
E_HEAD_P, E_HEAD_V = SYM["head_p"], SYM["head_v"]
E_NEXT_P, E_NEXT_V = SYM["next_p"], SYM["next_v"]
E_PREV = SYM["prev"]

EPOCH_ADV_OPS = 64     # SSMem.op_begin's advance cadence


def run_chunk_numpy(programs: FleetPrograms, dims: FleetDims, st: FleetState,
                    kinds: np.ndarray, start_op: int) -> None:
    """Run ``kinds.shape[0]`` plan steps for all instances, in place.
    ``kinds[c, i]`` is instance i's op at global index ``start_op + c``
    (0 = enq, 1 = deq).  Instances that hit a bail condition record
    ``bail_at`` and go inactive for the rest of the chunk."""
    rows = np.arange(st.n)
    for c in range(kinds.shape[0]):
        k = kinds[c]
        for prog in programs:
            m = st.active & (k == prog.code)
            if m.any():
                _apply_op(prog, dims, st, m, rows, start_op + c)


def _advance(dims: FleetDims, st: FleetState, adv: np.ndarray) -> None:
    """SSMem._try_advance at one thread: announced == epoch, so the epoch
    always advances; limbo entries with ``ep + 2 <= min_e`` (min_e = the
    pre-advance epoch) free in retirement order."""
    min_e = st.epoch.copy()
    st.epoch[adv] += 1
    j = np.arange(dims.lcap)[None, :]
    inlimbo = j < st.nlimbo[:, None]
    fr = inlimbo & (st.limbo_e + 2 <= min_e[:, None]) & adv[:, None]
    if not fr.any():
        return
    is_p = st.limbo_k == 0
    for sel, stack, nname in ((fr & is_p, st.free_p, "nfree"),
                              (fr & ~is_p, st.vfree, "nvfree")):
        if not sel.any():
            continue
        nfree = getattr(st, nname)
        cnt = np.cumsum(sel, axis=1)
        dest = nfree[:, None] + cnt - 1
        ii, jj = np.nonzero(sel)
        stack[ii, dest[ii, jj]] = st.limbo_a[ii, jj]
        nfree += cnt[:, -1].astype(nfree.dtype)
    # compact the kept entries, preserving order
    keep = inlimbo & ~fr
    order = np.argsort(~keep, axis=1, kind="stable")
    chg = fr.any(axis=1)
    for arr in (st.limbo_a, st.limbo_e, st.limbo_k):
        arr[chg] = np.take_along_axis(arr, order, axis=1)[chg]
    st.nlimbo -= fr.sum(axis=1).astype(st.nlimbo.dtype)


def _apply_op(prog, dims: FleetDims, st: FleetState, m: np.ndarray,
              rows: np.ndarray, op_idx: int) -> None:
    cap = dims.cap
    # ---- tail record (enq env and the tail_persisted guard) -------------
    tail_p = tail_v = None
    needs_tail = prog.code == KIND_ENQ or any(
        g[0] == "tail_persisted" for g in prog.guards)
    if needs_tail:
        has = st.length > 0
        tpos = (st.head + np.maximum(st.length - 1, 0)) % cap
        tail_p = np.where(has, st.ring_p[rows, tpos], st.dummy_p)
        tail_v = np.where(has, st.ring_v[rows, tpos], st.dummy_v)
    # ---- bail detection (no state changed yet) --------------------------
    bail = np.zeros(st.n, dtype=bool)
    if prog.code == KIND_DEQ:
        bail |= st.length == 0
    for g in prog.guards:
        if g[0] == "slot_nonnull":
            bail |= st.slots[g[1]] == NULL
        else:                               # tail_persisted
            bail |= st.persisted[rows, tail_p // LINE_WORDS] == 0
    if prog.allocs_p:
        bail |= (st.nfree == 0) & (st.cursor >= dims.area_cap)
    if prog.allocs_v:
        # conservative fleet-only bail: a chunk refill would change the
        # address layout, so such instances run on the Python path
        bail |= (st.nvfree == 0) & (st.vcursor >= dims.chunk_cap)
    newly = m & bail
    if newly.any():
        st.bail_at[newly] = op_idx
        st.active &= ~newly
        m = m & ~newly
        if not m.any():
            return
    # ---- op_begin: epoch machinery --------------------------------------
    if prog.uses_ssmem:
        st.opsctr[m] += 1
        adv = m & (st.opsctr >= EPOCH_ADV_OPS)
        if adv.any():
            st.opsctr[adv] = 0
            _advance(dims, st, adv)
    # ---- env + allocations ----------------------------------------------
    env = {}
    if prog.code == KIND_ENQ:
        env[E_TAIL_P], env[E_TAIL_V] = tail_p, tail_v
    else:
        hpos = st.head % cap
        env[E_HEAD_P] = st.dummy_p.copy()
        env[E_HEAD_V] = st.dummy_v.copy()
        env[E_NEXT_P] = st.ring_p[rows, hpos]
        env[E_NEXT_V] = st.ring_v[rows, hpos]
    for attr in prog.slot_attrs:
        env[E_PREV] = st.slots[attr].copy()
    if prog.allocs_p:
        use = m & (st.nfree > 0)
        top = st.free_p[rows, np.maximum(st.nfree - 1, 0)]
        env[E_NEW_P] = np.where(
            use, top,
            dims.area_base + st.cursor.astype(np.int64) * LINE_WORDS
        ).astype(np.int32)
        st.nfree[use] -= 1
        st.cursor[m & ~use] += 1
    if prog.allocs_v:
        use = m & (st.nvfree > 0)
        top = st.vfree[rows, np.maximum(st.nvfree - 1, 0)]
        env[E_NEW_V] = np.where(
            use, top,
            dims.chunk_base + st.vcursor.astype(np.int64) * dims.node_words
        ).astype(np.int32)
        st.nvfree[use] -= 1
        st.vcursor[m & ~use] += 1
    # ---- micro-ops -------------------------------------------------------
    im = rows[m]
    counts = st.counts
    for ins in prog.micro:
        tag, ref = ins[0], ins[1]
        if ref.mode == "const":
            a = ref.const
        else:
            a = env[ref.sym][im] + ref.off
        if tag == "class_p":
            ln = a // LINE_WORDS
            c = st.cached[im, ln]
            f = st.finval[im, ln]
            e = st.everfl[im, ln]
            ev = np.where(c == 1, EV_HIT,
                          np.where(f == 1, EV_POSTFLUSH,
                                   np.where(e == 1, EV_COLD_NVM,
                                            EV_COLD_DRAM)))
            counts[im, ev] += 1
            st.cached[im, ln] = 1
            st.finval[im, ln] = 0
        elif tag == "class_v":
            t = st.vtouched[im, a]
            counts[im, np.where(t == 1, EV_HIT, EV_DRAM)] += 1
            st.vtouched[im, a] = 1
        elif tag == "state":
            mode = ins[2]
            ln = a // LINE_WORDS
            if mode == ST_INVAL:
                st.cached[im, ln] = 0
                st.finval[im, ln] = 1
                st.everfl[im, ln] = 1
            elif mode == ST_EVERFL:
                st.everfl[im, ln] = 1
            else:                           # ST_RECACHE
                st.cached[im, ln] = 1
                st.finval[im, ln] = 0
        else:                               # "line"
            ln = a // LINE_WORDS
            st.cached[im, ln] = 1
            st.finval[im, ln] = 0
    # ---- static counts ---------------------------------------------------
    counts[im] += prog.base_counts
    # ---- logical FIFO ----------------------------------------------------
    if prog.code == KIND_ENQ:
        pos = (st.head + st.length) % cap
        st.ring_p[im, pos[im]] = env[E_NEW_P][im] if prog.allocs_p else 0
        st.ring_v[im, pos[im]] = env[E_NEW_V][im] if prog.allocs_v else 0
        st.length[m] += 1
    else:
        st.dummy_p[m] = env[E_NEXT_P][m]
        st.dummy_v[m] = env[E_NEXT_V][m]
        st.head[m] = (st.head[m] + 1) % cap
        st.length[m] -= 1
    # ---- aux effects -----------------------------------------------------
    for ax in prog.aux:
        t0 = ax[0]
        if t0 == "limbo":
            pos = st.nlimbo[im]
            st.limbo_a[im, pos] = env[ax[1]][im]
            st.limbo_e[im, pos] = st.epoch[im]
            st.limbo_k[im, pos] = 0 if ax[2] == "p" else 1
            st.nlimbo[m] += 1
        elif t0 == "slot":
            st.slots[ax[1]][m] = env[ax[2]][m]
        elif t0 == "pdiscard":
            st.persisted[im, env[ax[1]][im] // LINE_WORDS] = 0
        else:                               # padd
            for sym in ax[1]:
                st.persisted[im, env[sym][im] // LINE_WORDS] = 1
