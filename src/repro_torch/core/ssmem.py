"""ssmem -- epoch-based designated-area allocator (paper §9).

Mirrors the memory manager of Zuriel et al. used by all queues in the paper:

* nodes are allocated from *designated areas* in persistent memory; the list
  of areas is itself persistent, so recovery can scan them;
* a new area is zeroed and persisted with asynchronous flushes + a **single**
  SFENCE (paper §5.1.3) -- zeroed indices/flags make unused nodes invisible
  to recovery;
* each thread has its own allocator (area cursor + free list) to avoid
  synchronization;
* reclamation is epoch-based: ``retire`` defers reuse until every thread has
  passed an epoch boundary, so a node is never recycled while another thread
  may still dereference it;
* free lists are volatile -- after a crash they are reconstructed from the
  areas by the recovery procedure.

Node initialization writes the full line without read-for-ownership
(``write_full_line``): a freshly (re)allocated node's line is entirely
overwritten, which on x86 avoids fetching the (flushed, invalidated) line --
this is what lets the second-amendment queues truly reach **zero post-flush
accesses** on the fast path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .nvram import LINE_WORDS, NVRAM


class SSMem:
    def __init__(self, nvram: NVRAM, nthreads: int, area_nodes: int = 4096,
                 name: str = "ssmem"):
        self.nvram = nvram
        self.nthreads = nthreads
        self.area_nodes = area_nodes
        self.name = name
        # per-thread allocation state (volatile)
        self._areas: Dict[int, List[int]] = {t: [] for t in range(nthreads)}
        self._cursor: Dict[int, int] = {t: 0 for t in range(nthreads)}
        self._free: Dict[int, List[int]] = {t: [] for t in range(nthreads)}
        # epoch-based reclamation (volatile)
        self._epoch = 0
        self._announced: Dict[int, int] = {t: 0 for t in range(nthreads)}
        self._limbo: Dict[int, List[Tuple[int, int, str]]] = {t: [] for t in range(nthreads)}
        self._ops_since_adv = 0
        self._valloc = None   # optional VolatileAlloc sharing the epochs

    # ----------------------------------------------------------------- areas
    def _new_area(self, tid: int) -> int:
        nv = self.nvram
        base = nv.alloc_region(self.area_nodes * LINE_WORDS,
                               name=f"{self.name}:area:t{tid}",
                               persistent=True)
        # zero + persist the whole area with one fence (paper §5.1.3);
        # persist-on-store platforms (eADR) need no flushes at all.
        # On the batched engine, with no per-primitive observers attached
        # (scheduler step hook, trace tap) and no outstanding persists to
        # coalesce into the fence, the whole schedule is applied through
        # the vectorized seam -- bit-identical accounting, ~100x faster.
        if (getattr(nv, "bulk_line_init", None) is not None
                and getattr(nv, "enable_bulk_init", False)
                and nv.step_hook is None and getattr(nv, "_tap", None) is None
                and not nv._pending.get(nv.tid)):
            nv.bulk_line_init(base, self.area_nodes)
        else:
            needs_flush = nv.model.needs_flush
            for i in range(self.area_nodes):
                a = base + i * LINE_WORDS
                nv.write_full_line(a, [0] * LINE_WORDS)
                if needs_flush:
                    nv.flush(a)
            nv.fence()
        self._areas[tid].append(base)
        self._cursor[tid] = 0
        return base

    def area_addrs(self) -> List[Tuple[int, int]]:
        """All designated-area (base, nnodes) pairs -- persistent metadata the
        recovery procedure scans."""
        return [(base, n // LINE_WORDS)
                for (name, base, n, pers) in self.nvram.regions
                if pers and name.startswith(f"{self.name}:area:")]

    # ------------------------------------------------------------ epoch / ebr
    def op_begin(self, tid: int) -> None:
        self._announced[tid] = self._epoch
        self._ops_since_adv += 1
        if self._ops_since_adv >= 64:
            self._ops_since_adv = 0
            self._try_advance()

    def attach_volatile(self, valloc: "VolatileAlloc") -> None:
        """Let a VolatileAlloc reuse this manager's epochs (the Volatile node
        halves of the second-amendment queues need safe reclamation too)."""
        self._valloc = valloc

    def _try_advance(self) -> None:
        min_e = min(self._announced.values())
        if min_e >= self._epoch:
            self._epoch += 1
        # limbo entries carry the epoch current at retire time, so each
        # per-thread list is sorted by epoch and the reclaimable entries
        # (ep + 2 <= min_e) form a prefix: scan it, free in list order
        # (same order the full rebuild produced), drop it in place.  The
        # common case -- nothing reclaimable yet -- is one comparison per
        # thread instead of rebuilding every keep-list.
        cut = min_e - 2
        for t, lst in self._limbo.items():
            if not lst or lst[0][1] > cut:
                continue
            free_t = self._free[t]
            i, n = 0, len(lst)
            while i < n and lst[i][1] <= cut:
                addr, _, kind = lst[i]
                if kind == "p":
                    free_t.append(addr)
                else:
                    self._valloc.free(t, addr)
                i += 1
            del lst[:i]

    # ------------------------------------------------------------ alloc/free
    def alloc(self, tid: int) -> int:
        if self._free[tid]:
            return self._free[tid].pop()
        if not self._areas[tid] or self._cursor[tid] >= self.area_nodes:
            self._new_area(tid)
        base = self._areas[tid][-1]
        addr = base + self._cursor[tid] * LINE_WORDS
        self._cursor[tid] += 1
        return addr

    def retire(self, tid: int, addr: int) -> None:
        self._limbo[tid].append((addr, self._epoch, "p"))

    def retire_volatile(self, tid: int, addr: int) -> None:
        self._limbo[tid].append((addr, self._epoch, "v"))

    def free_now(self, tid: int, addr: int) -> None:
        """Recovery-time reclamation (no concurrent readers exist)."""
        self._free[tid].append(addr)


class VolatileAlloc:
    """Bump/free-list allocator in the volatile address space (DRAM), used
    for the Volatile halves of the second-amendment queues' nodes."""

    def __init__(self, nvram: NVRAM, nthreads: int, node_words: int = LINE_WORDS,
                 chunk_nodes: int = 4096, name: str = "vol"):
        self.nvram = nvram
        self.node_words = node_words
        self.chunk_nodes = chunk_nodes
        self.name = name
        self._free: Dict[int, List[int]] = {t: [] for t in range(nthreads)}
        self._base: Dict[int, Optional[int]] = {t: None for t in range(nthreads)}
        self._cursor: Dict[int, int] = {t: 0 for t in range(nthreads)}

    def alloc(self, tid: int) -> int:
        if self._free[tid]:
            return self._free[tid].pop()
        if self._base[tid] is None or self._cursor[tid] >= self.chunk_nodes:
            self._base[tid] = self.nvram.alloc_region(
                self.chunk_nodes * self.node_words,
                name=f"{self.name}:chunk:t{tid}", persistent=False)
            self._cursor[tid] = 0
        addr = self._base[tid] + self._cursor[tid] * self.node_words
        self._cursor[tid] += 1
        return addr

    def free(self, tid: int, addr: int) -> None:
        self._free[tid].append(addr)
