"""Pluggable persistence memory models for the NVRAM cost engine.

The paper's measurements assume one platform: Optane DC behind CLWB on
Cascade Lake, where a flush *invalidates* the cache line and the next access
pays NVRAM read latency (the post-flush penalty, the paper's key metric).
Related work evaluates the same designs under different persistence regimes:

* Fatourou et al. ("Highly-Efficient Persistent FIFO Queues") target
  platforms where flushed lines *stay cached*, so post-flush accesses cost a
  cache hit;
* eADR platforms (Ice Lake SP + battery-backed caches) make the cache part of
  the persistence domain: a store is durable once globally visible, flushes
  are unnecessary and fences only order stores;
* CXL-attached memory trades flush-invalidation for a longer read/fence round
  trip through the CXL.mem link.

A :class:`MemoryModel` bundles the latency constants and the behavioural
flags that distinguish these regimes.  Both NVRAM engines (the batched array
engine and the sequential reference), the queue-level persist helpers
(:meth:`repro.core.queue_base.QueueAlgorithm.pflush`) and the contention
layer's retry-cost resolver
(:meth:`repro.core.contention.RetryProfile.event_units` -- a retry's
re-read of flushed content is a post-flush access only under an
invalidating-flush platform) all consult it, which turns "which persistence
platform?" into a benchmark sweep axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union


@dataclass(frozen=True)
class MemoryModel:
    """Latencies (ns) + behaviour flags of one persistence platform."""

    name: str
    # latencies
    cache_hit_ns: float = 1.5      # L1/L2 blend
    dram_miss_ns: float = 80.0     # volatile-region / never-flushed miss
    nvram_read_ns: float = 300.0   # persistent-media random read
    flush_issue_ns: float = 20.0   # CLWB issue (asynchronous)
    fence_base_ns: float = 100.0   # SFENCE drain, base
    fence_per_line_ns: float = 60.0  # per outstanding flushed line / NT line
    movnti_ns: float = 30.0        # non-temporal store issue (asynchronous)
    # behaviour
    flush_invalidates: bool = True   # CLWB evicts the line (Cascade Lake)
    needs_flush: bool = True         # algorithms must issue flushes at all
    persist_on_store: bool = False   # visible => durable (eADR)

    def describe(self) -> str:
        inv = "invalidating" if self.flush_invalidates else "retaining"
        dom = "cache-persistent" if self.persist_on_store else "flush-based"
        return (f"{self.name}: {dom}, {inv} flushes, "
                f"read {self.nvram_read_ns:.0f}ns, "
                f"fence {self.fence_base_ns:.0f}ns")


# Optane DC + CLWB on Cascade Lake: the paper's platform and the seed
# engine's historical behaviour (constants from van Renen'19 / Yang'20).
OPTANE_CLWB = MemoryModel(name="optane-clwb")

# eADR (battery-backed caches in the persistence domain): flushes are
# unnecessary and free, nothing is ever invalidated, stores persist once
# visible; SFENCE degenerates to a store-ordering barrier.
EADR = MemoryModel(
    name="eadr",
    flush_issue_ns=0.0,
    fence_base_ns=30.0,
    fence_per_line_ns=0.0,
    flush_invalidates=False,
    needs_flush=False,
    persist_on_store=True,
)

# CXL-attached persistent memory: flushes write back through the link but
# leave the line cached (no post-flush re-fetch penalty); reads and fence
# drains pay the longer CXL.mem round trip instead.
CXL_MEM = MemoryModel(
    name="cxl",
    nvram_read_ns=450.0,
    flush_issue_ns=25.0,
    fence_base_ns=200.0,
    fence_per_line_ns=90.0,
    flush_invalidates=False,
)

MEMORY_MODELS: Dict[str, MemoryModel] = {
    m.name: m for m in (OPTANE_CLWB, EADR, CXL_MEM)
}


def get_memory_model(model: Union[str, MemoryModel, None]) -> MemoryModel:
    """Resolve a model name (or pass a MemoryModel through; None = Optane)."""
    if model is None:
        return OPTANE_CLWB
    if isinstance(model, MemoryModel):
        return model
    try:
        return MEMORY_MODELS[model]
    except KeyError:
        raise ValueError(
            f"unknown memory model {model!r}; "
            f"known: {sorted(MEMORY_MODELS)}") from None
