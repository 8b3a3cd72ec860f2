"""Fleet runner: chunked execution with the bail/rejoin protocol.

The counterpart of ``repro.fleet.runner``, on the copied harness.  The
fleet advances in chunks of ``FleetConfig.chunk`` plan steps.  Inside a
chunk every active instance runs purely as array data: the CUDA chunk
kernel (backend ``cuda``, the default), its plain PyTorch version
(``torch``) or the numpy reference stepper (``numpy``).  At each chunk
boundary the runner polls for instances that hit a bail condition; each
one is **replayed** on a real per-instance harness -- the same
``run_batched`` path every benchmark uses -- up to the chunk boundary,
then **rejoined**: its integer state is exported back into the fleet
arrays (:func:`repro_torch.fleet.state.export_instance`).  An instance
whose layout diverged from the template cannot rejoin; it finishes its
plan on the Python path and its final counts are merged at the end
("resident").

Replay-from-op-0 is exact: instance plans are deterministic (one seeded
generator), construction is deterministic, and splitting one plan across
successive ``run_batched`` calls on one harness is bit-identical to a
single call.

Plans are **length-clamped** by default (a dequeue is only scheduled while
the tracked queue is non-empty), so a well-sized fleet takes zero bails;
the bail machinery is exercised deliberately by the equivalence tests,
which inject unclamped plans via ``run_fleet(cfg, kinds=...)``.

Nothing falls back: the ``cuda`` backend raises where CUDA is missing, and
a CUDA device never runs the numpy stepper or the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np

from ..core.harness import ALL_QUEUES
from ..core.nvram import N_EV, Stats
from .state import (DEFAULT_PREFILL, Template, area_nodes_for, build_template,
                    export_instance, make_instance_harness, replicate)
from .stepper import run_chunk_numpy

RESIDENT = -2      # bail_at marker: finished out-of-fleet, counts merged

BACKENDS = ("cuda", "torch", "numpy")


@dataclass(frozen=True)
class FleetConfig:
    """One fleet cell: a queue x model x scale point."""
    queue: str = "DurableMSQ"
    model: str = "optane-clwb"
    instances: int = 10_000
    ops: int = 256                  # plan steps per instance
    prefill: int = DEFAULT_PREFILL
    seed: int = 0
    p_deq: float = 0.5
    chunk: int = 64                 # plan steps per vector chunk
    backend: str = "cuda"           # cuda (the kernel) | torch | numpy
    device: str = "cuda"            # torch device of the cuda/torch backends
    batch: int = 0                  # instances per state batch (0 = all)
    contention: str = "off"         # CSV label; one thread per instance, so
                                    # contended counts == uncontended ones


@dataclass
class Fleet:
    cfg: FleetConfig
    template: Template
    kinds: np.ndarray               # (ops, instances) uint8: 0 enq, 1 deq


@dataclass
class FleetResult:
    cfg: FleetConfig
    backend: str                    # backend used
    device: str                     # where the chunks ran
    counts: np.ndarray              # (instances, N_EV) int64
    kinds: np.ndarray
    bails: int                      # bail events (replay+rejoin round trips)
    residents: int                  # instances that finished on Python path
    build_s: float
    run_s: float
    template: Template = field(repr=False, default=None)

    @property
    def total_ops(self) -> int:
        return self.cfg.instances * self.cfg.ops

    @property
    def ops_per_sec(self) -> float:
        return self.total_ops / self.run_s if self.run_s > 0 else 0.0

    def stats_of(self, i: int) -> Stats:
        return self.template.harness.nvram._stats_of(self.counts[i])

    def aggregate(self) -> Stats:
        """Fleet-aggregate Stats: the elementwise sum of every instance's
        counters (time_ns = total simulated nanoseconds across the fleet)."""
        return self.template.harness.nvram._stats_of(self.counts.sum(axis=0))


def fleet_kinds(instances: int, ops: int, seed: int = 0,
                prefill: int = DEFAULT_PREFILL,
                p_deq: float = 0.5) -> np.ndarray:
    """Per-instance op plans as a (ops, instances) uint8 matrix
    (0 = enqueue, 1 = dequeue), drawn from one seeded generator and
    length-clamped so no instance dequeues an empty queue.  Deterministic
    in (instances, ops, seed, prefill, p_deq) -- the equivalence check
    regenerates the same plans independently."""
    rng = np.random.default_rng(seed)
    kinds = np.zeros((ops, instances), dtype=np.uint8)
    length = np.full(instances, prefill, dtype=np.int64)
    for c in range(ops):
        deq = (rng.random(instances) < p_deq) & (length > 0)
        kinds[c] = deq
        length += np.where(deq, -1, 1)
    return kinds


def plan_of(kinds: np.ndarray, i: int, start: int = 0,
            end: Optional[int] = None) -> List[tuple]:
    """Instance i's plan slice in run_batched format."""
    col = kinds[start:end, i]
    base = start
    return [("deq", None) if k else ("enq", ("fleet", int(i), base + t))
            for t, k in enumerate(col)]


def build_fleet(cfg: FleetConfig) -> Fleet:
    """Build the warmed template (one real harness), lower its schedules,
    and draw every instance's plan."""
    template = build_template(cfg.queue, cfg.model, cfg.ops, cfg.prefill)
    kinds = fleet_kinds(cfg.instances, cfg.ops, seed=cfg.seed,
                        prefill=cfg.prefill, p_deq=cfg.p_deq)
    return Fleet(cfg=cfg, template=template, kinds=kinds)


class NumpyBackend:
    """Mask-vectorized numpy stepper over one FleetState batch."""
    name = "numpy"

    def __init__(self, template: Template, state):
        self.t = template
        self.st = state

    def run_chunk(self, kinds: np.ndarray, start: int) -> None:
        run_chunk_numpy(self.t.programs, self.t.dims, self.st, kinds, start)

    def poll(self):
        st = self.st
        fresh = (~st.active) & (st.bail_at >= 0)
        return np.nonzero(fresh)[0], st.bail_at

    def rejoin(self, i: int, row: dict) -> None:
        self.st.set_row(i, row)
        self.st.active[i] = True
        self.st.bail_at[i] = -1

    def retire_resident(self, i: int) -> None:
        self.st.active[i] = False
        self.st.bail_at[i] = RESIDENT

    def counts(self) -> np.ndarray:
        return self.st.counts


def _resolve_backend(cfg: FleetConfig) -> str:
    """-> the device the cell runs on, after checking that the backend
    can run there.  Raises instead of falling back."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown fleet backend {cfg.backend!r} "
                         f"(choose from {', '.join(BACKENDS)})")
    if cfg.backend == "numpy":
        return "cpu"
    import torch
    device = torch.device(cfg.device)
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on a CUDA device, not "
                         f"{cfg.device!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"backend {cfg.backend!r} on {cfg.device!r}: "
                           f"CUDA is not available on this host")
    return str(device)


def _make_backend(name: str, template: Template, n: int, device: str):
    if name == "numpy":
        return NumpyBackend(template, replicate(template.row, template.dims,
                                                n))
    from .torchexec import TorchBackend
    return TorchBackend(template, n, device, use_kernel=(name == "cuda"))


def _replay(template: Template, kinds: np.ndarray, i: int, upto: int):
    """Fresh real harness for instance i, run through plan ops [0, upto)."""
    h = make_instance_harness(
        ALL_QUEUES[template.queue_name], template.model_name,
        area_nodes_for(template.ops, template.prefill), template.prefill)
    plan = plan_of(kinds, i, 0, upto)
    if plan:
        h.run_batched([plan])
    return h


def _final_counts(h) -> np.ndarray:
    h.nvram._drain()
    return h.nvram._counts[0].astype(np.int64).copy()


class _NullScope:
    """No-op stand-ins so the runner's hot loop has one shape whether or
    not a profiler/heartbeat is attached (observation-only contract)."""

    def push(self, name):
        pass

    def pop(self):
        pass

    def configure(self, total_chunks=0, total_ops=0):
        pass

    def advance(self, chunks=0, ops=0, bails=0, rejoins=0, residents=0):
        pass

    def emit(self, now=None, final=False):
        pass


_NULL = _NullScope()


def _run_batch(template: Template, cfg: FleetConfig, kinds: np.ndarray,
               backend_name: str, device: str, base: int,
               prof=_NULL, hb=_NULL):
    """Run one contiguous instance batch; kinds columns are the batch's
    plans, ``base`` the batch's first global instance id (labels only).
    ``prof``/``hb`` are an optional phase profiler and heartbeat (both
    observation-only; defaults are no-ops)."""
    n = kinds.shape[1]
    prof.push("lowering")
    backend = _make_backend(backend_name, template, n, device)
    prof.pop()
    resident_counts = {}
    bails = residents = 0
    chunk_phase = getattr(backend, "chunk_phase", "chunk-step")
    for start in range(0, cfg.ops, cfg.chunk):
        end = min(start + cfg.chunk, cfg.ops)
        prof.push(chunk_phase)
        backend.run_chunk(kinds[start:end], start)
        prof.pop()
        prof.push("poll")
        ids, _ = backend.poll()
        prof.pop()
        rejoins = 0
        for i in ids.tolist():
            bails += 1
            prof.push("bail-replay")
            h = _replay(template, kinds, i, end)
            row = export_instance(h, template.dims)
            if row is not None:
                backend.rejoin(i, row)
                rejoins += 1
                prof.pop()
            else:
                prof.pop()
                residents += 1
                prof.push("resident-replay")
                rest = plan_of(kinds, i, end, cfg.ops)
                if rest:
                    h.run_batched([rest])
                resident_counts[i] = _final_counts(h)
                backend.retire_resident(i)
                prof.pop()
        hb.advance(chunks=1, ops=n * (end - start), bails=len(ids),
                   rejoins=rejoins,
                   residents=len(ids) - rejoins)
    counts = np.asarray(backend.counts(), dtype=np.int64).copy()
    for i, c in resident_counts.items():
        counts[i] = c
    return counts, bails, residents


def run_fleet(cfg: FleetConfig, fleet: Optional[Fleet] = None,
              kinds: Optional[np.ndarray] = None,
              profile=None, heartbeat=None) -> FleetResult:
    """Build (unless given) and run one fleet cell.  ``kinds`` overrides
    the generated plans (the bail/rejoin tests inject unclamped plans).

    ``profile`` attaches an observation-only phase profiler (phases:
    ``lowering``, ``chunk-step``, ``poll``, ``bail-replay``,
    ``resident-replay``; the cuda backend reports its chunks as
    ``kernel-launch``); ``heartbeat`` a progress reporter with
    ``configure``/``advance``/``emit``.  Both are duck-typed, and neither
    changes counts."""
    prof = profile if profile is not None else _NULL
    hb = heartbeat if heartbeat is not None else _NULL
    device = _resolve_backend(cfg)
    t0 = time.perf_counter()
    prof.push("lowering")
    if fleet is None:
        fleet = build_fleet(cfg)
    if kinds is not None:
        kinds = np.asarray(kinds, dtype=np.uint8)
        if kinds.shape != (cfg.ops, cfg.instances):
            raise ValueError(
                f"kinds shape {kinds.shape} != {(cfg.ops, cfg.instances)}")
        fleet = replace(fleet, kinds=kinds)
    prof.pop()
    build_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    bsz = cfg.batch or cfg.instances
    n_batches = (cfg.instances + bsz - 1) // bsz
    chunks_per_batch = (cfg.ops + cfg.chunk - 1) // cfg.chunk
    hb.configure(total_chunks=n_batches * chunks_per_batch,
                 total_ops=cfg.instances * cfg.ops)
    counts = np.zeros((cfg.instances, N_EV), dtype=np.int64)
    bails = residents = 0
    for s in range(0, cfg.instances, bsz):
        e = min(s + bsz, cfg.instances)
        c, b, r = _run_batch(fleet.template, cfg, fleet.kinds[:, s:e],
                             cfg.backend, device, s, prof=prof, hb=hb)
        counts[s:e] = c
        bails += b
        residents += r
    run_s = time.perf_counter() - t1
    if heartbeat is not None:
        hb.emit(final=True)
    return FleetResult(cfg=cfg, backend=cfg.backend, device=device,
                       counts=counts, kinds=fleet.kinds, bails=bails,
                       residents=residents, build_s=build_s, run_s=run_s,
                       template=fleet.template)


def check_instances(result: FleetResult, sample: int = 8, seed: int = 1234,
                    contention=None) -> List[dict]:
    """The correctness gate: re-run sampled instances independently on real
    harnesses (``run_batched`` with the same plan) and compare full Stats
    -- every counter and the derived ``time_ns`` -- for bit-identity."""
    cfg, t = result.cfg, result.template
    k = min(sample, cfg.instances)
    rng = np.random.default_rng(seed)
    ids = sorted(rng.choice(cfg.instances, size=k, replace=False).tolist())
    nv = t.harness.nvram
    rows = []
    for i in ids:
        h = make_instance_harness(
            ALL_QUEUES[t.queue_name], t.model_name,
            area_nodes_for(cfg.ops, cfg.prefill), cfg.prefill)
        plan = plan_of(result.kinds, i, 0, cfg.ops)
        if plan:
            h.run_batched([plan], contention=contention)
        ref = _final_counts(h)
        got = result.counts[i]
        ok = bool(np.array_equal(ref, got)) \
            and nv._stats_of(got) == nv._stats_of(ref)
        rows.append({"instance": i, "ok": ok,
                     "fleet": nv._stats_of(got), "ref": nv._stats_of(ref)})
    return rows
