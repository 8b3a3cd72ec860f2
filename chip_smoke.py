#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc/``, holds
each against its plain PyTorch version on the card, drives the port's main
path (the fleet executor, ``repro_torch.fleet.run_fleet``) at full size,
and checks the result against independent per-instance harnesses.  It
imports nothing of JAX or of the JAX package.  Every failure raises and
exits non-zero; a host without CUDA exits 2 and prints no result.

Phases:

1. device: card name and power limit, versions, kernel build;
2. kernel vs plain: all 8 queues x optane-clwb/eadr/cxl at 4,096
   instances x 96 ops (chunk 48), the CUDA and plain backends stepped
   side by side from one state and compared tensor by tensor after every
   chunk, final counts held to the numpy reference stepper; forced
   bail/rejoin cells; 400-op epoch-reclamation cells;
3. main path: DurableMSQ, OptUnlinkedQ and OptLinkedQ under optane-clwb
   at 1,000,000 instances x 96 ops, chunk 48, on the kernel, with
   ``check_instances`` 8/8, kernel launches counted, the kernel stepped
   side by side with the plain version at that size, and per queue the
   kernel's and the plain version's time per chunk, the byte bound, peak
   device memory and (from a second, profiled run) host seconds per
   runner phase.

The line before the last holds one JSON object with each kernel's
numbers; the last line is the device summary.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
DEVICE = "cuda"
MATRIX_QUEUES = ("MSQ", "DurableMSQ", "IzraelevitzQ", "NVTraverseQ",
                 "UnlinkedQ", "LinkedQ", "OptUnlinkedQ", "OptLinkedQ")
MATRIX_MODELS = ("optane-clwb", "eadr", "cxl")
MAIN_QUEUES = ("DurableMSQ", "OptUnlinkedQ", "OptLinkedQ")
MATRIX_INSTANCES = 4096
MAIN_INSTANCES, MAIN_OPS, CHUNK = 1_000_000, 96, 48
KERNEL_REPS, PLAIN_REPS = 10, 2


def log(msg):
    print(msg, flush=True)


def compare_states(a: dict, b: dict, where: str) -> int:
    """Raise unless every state tensor is equal -> the largest absolute
    difference, which is then 0: the state is integers, no tolerance."""
    import torch
    for key in a:
        if not torch.equal(a[key], b[key]):
            diff = (a[key].to(torch.int64) - b[key].to(torch.int64)).abs()
            raise AssertionError(
                f"{where}: kernel and plain differ in {key!r} (max abs "
                f"diff {int(diff.max())}, {int((diff != 0).sum())} entries)")
    return 0


def lockstep(template, kinds, chunk, device, where):
    """Step the kernel and the plain backend side by side from the same
    state, comparing every state tensor after every chunk.  Plans must be
    length-clamped (no bails).  -> (kernel backend, max abs err)."""
    from repro_torch.fleet.torchexec import TorchBackend
    n = kinds.shape[1]
    kb = TorchBackend(template, n, device, use_kernel=True)
    pb = TorchBackend(template, n, device, use_kernel=False)
    err = compare_states(kb.st, pb.st, where + " (start)")
    for start in range(0, kinds.shape[0], chunk):
        kc = kinds[start:start + chunk]
        kb.run_chunk(kc, start)
        pb.run_chunk(kc, start)
        ids_k, _ = kb.poll()
        ids_p, _ = pb.poll()
        if len(ids_k) or len(ids_p):
            raise AssertionError(f"{where}: unexpected bails")
        err = max(err, compare_states(kb.st, pb.st,
                                      f"{where} after op {start + len(kc)}"))
    return kb, err


def phase_matrix(device):
    import numpy as np
    from repro_torch.fleet import FleetConfig, build_fleet, run_fleet
    from repro_torch.fleet.runner import check_instances
    t0 = time.perf_counter()
    worst = 0
    for q in MATRIX_QUEUES:
        for m in MATRIX_MODELS:
            cfg = FleetConfig(queue=q, model=m, instances=MATRIX_INSTANCES,
                              ops=96, chunk=CHUNK, backend="numpy", seed=0)
            fleet = build_fleet(cfg)
            kb, err = lockstep(fleet.template, fleet.kinds, CHUNK, device,
                               f"{q}/{m}")
            worst = max(worst, err)
            ref = run_fleet(cfg, fleet=fleet)
            if not np.array_equal(kb.counts(), ref.counts):
                raise AssertionError(f"{q}/{m}: kernel counts != numpy")
            del kb
    log(f"phase 2 matrix: {len(MATRIX_QUEUES) * len(MATRIX_MODELS)} cells "
        f"x {MATRIX_INSTANCES} instances x 96 ops: kernel == plain after "
        f"every chunk, counts == numpy stepper "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    for q in ("MSQ", "DurableMSQ", "LinkedQ", "NVTraverseQ", "OptUnlinkedQ"):
        rng = np.random.default_rng(5)
        cell = dict(queue=q, model="cxl", instances=128, ops=60, chunk=20,
                    prefill=3, seed=2)
        kinds = (rng.random((60, 128)) < 0.65).astype(np.uint8)
        res = {b: run_fleet(FleetConfig(backend=b, device=device, **cell),
                            kinds=kinds) for b in ("cuda", "torch", "numpy")}
        if res["cuda"].bails == 0:
            raise AssertionError(f"bail cell {q}: no bails were forced")
        for b in ("torch", "numpy"):
            if not np.array_equal(res["cuda"].counts, res[b].counts) or \
                    res["cuda"].bails != res[b].bails:
                raise AssertionError(f"bail cell {q}: cuda != {b}")
        rows = check_instances(res["cuda"], sample=8)
        if not all(r["ok"] for r in rows):
            raise AssertionError(f"bail cell {q}: check_instances failed")
        log(f"phase 2 bail/rejoin {q}/cxl: bails={res['cuda'].bails} "
            f"residents={res['cuda'].residents} cuda == torch == numpy, "
            f"check_instances {len(rows)}/{len(rows)}")
    for q in ("UnlinkedQ", "OptLinkedQ"):
        cfg = FleetConfig(queue=q, model="optane-clwb",
                          instances=MATRIX_INSTANCES, ops=400, chunk=64,
                          backend="numpy", seed=7)
        fleet = build_fleet(cfg)
        kb, err = lockstep(fleet.template, fleet.kinds, 64, device,
                           f"reclaim {q}")
        worst = max(worst, err)
        ref = run_fleet(cfg, fleet=fleet)
        if not np.array_equal(kb.counts(), ref.counts):
            raise AssertionError(f"reclaim {q}: kernel counts != numpy")
        epochs = int(kb.st["epoch"].max()) - int(fleet.template.row["epoch"])
        if epochs < 3:
            raise AssertionError(f"reclaim {q}: only {epochs} epoch advances")
        log(f"phase 2 reclamation {q}: {MATRIX_INSTANCES} x 400 ops, "
            f"{epochs} epoch advances, kernel == plain after every chunk, "
            f"counts == numpy")
        del kb
    log(f"phase 2 bail and reclamation cells ({time.perf_counter() - t0:.1f}"
        f" s)")
    return worst


class PhaseTimer:
    """Host seconds per runner phase (the runner's duck-typed ``profile``
    hook), with a device synchronise at every boundary so a phase owns the
    device work it queued."""

    def __init__(self):
        self.seconds, self.stack = {}, []

    def push(self, name):
        import torch
        torch.cuda.synchronize()
        self.stack.append((name, time.perf_counter()))

    def pop(self):
        import torch
        torch.cuda.synchronize()
        name, t0 = self.stack.pop()
        self.seconds[name] = self.seconds.get(name, 0.0) + \
            time.perf_counter() - t0


def _sectors(byte_mask) -> int:
    """32-byte sectors of a flat byte mask that hold a set byte."""
    import torch
    pad = (-byte_mask.numel()) % 32
    m = torch.nn.functional.pad(byte_mask.to(torch.uint8), (0, pad))
    return int(m.view(-1, 32).any(dim=1).sum())


def reached_sectors(before: dict, after: dict, reach: dict):
    """-> (sectors the chunk reached, sectors it changed) over the line
    planes, rings, stacks and limbo.  ``reach`` is the plain version's
    record of every position the chunk read or wrote; a changed byte
    outside it raises."""
    import torch
    reached = changed = 0
    for key, r in reach.items():
        a, b = after[key], before[key]
        mask = r.unsqueeze(-1).expand(*r.shape, a.element_size()).reshape(-1)
        diff = a.view(torch.uint8).reshape(-1) != \
            b.view(torch.uint8).reshape(-1)
        if bool((diff & ~mask).any()):
            raise AssertionError(f"{key}: a changed byte was not reached")
        reached += _sectors(mask)
        changed += _sectors(diff)
    return reached, changed


def time_chunk(step, st, snapshot, kinds, progs, err, reps):
    """Mean ms of ``step`` on chunk 0 from the snapshot state, CUDA events
    around the step alone (the restore copy in between also evicts L2)."""
    import torch
    total = 0.0
    for r in range(reps + 1):
        for key, v in snapshot.items():
            st[key].copy_(v)
        err.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(st, kinds, 0, progs, err)
        b.record()
        torch.cuda.synchronize()
        if r:                           # the first run is the warm-up
            total += a.elapsed_time(b)
    if int(err.item()):
        raise AssertionError(f"error word {int(err.item())} while timing")
    return total / reps


def phase_main(device):
    import numpy as np
    import torch
    from repro_torch.fleet import (FleetConfig, build_fleet,
                                   check_instances, run_fleet)
    from repro_torch.fleet.torchexec import (_ARRAY_FIELDS, _SCALAR_FIELDS,
                                             TorchBackend)
    from repro_torch.kernels.fleet_step import fleet_step, fleet_step_plain

    chunks = -(-MAIN_OPS // CHUNK)
    cfgs = {q: FleetConfig(queue=q, model="optane-clwb",
                           instances=MAIN_INSTANCES, ops=MAIN_OPS,
                           chunk=CHUNK, backend="cuda", device=device, seed=0)
            for q in MAIN_QUEUES}
    fleets = {q: build_fleet(cfgs[q]) for q in MAIN_QUEUES}   # set-up
    results = {}
    fleet_step.launches = 0             # the main path's run starts here
    for q in MAIN_QUEUES:
        before = fleet_step.launches
        torch.cuda.reset_peak_memory_stats()
        res = run_fleet(cfgs[q], fleet=fleets[q])
        results[q] = dict(res=res, launches=fleet_step.launches - before,
                          peak=torch.cuda.max_memory_allocated())
    total_launches = fleet_step.launches    # ... and ends here

    worst = 0
    summary = {}
    for q in MAIN_QUEUES:
        res, launches = results[q]["res"], results[q]["launches"]
        if launches == 0 or launches != chunks:     # one batch
            raise AssertionError(f"{q}: {launches} kernel launches, expected "
                                 f"{chunks} (chunks x batches)")
        if res.counts.shape != (MAIN_INSTANCES, 12) or res.bails != 0:
            raise AssertionError(f"{q}: counts {res.counts.shape}, "
                                 f"bails {res.bails}")
        rows = check_instances(res, sample=8)
        ok = sum(r["ok"] for r in rows)
        if ok != 8:
            raise AssertionError(f"{q}: check_instances {ok}/8")
        agg = res.aggregate()
        phases = PhaseTimer()           # a second run, for the breakdown
        profiled = run_fleet(cfgs[q], fleet=fleets[q], profile=phases)
        if not np.array_equal(profiled.counts, res.counts):
            raise AssertionError(f"{q}: the profiled run's counts differ")
        prof_run_s = profiled.run_s
        del profiled

        kinds = torch.as_tensor(np.ascontiguousarray(res.kinds[:CHUNK]))
        kinds = kinds.to(device)
        kb = TorchBackend(res.template, MAIN_INSTANCES, device,
                          use_kernel=True)
        snapshot = {k: v.clone() for k, v in kb.st.items()}
        ms = time_chunk(fleet_step, kb.st, snapshot, kinds, kb.progs,
                        kb.err, KERNEL_REPS)
        pst = {k: v.clone() for k, v in snapshot.items()}
        plain_ms = time_chunk(fleet_step_plain, pst, snapshot, kinds,
                              kb.progs, kb.err, PLAIN_REPS)
        # the chunk's reach, recorded by the plain version from the same
        # state; its result is also held to the kernel's
        rst = {k: v.clone() for k, v in snapshot.items()}
        reach = {k: torch.zeros_like(rst[k], dtype=torch.bool)
                 for k in _ARRAY_FIELDS}
        fleet_step_plain(rst, kinds, 0, kb.progs, kb.err, reach=reach)
        worst = max(worst, compare_states(kb.st, rst, f"main {q} chunk 0"))
        reached, changed = reached_sectors(snapshot, kb.st, reach)
        per_instance = 2 * sum(kb.st[k].element_size()
                               for k in _SCALAR_FIELDS) + \
            2 * kb.st["counts"][0].nbytes + 2 * kb.st["slots"][0].nbytes + \
            CHUNK
        bound_bytes = MAIN_INSTANCES * per_instance + 32 * (reached + changed)
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        del pst, rst, reach, snapshot, kb
        torch.cuda.empty_cache()
        _, err = lockstep(res.template, res.kinds, CHUNK, device, f"main {q}")
        worst = max(worst, err)
        torch.cuda.empty_cache()
        log(f"phase 3 {q}: plain backend on the card gives the identical "
            f"state after every chunk at {MAIN_INSTANCES} instances")
        state_gb = results[q]["peak"] / 1e9
        log(f"phase 3 fleet/optane-clwb/off/{q}: "
            f"{MAIN_INSTANCES} instances x {MAIN_OPS} ops, "
            f"mops={res.ops_per_sec / 1e6:.3f} run_s={res.run_s:.4f} "
            f"launches={launches} kernel_ms_per_chunk={ms:.3f} "
            f"plain_ms_per_chunk={plain_ms:.1f} bound_ms={bound_ms:.4f} "
            f"(bytes={bound_bytes}: {per_instance} B x instances, "
            f"{reached} sectors reached, {changed} changed) "
            f"roofline_share={bound_ms / ms:.4f} "
            f"max_memory_allocated_gb={state_gb:.2f} "
            f"fences_per_op={agg.fences / res.total_ops:.3f} "
            f"post_flush_per_op={agg.post_flush_accesses / res.total_ops:.3f}"
            f" check_instances=8/8")
        log(f"phase 3 {q} profiled run: run_s={prof_run_s:.4f}, by phase "
            f"(host s, synchronised): " +
            " ".join(f"{k}={v:.4f}" for k, v in phases.seconds.items()) +
            f" outside={prof_run_s - sum(phases.seconds.values()):.4f}")
        log(f"fleet/optane-clwb/off/{q}/cuda_wall_us_per_op,"
            f"{res.run_s * 1e6 / res.total_ops:.4f}")
        summary[q] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          launches=launches)
    return summary, total_launches, worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc" / "fleet_step.cu").is_file():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels.fleet_step import build_library

    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = DEVICE
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    path, build_s, build_log = build_library()
    log(f"phase 1 build: {path.name} in {build_s:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    worst = phase_matrix(device)
    summary, launches, worst_main = phase_main(device)
    worst = max(worst, worst_main)
    ref = summary["OptLinkedQ"]
    kernels = [{
        "name": "fleet_step", "route": "cuda",
        "source": "src/repro_torch/csrc/fleet_step.cu",
        "replaces": "src/repro/kernels/fleet_step.py:35",
        "launches": launches, "max_abs_err": worst,
        "ms": ref["ms"], "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
