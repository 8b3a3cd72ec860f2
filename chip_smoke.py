#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc/``, holds
each against its plain PyTorch version on the card, drives the port's main
paths at full size (the fleet executor, ``repro_torch.fleet.run_fleet``;
yi-6b serving through ``ServeEngine`` and its prefill step; falcon-mamba-7b
prefill and serving), and checks their results against independent
references.  It
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
   side by side with the plain version at that size, and per queue:
   the kernel's and the plain version's time on chunk 0 (from the
   uniform start) and on chunk 1 (from the state chunk 0 leaves), each
   beside its byte bound (sectors counted in the reference's [N, X]
   layout) and the sectors the port's warp tiles touch; peak device
   memory; host seconds per runner phase from a second, profiled run;
   and the host side of the counts (device-to-host copy, widening to
   int64, merge) timed part by part;
4. K4, decode attention, vs its plain version: the JAX test shapes in
   fp32 and bf16, edge lengths 1 and S, a ragged S, lengths 1, 15, 17
   and 63 at G = 1, 3 and 16, yi-6b's decode shape (B=16, S=32768, bf16,
   random lengths) and both serving cells' shapes (S=2048, B=4 with
   lengths 1-11 and B=32); the HMMA instructions of the bf16 split
   kernel in the built library (none fails the phase); then the kernel,
   the plain version and one PyTorch SDPA call timed at B=128, S=32768
   beside the byte bound, with TFLOP/s and kernel_ms / sdpa_ms;
5. K2, flash attention, vs its plain version: the JAX test shapes,
   non-causal, ragged S, S = 1, 15, 17 and 65 causal and not, and yi-6b's
   prefill shape (B=1, S=4096, bf16); the HMMA instructions of the bf16
   kernel; then the three timed at that shape beside the FLOP bound,
   with TFLOP/s and kernel_ms / sdpa_ms;
6. serving main path: ``ServeEngine`` on yi-6b at full width (bf16, 32
   layers, random weights from seed 0, max_len 2048) through K4, twice:
   the JAX serve command's traffic (12 requests, batch 4, 4-token prompts,
   8 new tokens) checks the answers and the launch count; the chat cell
   (64 requests, batch 32, prompt lengths log-normal around 1,020 tokens,
   128 new tokens) fills the cache to 2,048 positions.  For each: decode
   tokens/s, ms per step, and at the last position ms per ``serve_step``
   beside its byte bound, device busy time with K4's part (profiler), the
   host's cost per K4 call, peak device memory;
7. prefill (``make_prefill_step``, B=1, S=4096, bf16) through K2, with its
   time; then yi-6b in fp32 from the same seed, kernels against plain
   versions for the whole model (prefill last-token logits, 16
   ``serve_step``s) and decode == forward at S=16;
8. K3, the selective scan, vs its plain version: the JAX test shapes in
   fp32 and bf16, ragged S, din and ds, S=1 and falcon-mamba-7b's
   prefill shape (B=1, S=4096, din 8192, ds 16, fp32 and bf16); then the
   kernel and the plain version timed at that shape with bf16 inputs
   (the main path's) and fp32 inputs, each beside the byte bound of the
   bytes that dtype hands it (the exps' time through the SFUs alone
   printed beside it, not a floor);
9. prefill main path of the mamba family: falcon-mamba-7b at full width
   (bf16, 64 layers, random weights from seed 0), B=1, S=4096, through
   ``make_prefill_step``, K3 launched once a layer, with its time beside
   the FLOP bound, device busy time and K3's part (profiler); then the
   prefill with the scan fed fp32 copies of its inputs, whose logits
   must be bit-identical, with its time;
10. serving main path of the mamba family: ``ServeEngine`` on the same
   model (decode runs no kernel), twice: the JAX serve command's traffic
   (12 requests, batch 4, 4-token prompts, 8 new tokens) checks the
   answers; the batch-32 cell (64 requests, batch 32, 4-token prompts,
   128 new tokens: a mamba step's cost does not grow with context).  For
   each: tokens/s, ms per step, and at the last step ``serve_step`` ms
   (CUDA events) beside its byte bound, host enqueue ms and device busy
   time; then
   ``python -m repro_torch.launch.serve --arch falcon-mamba-7b``;
11. falcon-mamba-7b in fp32 from the same seed: kernels against plain
   versions on prefill last-token logits, and decode == forward at S=16.

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
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak, same sheet
FP32_FLOPS = 67e12              # fp32 outside the tensor cores
DEVICE = "cuda"
MATRIX_QUEUES = ("MSQ", "DurableMSQ", "IzraelevitzQ", "NVTraverseQ",
                 "UnlinkedQ", "LinkedQ", "OptUnlinkedQ", "OptLinkedQ")
MATRIX_MODELS = ("optane-clwb", "eadr", "cxl")
MAIN_QUEUES = ("DurableMSQ", "OptUnlinkedQ", "OptLinkedQ")
MATRIX_INSTANCES = 4096
MAIN_INSTANCES, MAIN_OPS, CHUNK = 1_000_000, 96, 48
KERNEL_REPS, PLAIN_REPS = 10, 2
KERNELS = ("fleet_step", "decode_attention", "flash_attention", "ssm_scan")
# (rtol, atol) per dtype.  fp32 as tests/test_kernels.py.  bf16: its rtol,
# but an atol scaled to the outputs: a row over n keys averages to about
# 1.65/sqrt(n), 0.01-0.03 at thousands of keys, where an atol of 2e-2
# would pass a kernel that drops a tile.  Both sides compute in fp32 and
# differ by the final rounding to bf16, one ulp (2^-8 to 2^-7 relative).
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 1e-3)}
MODEL_TOL = 1e-3    # fp32 model, kernels vs plain: see phase_model_check
DECODE_CASES = [    # (B, S, H, KV, hd, dtype, lengths or None = random)
    (2, 1024, 8, 2, 64, "float32", None), (2, 1024, 8, 2, 64, "bfloat16",
                                           None),
    (4, 512, 4, 4, 64, "float32", None), (4, 512, 4, 4, 64, "bfloat16",
                                          None),
    (1, 2048, 8, 1, 128, "float32", None), (1, 2048, 8, 1, 128,
                                            "bfloat16", None),
    (2, 512, 4, 2, 64, "float32", [1, 512]),
    (2, 512, 4, 2, 64, "float32", [512, 1]),
    (2, 512, 4, 2, 64, "float32", [137, 255]),
    (3, 300, 8, 4, 32, "float32", None), (3, 300, 8, 4, 32, "bfloat16",
                                          None),
    (2, 700, 24, 8, 128, "bfloat16", None),       # 3 heads a group
    (2, 300, 96, 8, 128, "float32", None),        # 12 heads a group
    (3, 129, 16, 1, 16, "float32", None),         # 16 heads, head_dim 16
    (4, 64, 4, 1, 16, "bfloat16", None),          # reduced yi-6b decode
    (16, 32768, 32, 4, 128, "bfloat16", None),    # yi-6b decode
    # the smoke serve's shape: 32 splits of 64 keys, all but one empty
    (4, 2048, 32, 4, 128, "bfloat16", [1, 4, 8, 11]),
    (32, 2048, 32, 4, 128, "bfloat16", None),     # the chat serve's shape
] + [  # lengths at and around a warp's 16 keys and a step's 64; G = 1, 3, 16
    (4, 100, H, 2, 128, dtype, [1, 15, 17, 63])
    for H in (2, 6, 32) for dtype in ("float32", "bfloat16")
]
DECODE_TIMED = (128, 32768, 32, 4, 128)           # B, S, H, KV, hd; bf16
FLASH_CASES = [     # (B, S, H, KV, hd, dtype, causal)
    (2, 256, 4, 4, 64, "float32", True), (2, 256, 4, 4, 64, "bfloat16",
                                          True),
    (2, 512, 8, 2, 64, "float32", True), (2, 512, 8, 2, 64, "bfloat16",
                                          True),
    (1, 1024, 8, 1, 128, "float32", True), (1, 1024, 8, 1, 128,
                                            "bfloat16", True),
    (3, 384, 6, 2, 32, "float32", True), (3, 384, 6, 2, 32, "bfloat16",
                                          True),
    (2, 256, 4, 2, 64, "float32", False), (2, 256, 4, 2, 64, "bfloat16",
                                           False),
    (2, 200, 4, 2, 32, "float32", True), (1, 77, 8, 2, 64, "float32",
                                          False),
    (1, 1000, 32, 4, 128, "bfloat16", True),
    (1, 300, 24, 8, 128, "bfloat16", True),       # 3 heads a group
    (2, 100, 4, 1, 16, "float32", True), (2, 100, 4, 1, 16, "bfloat16",
                                          True),  # reduced yi-6b
    (1, 4096, 32, 4, 128, "bfloat16", True),      # yi-6b prefill
] + [  # S at and around the 16-row and 64-key tiles of the mma kernel
    (2, S, 8, 2, 128, dtype, causal) for S in (1, 15, 17, 65)
    for causal in (True, False) for dtype in ("float32", "bfloat16")
]
FLASH_TIMED = (1, 4096, 32, 4, 128)               # B, S, H, KV, hd; bf16
SERVE_ARCH, SERVE_MAX_LEN, SERVE_REQUESTS = "yi-6b", 2048, 12
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 4, 8   # the JAX serve driver's
# The chat serve: prompt lengths log-normal around the median prompt of
# the Azure LLM inference trace 2023, conversation (github.com/Azure/
# AzurePublicDataset, as summarised in Splitwise, arXiv:2311.18677: 1,020
# tokens; output median 129); the spread (sigma 0.7) is chosen.  Prompts
# are cut to what the 2,048-position cache holds with the answer.  The
# engine has one max_new a run, so every answer is 128 tokens.
CHAT_REQUESTS, CHAT_BATCH, CHAT_NEW = 64, 32, 128
CHAT_PROMPT_MEDIAN, CHAT_PROMPT_SIGMA, CHAT_SEED = 1020, 0.7, 1
PREFILL_LEN, MODEL_STEPS, DECODE_FWD_LEN = 4096, 16, 16
SSM_CASES = [       # (B, S, din, ds, dtype)
    (2, 128, 64, 16, "float32"), (2, 128, 64, 16, "bfloat16"),
    (1, 256, 128, 16, "float32"), (1, 256, 128, 16, "bfloat16"),
    (3, 64, 96, 8, "float32"), (3, 64, 96, 8, "bfloat16"),
    (1, 300, 96, 8, "float32"), (1, 300, 96, 8, "bfloat16"),  # ragged S
    (2, 300, 100, 5, "float32"),                  # ragged S, din and ds
    (2, 70, 40, 3, "bfloat16"),                   # ds 3 in lanes of 2
    (2, 1, 64, 16, "float32"), (1, 1, 8192, 16, "bfloat16"),   # S=1
    (2, 77, 8192, 16, "float32"),                 # B=2 at full width
    (1, 256, 8192, 16, "float32"),                # phase 11's shape
    (1, 4096, 8192, 16, "float32"),               # falcon-mamba-7b prefill
    (1, 4096, 8192, 16, "bfloat16"),              # ... in its bf16 feed
]
SSM_TIMED = (1, 4096, 8192, 16)                   # B, S, din, ds
SSM_TIMED_DTYPES = ("bfloat16", "float32")        # the main path's first
# fp32 rtol = atol as tests/test_kernels.py, for bf16 inputs too: both
# sides upcast the same bf16 values and compute in fp32
SSM_TOL = 1e-4
# exp2 per clock per SM through Hopper's SFUs; not a floor, since a
# kernel may also take exps as polynomials on the FMA pipe
SFU_EXP_PER_CLOCK = 16
MAMBA_ARCH, MAMBA_CHECK_LEN = "falcon-mamba-7b", 256


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


def reached_sectors(before: dict, after: dict, reach: dict,
                    reference_layout: bool):
    """-> (sectors the chunk reached, sectors it changed) over the line
    planes, rings, stacks and limbo.  ``reach`` is the plain version's
    record of every position the chunk read or wrote; a changed byte
    outside it raises.  The port's state is in warp tiles; with
    ``reference_layout`` the sectors are counted in the reference's
    ``[N, X]`` layout instead (the byte bound's yardstick), else as the
    port's layout lays them out."""
    import torch
    from repro_torch.fleet.torchexec import from_tiles
    n = before["head"].shape[0]
    reached = changed = 0
    for key, r in reach.items():
        a, b = after[key], before[key]
        if reference_layout:
            r, a, b = (from_tiles(t, n) for t in (r, a, b))
        mask = r.unsqueeze(-1).expand(*r.shape, a.element_size()).reshape(-1)
        diff = a.view(torch.uint8).reshape(-1) != \
            b.view(torch.uint8).reshape(-1)
        if bool((diff & ~mask).any()):
            raise AssertionError(f"{key}: a changed byte was not reached")
        reached += _sectors(mask)
        changed += _sectors(diff)
        del r, a, b, mask, diff
    return reached, changed


def time_chunk(step, st, snapshot, kinds, start, progs, err, reps):
    """Mean ms of ``step`` on the chunk at ``start`` from the snapshot
    state, CUDA events around the step alone (the restore copy in between
    also evicts L2).  ``st`` is left as the chunk leaves it."""
    import torch
    total = 0.0
    for r in range(reps + 1):
        for key, v in snapshot.items():
            st[key].copy_(v)
        err.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(st, kinds, start, progs, err)
        b.record()
        torch.cuda.synchronize()
        if r:                           # the first run is the warm-up
            total += a.elapsed_time(b)
    if int(err.item()):
        raise AssertionError(f"error word {int(err.item())} while timing")
    return total / reps


def host_counts_seconds(backend, instances: int) -> dict:
    """``TorchBackend.counts`` and the runner's merge, part by part: the
    int32 counts taken out of their warp tiles on the device and copied to
    the host, widened to int64 there, and copied into a fresh result
    array."""
    import numpy as np
    import torch
    from repro_torch.fleet.torchexec import from_tiles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = from_tiles(backend.st["counts"], backend.n).cpu()
    t1 = time.perf_counter()
    wide = host.numpy().astype(np.int64)
    t2 = time.perf_counter()
    result = np.zeros((instances, wide.shape[1]), dtype=np.int64)
    result[:] = wide
    t3 = time.perf_counter()
    return {"d2h": t1 - t0, "widen": t2 - t1, "merge": t3 - t2,
            "d2h_bytes": host.numel() * host.element_size()}


def chunk_numbers(kb, kinds, start, snapshot):
    """K1 and the plain version on one chunk from ``snapshot``: their ms,
    the chunk's byte bound (sectors counted in the reference's layout)
    and the sectors the port's layout touches -> dict.  ``kb.st`` is left
    as the kernel leaves the chunk, and is held to the plain version's
    result."""
    import torch
    from repro_torch.fleet.torchexec import _ARRAY_FIELDS, _SCALAR_FIELDS
    from repro_torch.kernels.fleet_step import fleet_step, fleet_step_plain
    n = kb.n
    pst = {k: v.clone() for k, v in snapshot.items()}
    plain_ms = time_chunk(fleet_step_plain, pst, snapshot, kinds, start,
                          kb.progs, kb.err, PLAIN_REPS)
    del pst
    ms = time_chunk(fleet_step, kb.st, snapshot, kinds, start, kb.progs,
                    kb.err, KERNEL_REPS)
    # the chunk's reach, recorded by the plain version from the same
    # state; its result is also held to the kernel's
    rst = {k: v.clone() for k, v in snapshot.items()}
    reach = {k: torch.zeros_like(rst[k], dtype=torch.bool)
             for k in _ARRAY_FIELDS}
    fleet_step_plain(rst, kinds, start, kb.progs, kb.err, reach=reach)
    err = compare_states(kb.st, rst, f"chunk at op {start}")
    del rst
    reached, changed = reached_sectors(snapshot, kb.st, reach, True)
    own = reached_sectors(snapshot, kb.st, reach, False)
    del reach
    torch.cuda.empty_cache()
    # scalars, counts and slots read and written once, kinds read once:
    # the same bytes an instance in either layout
    per_instance = 2 * sum(kb.st[k].element_size() for k in _SCALAR_FIELDS) \
        + 2 * kb.st["counts"].shape[1] * kb.st["counts"].element_size() \
        + 2 * kb.st["slots"].shape[1] * kb.st["slots"].element_size() \
        + kinds.shape[0]
    bound_bytes = n * per_instance + 32 * (reached + changed)
    return dict(ms=ms, plain_ms=plain_ms, err=err,
                bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3,
                bound_bytes=bound_bytes, per_instance=per_instance,
                reached=reached, changed=changed, own_reached=own[0],
                own_changed=own[1])


def phase_main(device):
    import numpy as np
    import torch
    from repro_torch.fleet import (FleetConfig, build_fleet,
                                   check_instances, run_fleet)
    from repro_torch.fleet.torchexec import TorchBackend
    from repro_torch.kernels.fleet_step import fleet_step

    chunks = -(-MAIN_OPS // CHUNK)
    cfgs = {q: FleetConfig(queue=q, model="optane-clwb",
                           instances=MAIN_INSTANCES, ops=MAIN_OPS,
                           chunk=CHUNK, backend="cuda", device=device, seed=0)
            for q in MAIN_QUEUES}
    fleets = {q: build_fleet(cfgs[q]) for q in MAIN_QUEUES}   # set-up
    results = {}
    reset_counts()                      # the main path's run starts here
    for q in MAIN_QUEUES:
        before = fleet_step.launches
        torch.cuda.reset_peak_memory_stats()
        res = run_fleet(cfgs[q], fleet=fleets[q])
        results[q] = dict(res=res, launches=fleet_step.launches - before,
                          peak=torch.cuda.max_memory_allocated())
    counts = read_counts()              # ... and ends here
    total_launches = counts["fleet_step"]
    expect_launches(counts, {"fleet_step": len(MAIN_QUEUES) * chunks},
                    "fleet main path")

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

        # chunk 0 from the uniform start, chunk 1 from the state chunk 0
        # leaves (the instances have diverged; the epoch advance runs)
        kb = TorchBackend(res.template, MAIN_INSTANCES, device,
                          use_kernel=True)
        host = host_counts_seconds(kb, MAIN_INSTANCES)
        by_chunk = []
        for c in range(2):
            kinds = torch.as_tensor(np.ascontiguousarray(
                res.kinds[c * CHUNK:(c + 1) * CHUNK])).to(device)
            snapshot = {k: v.clone() for k, v in kb.st.items()}
            by_chunk.append(chunk_numbers(kb, kinds, c * CHUNK, snapshot))
            del snapshot, kinds
        del kb
        torch.cuda.empty_cache()
        _, err = lockstep(res.template, res.kinds, CHUNK, device, f"main {q}")
        worst = max([worst, err] + [c["err"] for c in by_chunk])
        torch.cuda.empty_cache()
        log(f"phase 3 {q}: plain backend on the card gives the identical "
            f"state after every chunk at {MAIN_INSTANCES} instances")
        state_gb = results[q]["peak"] / 1e9
        slow = max(by_chunk, key=lambda c: c["ms"])
        log(f"phase 3 fleet/optane-clwb/off/{q}: "
            f"{MAIN_INSTANCES} instances x {MAIN_OPS} ops, "
            f"mops={res.ops_per_sec / 1e6:.3f} run_s={res.run_s:.4f} "
            f"launches={launches} kernel_ms_per_chunk={slow['ms']:.4f} "
            f"(the slower of chunks 0 and 1) "
            f"max_memory_allocated_gb={state_gb:.2f} "
            f"fences_per_op={agg.fences / res.total_ops:.3f} "
            f"post_flush_per_op={agg.post_flush_accesses / res.total_ops:.3f}"
            f" check_instances=8/8")
        for c, num in enumerate(by_chunk):
            log(f"phase 3 {q} chunk {c} (ops {c * CHUNK}-"
                f"{(c + 1) * CHUNK - 1}): kernel_ms={num['ms']:.4f} "
                f"plain_ms={num['plain_ms']:.1f} bound_ms="
                f"{num['bound_ms']:.4f} (bytes={num['bound_bytes']}: "
                f"{num['per_instance']} B x instances, {num['reached']} "
                f"sectors reached, {num['changed']} changed, counted in the "
                f"reference's [N, X] layout) roofline_share="
                f"{num['bound_ms'] / num['ms']:.4f}; the port's warp "
                f"tiles: {num['own_reached']} sectors reached, "
                f"{num['own_changed']} changed (context, not the bound)")
        log(f"phase 3 {q} profiled run: run_s={prof_run_s:.4f}, by phase "
            f"(host s, synchronised): " +
            " ".join(f"{k}={v:.4f}" for k, v in phases.seconds.items()) +
            f" outside={prof_run_s - sum(phases.seconds.values()):.4f}")
        log(f"phase 3 {q} host counts, each part alone (s): "
            f"untile_and_d2h={host['d2h']:.4f} ({host['d2h_bytes']} B "
            f"of int32) "
            f"widen_to_int64={host['widen']:.4f} merge={host['merge']:.4f}")
        log(f"fleet/optane-clwb/off/{q}/cuda_wall_us_per_op,"
            f"{res.run_s * 1e6 / res.total_ops:.4f}")
        summary[q] = dict(ms=slow["ms"], plain_ms=slow["plain_ms"],
                          bound_ms=slow["bound_ms"], launches=launches,
                          chunks=by_chunk, run_s=res.run_s)
    return summary, total_launches, worst


# ---------------------------------------------------------------------------
# phases 4-7: the serving slice (K4, K2, yi-6b serve and prefill)
# ---------------------------------------------------------------------------

def kernel_fns():
    """{name: wrapper} of every kernel whose launches are counted."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fleet_step import fleet_step
    from repro_torch.kernels.ssm_scan import ssm_scan
    return {"fleet_step": fleet_step, "decode_attention": decode_attention,
            "flash_attention": flash_attention, "ssm_scan": ssm_scan}


def reset_counts():
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


def expect_launches(counts: dict, expected: dict, where: str) -> None:
    """Raise unless each kernel was launched as often as ``expected`` says
    (0 for a kernel it does not name)."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts}, expected {want}")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up, CUDA
    events around the run."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(fn, reps: int):
    """Run ``fn()`` ``reps`` times under torch.profiler -> (device kernel
    ms per call, {kernel name: ms per call}).  Only events that ran on the
    card count; the profiler slows the host, not the kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    by_kernel = {e.key: e.self_device_time_total / 1e3 / reps
                 for e in kernels}
    return sum(by_kernel.values()), by_kernel


def kernel_device_ms(by_kernel: dict, *names: str) -> float:
    """Device ms of the profiled kernels whose names hold one of ``names``;
    raises if there is none (the profile then did not see the kernel)."""
    ms = [v for k, v in by_kernel.items() if any(n in k for n in names)]
    if not ms:
        raise AssertionError(f"the device profile shows no {names}")
    return sum(ms)


def _top(by_kernel: dict) -> str:
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:5]
    return "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top)


def hold(out, ref, rtol: float, atol: float, where: str) -> float:
    """Raise unless ``out`` is finite and |out - ref| <= atol + rtol |ref|
    everywhere -> the largest absolute difference."""
    import torch
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{where}: shape {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)}, or not finite")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"{where}: {int(bad.sum())} entries outside "
                             f"rtol={rtol} atol={atol}, max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def _randn(gen, shape, dtype, device):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(
        getattr(torch, dtype))


def tensor_core_check(lib: str, kernel: str, phase: int) -> int:
    """The HMMA (tensor-core) instructions of each instantiation of the
    bf16 ``kernel`` in the built ``lib``, from ``cuobjdump -sass``; raises
    when there is none -> their sum."""
    from repro_torch.kernels.build import sass_opcode_counts
    counts = {fn: n for fn, n in sass_opcode_counts(lib, "HMMA").items()
              if kernel in fn}
    log(f"phase {phase} {lib}: HMMA instructions of {kernel} "
        f"(cuobjdump -sass, {len(counts)} instantiations): " +
        ", ".join(f"{fn} {n}" for fn, n in sorted(counts.items())))
    if not counts or min(counts.values()) == 0:
        raise AssertionError(f"{lib}: {kernel} has no HMMA instruction "
                             f"{counts}")
    return sum(counts.values())


def phase_decode(device):
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    gen = torch.Generator(device=device).manual_seed(4)
    worst = 0.0
    for B, S, H, KV, hd, dtype, lens in DECODE_CASES:
        q = _randn(gen, (B, H, hd), dtype, device)
        k = _randn(gen, (B, S, KV, hd), dtype, device)
        v = _randn(gen, (B, S, KV, hd), dtype, device)
        lengths = (torch.tensor(lens, device=device) if lens else
                   torch.randint(1, S + 1, (B,), generator=gen,
                                 device=device)).to(torch.int32)
        out = decode_attention(q, k, v, lengths)
        ref = decode_attention_plain(q, k, v, lengths)
        err = hold(out, ref, *ATTN_TOL[dtype],
                   f"decode B={B} S={S} H={H} KV={KV} hd={hd} {dtype}")
        worst = max(worst, err)
        log(f"phase 4 decode_attention B={B} S={S} H={H} KV={KV} hd={hd} "
            f"{dtype} lengths={lens or 'random'}: max_abs_err={err:.3e} "
            f"(rtol, atol {ATTN_TOL[dtype]})")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    tensor_core_check("decode_attention", "decode_split_mma_kernel", 4)

    B, S, H, KV, hd = DECODE_TIMED
    q = _randn(gen, (B, H, hd), "bfloat16", device)
    k = _randn(gen, (B, S, KV, hd), "bfloat16", device)
    v = _randn(gen, (B, S, KV, hd), "bfloat16", device)
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    ms = cuda_ms(lambda: decode_attention(q, k, v, lengths), KERNEL_REPS)
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, lengths),
                       PLAIN_REPS)
    # the library yardstick: one SDPA call, the G query heads of a group
    # as G query rows of its kv head, the length mask broadcast over them
    G = H // KV
    mask = (torch.arange(S, device=device)[None, :] <
            lengths[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q.view(B, KV, G, hd),
                                      k.transpose(1, 2), v.transpose(1, 2),
                                      attn_mask=mask), KERNEL_REPS)
    elem = q.element_size()
    valid = int(lengths.sum())
    nbytes = 2 * valid * KV * hd * elem + 2 * q.numel() * elem \
        + lengths.numel() * 4
    flops = 4 * valid * H * hd
    bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
    log(f"phase 4 decode_attention timed B={B} S={S} H={H} KV={KV} hd={hd} "
        f"bf16 full lengths: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"sdpa_ms={library_ms:.4f} kernel_over_sdpa={ms / library_ms:.3f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}: {nbytes} B, {flops} flop) "
        f"roofline_share={bound_ms / ms:.4f} "
        f"tb_per_s={nbytes / ms / 1e9:.3f} tflops={flops / ms / 1e9:.2f}")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def _bound(nbytes: int, flops: int, peak: float):
    """-> (least ms: the larger of bytes over HBM rate and flops over the
    peak, which of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash(device):
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=device).manual_seed(5)
    worst = 0.0
    for B, S, H, KV, hd, dtype, causal in FLASH_CASES:
        q = _randn(gen, (B, S, H, hd), dtype, device)
        k = _randn(gen, (B, S, KV, hd), dtype, device)
        v = _randn(gen, (B, S, KV, hd), dtype, device)
        out = flash_attention(q, k, v, causal=causal)
        ref = flash_attention_plain(q, k, v, causal=causal)
        err = hold(out, ref, *ATTN_TOL[dtype],
                   f"flash B={B} S={S} H={H} KV={KV} hd={hd} {dtype} "
                   f"causal={causal}")
        worst = max(worst, err)
        log(f"phase 5 flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
            f"{dtype} causal={causal}: max_abs_err={err:.3e} "
            f"(rtol, atol {ATTN_TOL[dtype]})")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    tensor_core_check("flash_attention", "flash_fwd_mma_kernel", 5)

    B, S, H, KV, hd = FLASH_TIMED
    q = _randn(gen, (B, S, H, hd), "bfloat16", device)
    k = _randn(gen, (B, S, KV, hd), "bfloat16", device)
    v = _randn(gen, (B, S, KV, hd), "bfloat16", device)
    ms = cuda_ms(lambda: flash_attention(q, k, v), KERNEL_REPS)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), PLAIN_REPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), is_causal=True,
                                      enable_gqa=True), KERNEL_REPS)
    elem = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * elem
    flops = 4 * B * H * hd * S * (S + 1) // 2
    bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
    log(f"phase 5 flash_attention timed B={B} S={S} H={H} KV={KV} hd={hd} "
        f"bf16 causal: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"sdpa_ms={library_ms:.4f} kernel_over_sdpa={ms / library_ms:.3f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}: {flops} flop, {nbytes} B) "
        f"roofline_share={bound_ms / ms:.4f} tflops={flops / ms / 1e9:.2f} "
        f"sdpa_tflops={flops / library_ms / 1e9:.2f} (bf16 tensor-core "
        f"peak {BF16_FLOPS / 1e12:.0f})")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def serving_config():
    from repro_torch.configs import get_config
    return get_config(SERVE_ARCH)


def command_requests(cfg):
    """The JAX serve command's traffic: SERVE_REQUESTS prompts of
    SERVE_PROMPT tokens from RandomState(0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [{"id": f"r{i}", "prompt": rng.randint(
        0, cfg.vocab, (SERVE_PROMPT,)).tolist()}
        for i in range(SERVE_REQUESTS)]


def serve_traffic(cfg):
    """-> {cell: (requests, batch, max_new)}.  "smoke" is the JAX serve
    command's traffic: it checks the answers and the launch count.  "chat"
    is the serving cell (CHAT_*)."""
    import numpy as np
    smoke = command_requests(cfg)
    rng = np.random.default_rng(CHAT_SEED)
    lens = np.clip(np.rint(rng.lognormal(np.log(CHAT_PROMPT_MEDIAN),
                                         CHAT_PROMPT_SIGMA, CHAT_REQUESTS)),
                   1, SERVE_MAX_LEN - CHAT_NEW + 1).astype(int)
    chat = [{"id": f"c{i}", "prompt": rng.integers(
        0, cfg.vocab, (n,)).tolist()} for i, n in enumerate(lens)]
    return {"smoke": (smoke, SERVE_BATCH, SERVE_NEW),
            "chat": (chat, CHAT_BATCH, CHAT_NEW)}


def drive_engine(cfg, params, reqs, batch, max_new, device,
                 per_step: dict):
    """The serving main path: ``ServeEngine.run`` over ``reqs`` from a
    fresh durable queue, answers checked, launches counted over the run
    alone and held to ``per_step`` ({kernel: launches a step}) -> (engine,
    numbers)."""
    import tempfile

    import torch
    from repro_torch.serving import DurableRequestQueue, ServeEngine
    with tempfile.TemporaryDirectory() as tmp:
        q = DurableRequestQueue(tmp)
        q.submit(reqs)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, q, params=params, seed=0,
                          max_len=SERVE_MAX_LEN, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                  # the main path's run starts here
        t0 = time.perf_counter()
        n = eng.run(batch_size=batch, max_new=max_new)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()          # ... and ends here
        resps = q.responses()
        q.close()
    ids = sorted(r["id"] for r in resps)
    if n != len(reqs) or ids != sorted(r["id"] for r in reqs):
        raise AssertionError(f"serve: {n} served, responses {ids}")
    for r in resps:
        if len(r["tokens"]) != max_new or not all(
                0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"serve: bad response {r}")
    # a batch runs its longest prompt (the others are padded to it) and
    # max_new - 1 more steps
    batches = [reqs[i:i + batch] for i in range(0, len(reqs), batch)]
    longest = [max(len(r["prompt"]) for r in b) for b in batches]
    steps = sum(p + max_new - 1 for p in longest)
    if eng.steps != steps:
        raise AssertionError(f"serve: {eng.steps} steps, expected {steps}")
    expect_launches(counts, {k: n * steps for k, n in per_step.items()},
                    f"serve {cfg.name}")
    rows = sum(len(b) * (p + max_new - 1) for b, p in zip(batches, longest))
    padded = sum(len(b) * p for b, p in zip(batches, longest))
    prompt_tokens = sum(len(r["prompt"]) for r in reqs)
    return eng, dict(
        n=n, steps=steps, launches=counts, init_s=init_s,
        run_s=run_s, decode_tokens_per_s=rows / run_s,
        generated_tokens_per_s=len(reqs) * max_new / run_s,
        ms_per_step=run_s / steps * 1e3, pad_share=1 - prompt_tokens / padded,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def step_bytes(cfg, params, B: int, pos_t: int) -> int:
    """The least bytes a ``serve_step`` at batch B and position pos_t
    moves: every weight once (the embedding only for its B rows), each
    attention layer's valid K/V, each mamba layer's state read and
    written (``h`` in fp32, the conv window in the compute dtype)."""
    from repro_torch.models import layer_specs
    mixers = [mixer for mixer, _ in layer_specs(cfg)]
    elem = params["embed"].element_size()
    kv = B * (pos_t + 1) * 2 * cfg.n_kv_heads * cfg.head_dim * elem
    state = 2 * B * cfg.d_inner * (cfg.ssm_state * 4 +
                                   (cfg.ssm_conv - 1) * elem)
    return _nbytes(params) - _nbytes(params["embed"]) + \
        B * cfg.d_model * elem + mixers.count("attn") * kv + \
        mixers.count("mamba") * state


def step_numbers(cfg, params, B: int, pos_t: int, device) -> dict:
    """One ``serve_step`` at batch B with every row at position pos_t (a
    zero cache: the work does not depend on its values): ms (CUDA events),
    the host's time to enqueue it, device kernel time (profiler), the byte
    bound and, for a model with attention, K4's device time and its host
    cost per wrapper call."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import init_cache, serve_step
    cache = init_cache(cfg, B, SERVE_MAX_LEN, device)
    tok = torch.zeros((B, 1), dtype=torch.long, device=device)
    pos = torch.full((B,), pos_t, dtype=torch.int32, device=device)

    def step():
        serve_step(cfg, params, cache, {"tokens": tok}, pos)

    out = {}
    attention = "k" in cache[0]
    with torch.inference_mode():
        step_ms = cuda_ms(step, 10)
        # enqueueing steps without waiting for them; near step_ms means the
        # host, not the card, sets the pace
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        enqueue_ms = (time.perf_counter() - t0) * 100
        torch.cuda.synchronize()
        busy_ms, by_kernel = device_profile(step, 5)
        if attention:
            out["k4_ms"] = kernel_device_ms(by_kernel,
                                            "decode_split_mma_kernel",
                                            "decode_merge_kernel")
            # the wrapper's host cost per call, enqueued without waiting
            q1 = torch.zeros((B, cfg.n_heads, cfg.head_dim),
                             dtype=cache[0]["k"].dtype, device=device)
            lengths = pos + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                decode_attention(q1, cache[0]["k"], cache[0]["v"], lengths)
            out["k4_host_us"] = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
    nbytes = step_bytes(cfg, params, B, pos_t)
    del cache
    torch.cuda.empty_cache()
    return dict(out, step_ms=step_ms, enqueue_ms=enqueue_ms,
                busy_ms=busy_ms, by_kernel=by_kernel,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, nbytes=nbytes)


def _serve_line(r: dict, s: dict) -> str:
    line = (f"steps={r['steps']} launches={r['launches']} "
            f"init_s={r['init_s']:.3f} run_s={r['run_s']:.4f} "
            f"decode_tokens_per_s={r['decode_tokens_per_s']:.1f} (rows x "
            f"steps / run_s) generated_tokens_per_s="
            f"{r['generated_tokens_per_s']:.2f} ms_per_step="
            f"{r['ms_per_step']:.4f} pad_share={r['pad_share']:.3f} "
            f"peak_device_gb={r['peak_gb']:.2f}; at the last position: "
            f"serve_step_ms={s['step_ms']:.4f} step_bound_ms="
            f"{s['bound_ms']:.4f} (bytes={s['nbytes']}) roofline_share="
            f"{s['bound_ms'] / s['step_ms']:.4f} host_enqueue_ms="
            f"{s['enqueue_ms']:.4f} device_busy_ms_per_step="
            f"{s['busy_ms']:.4f} idle_share="
            f"{1 - s['busy_ms'] / s['step_ms']:.3f}")
    if "k4_ms" in s:
        line += (f" k4_device_ms_per_step={s['k4_ms']:.4f} k4_share_of_busy="
                 f"{s['k4_ms'] / s['busy_ms']:.3f} k4_host_us_per_call="
                 f"{s['k4_host_us']:.1f}")
    return line


def phase_serve(device):
    """The serving main path at full width, twice: the JAX serve driver's
    traffic (answers and launches), then the chat cell -> (params, the
    chat run's numbers)."""
    import tempfile

    import numpy as np
    from repro_torch.serving import DurableRequestQueue
    cfg = serving_config()
    params, runs = None, {}
    for cell, (reqs, batch, max_new) in serve_traffic(cfg).items():
        eng, r = drive_engine(cfg, params, reqs, batch, max_new, device,
                              {"decode_attention": cfg.n_layers})
        params = eng.params
        del eng
        longest = max(len(q["prompt"]) for q in reqs)
        s = step_numbers(cfg, params, min(batch, len(reqs)),
                         longest + max_new - 2, device)
        runs[cell] = r
        lens = np.array([len(q["prompt"]) for q in reqs])
        what = ("the JAX serve driver's traffic, 4-token prompts: the "
                "answer and launch-count smoke" if cell == "smoke" else
                f"prompt lengths log-normal, median {CHAT_PROMPT_MEDIAN}, "
                f"sigma {CHAT_PROMPT_SIGMA}, seed {CHAT_SEED}, cut to "
                f"{SERVE_MAX_LEN - max_new + 1}: drawn min/median/max "
                f"{lens.min()}/{int(np.median(lens))}/{lens.max()}")
        log(f"phase 6 serve {cell} {cfg.name} full width ({cfg.n_layers} "
            f"layers, d_model {cfg.d_model}, {cfg.n_params()} params, bf16, "
            f"max_len {SERVE_MAX_LEN}; {what}): {r['n']}/{len(reqs)} "
            f"requests answered, batch {batch}, {max_new} tokens each, "
            + _serve_line(r, s))
        log(f"phase 6 serve {cell}: serve_step device time by kernel at the "
            f"last position (profiler, ms per step): {_top(s['by_kernel'])}")
    # the serve command itself (reduced config) on the card
    from repro_torch.launch import serve
    with tempfile.TemporaryDirectory() as tmp:
        serve.main(["--dir", tmp])
        served = DurableRequestQueue(tmp)
        answered = len(served.responses())
        served.close()
    if answered != SERVE_REQUESTS:
        raise AssertionError(f"serve command: {answered} responses")
    log(f"phase 6 python -m repro_torch.launch.serve (reduced {cfg.name}, "
        f"cuda): {answered} responses durable")
    return params, runs["chat"]


def phase_prefill(device, params):
    import torch
    from repro_torch.launch.steps import make_prefill_step
    cfg = serving_config()
    gen = torch.Generator(device=device).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_LEN), generator=gen,
                           device=device)
    prefill = make_prefill_step(cfg)
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()                  # the prefill path starts here
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()          # ... and ends here
        expect_launches(counts, {"flash_attention": cfg.n_layers},
                        f"prefill {cfg.name}")
        if logits.shape != (1, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill: logits {tuple(logits.shape)}")
        ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), 3)
        busy_ms, by_kernel = device_profile(
            lambda: prefill(params, {"tokens": tokens}), 1)
        k2_ms = kernel_device_ms(by_kernel, "flash_fwd_mma_kernel")
    flops = 2 * PREFILL_LEN * (cfg.n_params() - cfg.vocab * cfg.d_model) \
        + cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim * \
        PREFILL_LEN * (PREFILL_LEN + 1) // 2
    bound_ms = flops / BF16_FLOPS * 1e3
    log(f"phase 7 prefill {cfg.name} full width B=1 S={PREFILL_LEN} bf16: "
        f"K2 launches={counts['flash_attention']} first_call_s={first_s:.3f}"
        f" prefill_ms={ms:.3f} flop_bound_ms={bound_ms:.3f} "
        f"(flops={flops}) roofline_share={bound_ms / ms:.4f} "
        f"prefill_tokens_per_s={PREFILL_LEN / ms * 1e3:.1f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / ms:.3f} "
        f"k2_device_ms={k2_ms:.3f} k2_share_of_busy={k2_ms / busy_ms:.3f}")
    log(f"phase 7 prefill device time by kernel (profiler, ms): "
        f"{_top(by_kernel)}")
    return dict(launches=counts["flash_attention"], ms=ms)


def phase_model_check(device, cfg, prefill_len: int, serve_steps: int,
                      phase: int) -> dict:
    """``cfg`` in fp32 from seed 0: kernels against plain versions for the
    whole model (prefill last-token logits at ``prefill_len``, and
    ``serve_steps`` decode steps when decode runs a kernel), and decode ==
    forward.  Both sides run the same fp32 matmuls (TF32 off); they differ
    only in the order the kernels' sums are taken (attention's, or the
    scan's sum over states), carried through every layer: MODEL_TOL (1e-3,
    absolute and relative) on logits of magnitude ~1."""
    import dataclasses

    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import forward, init_cache, init_params, \
        serve_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(8)
    errs = {}
    with torch.inference_mode():
        tokens = torch.randint(0, cfg.vocab, (1, prefill_len), generator=gen,
                               device=device)
        kern = make_prefill_step(cfg, True)(params, {"tokens": tokens})
        plain = make_prefill_step(cfg, False)(params, {"tokens": tokens})
        errs["prefill"] = hold(kern, plain, MODEL_TOL, MODEL_TOL,
                                 f"fp32 {cfg.name} prefill logits")
        scale = float(plain.abs().max())
        del kern, plain
        B = SERVE_BATCH
        toks = torch.randint(0, cfg.vocab, (B, MODEL_STEPS), generator=gen,
                             device=device)
        if serve_steps:
            ck = init_cache(cfg, B, 64, device)
            cp = init_cache(cfg, B, 64, device)
            err = 0.0
            for t in range(serve_steps):
                pos = torch.full((B,), t, dtype=torch.int32, device=device)
                batch = {"tokens": toks[:, t:t + 1]}
                lk, ck = serve_step(cfg, params, ck, batch, pos, True)
                lp, cp = serve_step(cfg, params, cp, batch, pos, False)
                err = max(err, hold(lk, lp, MODEL_TOL, MODEL_TOL,
                                      f"fp32 {cfg.name} serve_step {t}"))
            errs["serve_steps"] = err
            del ck, cp
        B = 2
        toks = toks[:B, :DECODE_FWD_LEN]
        full = forward(cfg, params, {"tokens": toks})
        cache = init_cache(cfg, B, DECODE_FWD_LEN, device)
        outs = []
        for t in range(DECODE_FWD_LEN):
            lg, cache = serve_step(cfg, params, cache,
                                   {"tokens": toks[:, t:t + 1]},
                                   torch.full((B,), t, dtype=torch.int32,
                                              device=device))
            outs.append(lg)
        errs["decode_vs_forward"] = hold(torch.stack(outs, dim=1), full,
                                         MODEL_TOL, MODEL_TOL,
                                         f"fp32 {cfg.name} decode vs forward")
    del params
    torch.cuda.empty_cache()
    steps = (f"{serve_steps} serve_steps B={SERVE_BATCH} kernels vs plain "
             f"max_abs_err={errs['serve_steps']:.3e}; " if serve_steps else
             "")
    log(f"phase {phase} model check {cfg.name} full width fp32 (tol "
        f"rtol=atol={MODEL_TOL}; prefill logits up to {scale:.3f} in "
        f"magnitude): prefill S={prefill_len} last-token logits "
        f"kernels vs plain max_abs_err={errs['prefill']:.3e}; {steps}"
        f"decode == forward at S={DECODE_FWD_LEN} max_abs_err="
        f"{errs['decode_vs_forward']:.3e}")
    return errs


# ---------------------------------------------------------------------------
# phases 8-11: the mamba slice (K3, falcon-mamba-7b prefill and serve)
# ---------------------------------------------------------------------------

def scan_inputs(gen, B: int, S: int, din: int, ds: int, dtype: str, device):
    """(dt, Bt, Ct, x, A) drawn as tests/test_kernels.py draws them:
    dt = |N(0,1)| / 10, x, B, C ~ N(0,1) in ``dtype``; A = -(|N| + 0.1)
    fp32."""
    import torch
    dt = (_randn(gen, (B, S, din), "float32", device).abs() * 0.1).to(
        getattr(torch, dtype))
    Bt = _randn(gen, (B, S, ds), dtype, device)
    Ct = _randn(gen, (B, S, ds), dtype, device)
    x = _randn(gen, (B, S, din), dtype, device)
    A = -(_randn(gen, (din, ds), "float32", device).abs() + 0.1)
    return dt, Bt, Ct, x, A


def sm_clock_hz() -> float:
    """The SM clock's maximum, as nvidia-smi reports it (MHz) -> Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def phase_scan(device):
    import torch
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    gen = torch.Generator(device=device).manual_seed(9)
    worst = 0.0
    for B, S, din, ds, dtype in SSM_CASES:
        args = scan_inputs(gen, B, S, din, ds, dtype, device)
        y, h = ssm_scan(*args)
        y_ref, h_ref = ssm_scan_plain(*args)
        where = f"ssm_scan B={B} S={S} din={din} ds={ds} {dtype}"
        err = max(hold(y, y_ref, SSM_TOL, SSM_TOL, where + " y"),
                  hold(h, h_ref, SSM_TOL, SSM_TOL, where + " h_final"))
        worst = max(worst, err)
        log(f"phase 8 {where}: y and h_final max_abs_err={err:.3e} "
            f"(rtol=atol={SSM_TOL})")
        del args, y, h, y_ref, h_ref
    torch.cuda.empty_cache()

    B, S, din, ds = SSM_TIMED
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    exps = B * S * din * ds
    exp_ms = exps / (SFU_EXP_PER_CLOCK * sms * clock) * 1e3
    # per (step, channel, state): dt*A, a*h, (dt*x)*B, +, *C, +
    flops = 6 * exps + B * S * din
    flop_ms = flops / FP32_FLOPS * 1e3
    timed = {}
    for dtype in SSM_TIMED_DTYPES:      # the main path's dtype first
        args = scan_inputs(gen, B, S, din, ds, dtype, device)
        ms = cuda_ms(lambda: ssm_scan(*args), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: ssm_scan_plain(*args), PLAIN_REPS)
        # each input read once in the dtype it is handed, y and h_final
        # written once in fp32
        nbytes = sum(t.numel() * t.element_size() for t in args) + \
            (B * S * din + B * din * ds) * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(bytes_ms, flop_ms)
        bound_by = "bytes" if bound_ms == bytes_ms else "operations"
        log(f"phase 8 ssm_scan timed B={B} S={S} din={din} ds={ds} {dtype}"
            f" inputs: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}; bytes {nbytes} = "
            f"{bytes_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; fp32 "
            f"flops {flops} = {flop_ms:.4f} ms at {FP32_FLOPS / 1e12:.0f} "
            f"TFLOP/s) roofline_share={bound_ms / ms:.4f}; exps {exps} "
            f"through the SFUs alone = {exp_ms:.4f} ms at "
            f"{SFU_EXP_PER_CLOCK} a clock x {sms} SMs x {clock / 1e9:.3f} "
            f"GHz (not a floor: exps can also run on the FMA pipe); "
            f"library: none")
        timed[dtype] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        del args
        torch.cuda.empty_cache()
    return dict(max_abs_err=worst, library_ms=None,
                **timed[SSM_TIMED_DTYPES[0]])


def mamba_config():
    from repro_torch.configs import get_config
    return get_config(MAMBA_ARCH)


def fp32_feed_check(prefill, params, tokens, logits) -> float:
    """The prefill again, with the scan fed fp32 copies of dt, B, C and x
    as the block fed it before it handed over its bf16 tensors: raise
    unless the logits are bit-identical -> that prefill's ms.  Its
    launches fall outside the counted run."""
    import torch
    from repro_torch.models import mamba
    bf16_feed = mamba.ssm_scan
    mamba.ssm_scan = lambda dt, Bt, Ct, x, A: bf16_feed(
        dt.float(), Bt.float(), Ct.float(), x.float(), A)
    try:
        again = prefill(params, {"tokens": tokens})
        if not torch.equal(again, logits):
            diff = float((again.float() - logits.float()).abs().max())
            raise AssertionError(f"prefill: the fp32-copy feed changes the "
                                 f"logits (max abs diff {diff:.3e})")
        return cuda_ms(lambda: prefill(params, {"tokens": tokens}), 3)
    finally:
        mamba.ssm_scan = bf16_feed


def phase_mamba_prefill(device):
    """falcon-mamba-7b at full width, bf16, through the prefill step ->
    (params, numbers)."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params
    cfg = mamba_config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_LEN), generator=gen,
                           device=device)
    prefill = make_prefill_step(cfg)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                  # the prefill path starts here
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()          # ... and ends here
        expect_launches(counts, {"ssm_scan": cfg.n_layers},
                        f"prefill {cfg.name}")
        if logits.shape != (1, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill: logits {tuple(logits.shape)}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), 3)
        busy_ms, by_kernel = device_profile(
            lambda: prefill(params, {"tokens": tokens}), 1)
        k3_ms = kernel_device_ms(by_kernel, "ssm_scan_fwd_kernel")
        fp32_feed_ms = fp32_feed_check(prefill, params, tokens, logits)
    # every matmul weight once a token: the layers, and the lm head, which
    # the prefill step applies at all S positions before taking the last
    head = cfg.vocab * cfg.d_model
    flops = 2 * PREFILL_LEN * (cfg.n_params() - head)
    bound_ms = flops / BF16_FLOPS * 1e3
    layers_ms = 2 * PREFILL_LEN * (cfg.n_params() - 2 * head) / BF16_FLOPS \
        * 1e3
    scan_exps = cfg.n_layers * PREFILL_LEN * cfg.d_inner * cfg.ssm_state
    scan_flops = 6 * scan_exps
    log(f"phase 9 prefill {cfg.name} full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, {cfg.n_params()} "
        f"params, bf16, init {init_s:.1f} s) B=1 S={PREFILL_LEN}: "
        f"K3 launches={counts['ssm_scan']} first_call_s={first_s:.3f} "
        f"prefill_ms={ms:.3f} flop_bound_ms={bound_ms:.3f} (matmul flops="
        f"{flops} at {BF16_FLOPS / 1e12:.0f} TFLOP/s: the layers "
        f"{layers_ms:.3f} ms, the lm head the rest; the scan's fp32 "
        f"flops={scan_flops} and exps={scan_exps} are not in it) "
        f"roofline_share={bound_ms / ms:.4f} prefill_tokens_per_s="
        f"{PREFILL_LEN / ms * 1e3:.1f} device_busy_ms={busy_ms:.3f} "
        f"idle_share={1 - busy_ms / ms:.3f} k3_device_ms={k3_ms:.3f} "
        f"k3_share_of_busy={k3_ms / busy_ms:.3f} peak_device_gb="
        f"{peak_gb:.2f}")
    log(f"phase 9 prefill fed fp32 copies of dt, B, C and x (the former "
        f"block): logits bit-identical to the bf16 feed; prefill_ms="
        f"{fp32_feed_ms:.3f} against {ms:.3f} for the bf16 feed")
    log(f"phase 9 prefill device time by kernel (profiler, ms): "
        f"{_top(by_kernel)}")
    return params, dict(launches=counts["ssm_scan"], ms=ms)


def mamba_traffic(cfg):
    """-> {cell: (requests, batch, max_new)}.  "smoke" is the JAX serve
    command's traffic (answers and launches).  "batch32" is the serving
    cell: the chat cell's batch and answer length with 4-token prompts,
    since a mamba step's cost does not grow with context (an O(1) state):
    longer prompts add steps, not cost a step."""
    import numpy as np
    rng = np.random.RandomState(CHAT_SEED)
    batch32 = [{"id": f"m{i}", "prompt": rng.randint(
        0, cfg.vocab, (SERVE_PROMPT,)).tolist()}
        for i in range(CHAT_REQUESTS)]
    return {"smoke": (command_requests(cfg), SERVE_BATCH, SERVE_NEW),
            "batch32": (batch32, CHAT_BATCH, CHAT_NEW)}


def phase_mamba_serve(device, params):
    """``ServeEngine`` on the full-width model, the JAX serve command's
    traffic and the batch-32 cell; then the serve command (reduced
    config) on the card."""
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.serving import DurableRequestQueue
    cfg = mamba_config()
    for cell, (reqs, batch, max_new) in mamba_traffic(cfg).items():
        eng, r = drive_engine(cfg, params, reqs, batch, max_new, device,
                              {})       # decode runs no kernel
        del eng
        s = step_numbers(cfg, params, batch, SERVE_PROMPT + max_new - 2,
                         device)
        what = ("the JAX serve command's traffic: the answer and "
                "launch-count smoke" if cell == "smoke" else
                f"the chat cell's batch and answer length, {SERVE_PROMPT}"
                f"-token prompts from RandomState({CHAT_SEED})")
        log(f"phase 10 serve {cell} {cfg.name} full width ({cfg.n_layers} "
            f"layers, bf16; {what}): {r['n']}/{len(reqs)} requests "
            f"answered, batch {batch}, {max_new} tokens each, "
            + _serve_line(r, s))
        log(f"phase 10 serve {cell}: serve_step device time by kernel at the"
            f" last position (profiler, ms per step): {_top(s['by_kernel'])}")
    with tempfile.TemporaryDirectory() as tmp:
        serve.main(["--dir", tmp, "--arch", MAMBA_ARCH])
        served = DurableRequestQueue(tmp)
        answered = len(served.responses())
        served.close()
    if answered != SERVE_REQUESTS:
        raise AssertionError(f"serve command: {answered} responses")
    log(f"phase 10 python -m repro_torch.launch.serve --arch {MAMBA_ARCH} "
        f"(reduced, cuda): {answered} responses durable")


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
    from repro_torch.kernels.build import build_libraries

    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = DEVICE
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name}; nvidia-smi: {smi}; max SM clock "
        f"{sm_clock_hz() / 1e6:.0f} MHz; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = build_libraries(KERNELS)    # one nvcc per source, in parallel
    log(f"phase 1 build: {len(built)} libraries in "
        f"{time.perf_counter() - t0:.1f} s (" + ", ".join(
            f"{path.name} {secs:.1f} s" for path, secs, _ in built.values())
        + ")")
    for kname, (_, _, build_log) in built.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {kname}: {line.strip()}")

    worst = phase_matrix(device)
    summary, launches, worst_main = phase_main(device)
    worst = max(worst, worst_main)
    ref = summary["OptLinkedQ"]
    decode = phase_decode(device)
    flash = phase_flash(device)
    params, serve = phase_serve(device)
    prefill = phase_prefill(device, params)
    del params
    torch.cuda.empty_cache()
    phase_model_check(device, serving_config(), PREFILL_LEN, MODEL_STEPS, 7)
    scan = phase_scan(device)
    params, mamba_prefill = phase_mamba_prefill(device)
    phase_mamba_serve(device, params)
    del params
    torch.cuda.empty_cache()
    phase_model_check(device, mamba_config(), MAMBA_CHECK_LEN, 0, 11)
    kernels = [{
        "name": "fleet_step", "route": "cuda",
        "source": "src/repro_torch/csrc/fleet_step.cu",
        "replaces": "src/repro/kernels/fleet_step.py:35",
        "launches": launches, "max_abs_err": worst,
        "ms": ref["ms"], "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:63",
        "launches": serve["launches"]["decode_attention"], **decode,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
        "launches": prefill["launches"], **flash,
    }, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:58",
        "launches": mamba_prefill["launches"], **scan,
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
