#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc/``, holds
each against its plain PyTorch version on the card, drives the port's main
paths at full size (the fleet executor, ``repro_torch.fleet.run_fleet``;
yi-6b serving through ``ServeEngine`` and its prefill step; falcon-mamba-7b
prefill and serving; deepseek-moe-16b serving and prefill; training at
full width with its depth cut), and checks their results against
independent references.  It
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
   beside the byte bound, with TFLOP/s and kernel_ms / sdpa_ms; then
   nemotron-4-340b's attention (96 heads, 8 kv heads, head_dim 192):
   B=32, S=4096 with random lengths and lengths 1, 15, 17, 63 and 65, in
   fp32 and bf16, timed at B=32, S=4096 likewise;
5. K2, flash attention, vs its plain version: the JAX test shapes,
   non-causal, ragged S, S = 1, 15, 17 and 65 causal and not, and yi-6b's
   prefill shape (B=1, S=4096, bf16); the HMMA instructions of the bf16
   kernel; then the three timed at that shape beside the FLOP bound,
   with TFLOP/s and kernel_ms / sdpa_ms; nemotron-4-340b's attention at
   B=1, S=4096 causal and S = 1, 15, 17, 65, fp32 and bf16, timed at
   S=4096 likewise; and each of K2, K4 and K3 handed a CUDA input that
   requires grad raises (they have no backward) and launches under
   no_grad;
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
   versions on prefill last-token logits, and decode == forward at S=16;
12. serving main path of the MoE family: ``ServeEngine`` on
   deepseek-moe-16b at full width and depth (bf16, 28 layers, random
   weights from seed 0, max_len 2048) with the JAX serve command's
   traffic, K4 launched 28 times a step; ms per ``serve_step`` at the
   last position beside its byte bound, busy time and idle share; then
   ``python -m repro_torch.launch.serve --arch deepseek-moe-16b``;
13. its prefill (B=1, S=4096, bf16) through K2, 28 launches, beside the
   FLOP bound of the weights a token multiplies (router, top-6 routed and
   2 shared experts, attention, the lm head); then the model cut to 4
   layers in fp32, drop-free, kernels against the chunked paths on
   prefill last-token logits and 16 ``serve_step``s, and decode ==
   forward;
14. training at full width, depth cut: the chunked attention's (S=4096)
   and the chunked scan's (din 8192, S=512) fp32 gradients against
   autograd through the plain versions; ``make_train_step`` on
   deepseek-moe-16b cut to 4 layers (batch 4 x 4096, accum 2, 3 steps)
   and on falcon-mamba-7b cut to 2 layers (B=1, S=4096), each gated on
   its loss against the kernels' loss, its size, a finite gradient norm
   and every parameter updated, with ms a step, tokens/s, the FLOP
   bound, busy/idle share and peak memory; the ``train()`` driver on
   deepseek-moe-16b cut to 2 layers checkpointing at full width (free
   disk asserted), restoring bit for bit and resuming; then ``python -m
   repro_torch.launch.train --arch deepseek-moe-16b`` with
   ``--crash-at 6`` and again without.

The line before the last holds one JSON object with each kernel's
numbers; the last line is the device summary.
"""
import contextlib
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
    # deepseek-moe-16b's serve (16 heads, one a kv head): the smoke's
    # lengths, then random lengths
    (4, 2048, 16, 16, 128, "bfloat16", [1, 4, 8, 11]),
    (4, 2048, 16, 16, 128, "bfloat16", None),
] + [  # lengths at and around a warp's 16 keys and a step's 64; G = 1, 3, 16
    (4, 100, H, 2, 128, dtype, [1, 15, 17, 63])
    for H in (2, 6, 32) for dtype in ("float32", "bfloat16")
]
# nemotron-4-340b's attention (96 heads, 8 kv heads, head_dim 192): its
# decode at B=32, S=4096 with random lengths, and lengths at the tile edges
ATTN_192 = (96, 8, 192)                           # H, KV, hd
DECODE_CASES += [(32, 4096, *ATTN_192, dtype, None)
                 for dtype in ("float32", "bfloat16")] + [
    (5, 100, *ATTN_192, dtype, [1, 15, 17, 63, 65])
    for dtype in ("float32", "bfloat16")]
DECODE_TIMED = (128, 32768, 32, 4, 128)           # B, S, H, KV, hd; bf16
DECODE_TIMED_192 = (32, 4096, *ATTN_192)
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
    (1, 4096, 16, 16, 128, "bfloat16", True),     # deepseek-moe-16b prefill
] + [  # S at and around the 16-row and 64-key tiles of the mma kernel
    (2, S, 8, 2, 128, dtype, causal) for S in (1, 15, 17, 65)
    for causal in (True, False) for dtype in ("float32", "bfloat16")
]
# nemotron-4-340b's prefill attention at B=1, S=4096, and S around the tiles
FLASH_CASES += [(1, 4096, *ATTN_192, dtype, True)
                for dtype in ("float32", "bfloat16")] + [
    (2, S, *ATTN_192, dtype, True) for S in (1, 15, 17, 65)
    for dtype in ("float32", "bfloat16")]
FLASH_TIMED = (1, 4096, 32, 4, 128)               # B, S, H, KV, hd; bf16
FLASH_TIMED_192 = (1, 4096, *ATTN_192)
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
MOE_ARCH = "deepseek-moe-16b"
MOE_CHECK_LAYERS = 4        # the fp32 model check: dense_first + 3 MoE
# one MoE layer in fp32 (B, S): the prefill's and a decode step's tokens
MOE_LAYER_SHAPES = ((1, 4096), (4, 1))
# as tests/test_torch_moe.py: relative, and of the largest output absolute
MOE_TOL = 1e-5
# training at full width, depth cut (memory: see phase_train_moe)
TRAIN_MOE_LAYERS, TRAIN_BATCH, TRAIN_LEN, TRAIN_ACCUM = 4, 4, 4096, 2
TRAIN_STEPS = 3
TRAIN_MAMBA_LAYERS = 2
TRAIN_LOSS_TOL = 2e-2       # bf16: the train step's loss vs the kernels'
GRAD_TOL = 1e-4             # fp32 chunked vs plain gradients
GRAD_SCAN_LEN = 512         # the plain scan's autograd runs step by step
# the fp32 train-step gradient check: (arch, n_layers, batch, S), accum 2;
# S=4096 takes causal_attention_chunked's chunked branch
TRAIN_CHECK = (("deepseek-moe-16b", 2, 2, 4096), ("falcon-mamba-7b", 2, 2,
                                                   GRAD_SCAN_LEN))
# the train() driver: deepseek-moe-16b cut to 2 layers (dense_first + 1
# MoE), short sequences: the point is the checkpoint at full width
DRIVER_LAYERS, DRIVER_BATCH, DRIVER_LEN, DRIVER_STEPS = 2, 4, 256, 3


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
    worst = worst_192 = 0.0
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
        if hd == 192:
            worst_192 = max(worst_192, err)
        else:
            worst = max(worst, err)
        log(f"phase 4 decode_attention B={B} S={S} H={H} KV={KV} hd={hd} "
            f"{dtype} lengths={lens or 'random'}: max_abs_err={err:.3e} "
            f"(rtol, atol {ATTN_TOL[dtype]})")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    tensor_core_check("decode_attention", "decode_split_mma_kernel", 4)

    timed = time_decode(gen, DECODE_TIMED, device)
    timed["hd192"] = dict(time_decode(gen, DECODE_TIMED_192, device),
                          max_abs_err=worst_192)
    return dict(max_abs_err=worst, **timed)


def time_decode(gen, shape, device) -> dict:
    """K4, its plain version and one SDPA call timed at ``shape`` (B, S,
    H, KV, hd), bf16, full lengths, beside the byte bound."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    B, S, H, KV, hd = shape
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
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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
    worst = worst_192 = 0.0
    for B, S, H, KV, hd, dtype, causal in FLASH_CASES:
        q = _randn(gen, (B, S, H, hd), dtype, device)
        k = _randn(gen, (B, S, KV, hd), dtype, device)
        v = _randn(gen, (B, S, KV, hd), dtype, device)
        out = flash_attention(q, k, v, causal=causal)
        ref = flash_attention_plain(q, k, v, causal=causal)
        err = hold(out, ref, *ATTN_TOL[dtype],
                   f"flash B={B} S={S} H={H} KV={KV} hd={hd} {dtype} "
                   f"causal={causal}")
        if hd == 192:
            worst_192 = max(worst_192, err)
        else:
            worst = max(worst, err)
        log(f"phase 5 flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
            f"{dtype} causal={causal}: max_abs_err={err:.3e} "
            f"(rtol, atol {ATTN_TOL[dtype]})")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    tensor_core_check("flash_attention", "flash_fwd_mma_kernel", 5)

    timed = time_flash(gen, FLASH_TIMED, device)
    timed["hd192"] = dict(time_flash(gen, FLASH_TIMED_192, device),
                          max_abs_err=worst_192)
    grad_guard_check(device)
    return dict(max_abs_err=worst, **timed)


def time_flash(gen, shape, device) -> dict:
    """K2, its plain version and one SDPA call timed at ``shape`` (B, S,
    H, KV, hd), bf16, causal, beside the FLOP bound."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, S, H, KV, hd = shape
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
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def grad_guard_check(device) -> None:
    """Each attention and scan kernel, handed a CUDA tensor that requires
    grad with grad enabled, raises naming the path training takes, and
    launches nothing; under no_grad the same call launches."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan

    def z(*shape, grad=False):
        return torch.zeros(shape, device=device, requires_grad=grad)

    calls = {
        "flash_attention": lambda g: flash_attention(
            z(1, 64, 2, 64, grad=g), z(1, 64, 2, 64), z(1, 64, 2, 64)),
        "decode_attention": lambda g: decode_attention(
            z(1, 2, 64, grad=g), z(1, 64, 2, 64), z(1, 64, 2, 64),
            torch.full((1,), 64, dtype=torch.int32, device=device)),
        "ssm_scan": lambda g: ssm_scan(
            z(1, 64, 32, grad=g), z(1, 64, 16), z(1, 64, 16), z(1, 64, 32),
            z(32, 16) - 1),
    }
    fns = kernel_fns()
    for name, call in calls.items():
        before = fns[name].launches
        try:
            call(True)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            message = str(e)
        else:
            raise AssertionError(f"{name}: an input that requires grad "
                                 f"was launched")
        if fns[name].launches != before:
            raise AssertionError(f"{name}: launched while refusing")
        with torch.no_grad():
            call(True)
        torch.cuda.synchronize()
        if fns[name].launches != before + 1:
            raise AssertionError(f"{name}: no launch under no_grad")
        log(f"phase 5 gradient guard {name}: a CUDA input that requires "
            f"grad raises ({message.split(';')[1].strip()}); under no_grad "
            f"it launches")


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


def phase_prefill(device, params, cfg=None, phase: int = 7):
    """The prefill path of ``cfg`` (yi-6b by default) in bf16, B=1,
    S=PREFILL_LEN, through K2 once a layer, beside the FLOP bound of the
    weights a token multiplies (for MoE: the router, the top-k routed and
    the shared experts) and causal attention."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    cfg = cfg or serving_config()
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
    flops = 2 * PREFILL_LEN * matmul_weights(cfg) \
        + cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim * \
        PREFILL_LEN * (PREFILL_LEN + 1) // 2
    bound_ms = flops / BF16_FLOPS * 1e3
    log(f"phase {phase} prefill {cfg.name} full width B=1 S={PREFILL_LEN} "
        f"bf16 ({cfg.n_layers} layers, {cfg.n_params()} params, "
        f"{matmul_weights(cfg)} of them multiplied a token): "
        f"K2 launches={counts['flash_attention']} first_call_s={first_s:.3f}"
        f" prefill_ms={ms:.3f} flop_bound_ms={bound_ms:.3f} "
        f"(flops={flops}) roofline_share={bound_ms / ms:.4f} "
        f"prefill_tokens_per_s={PREFILL_LEN / ms * 1e3:.1f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / ms:.3f} "
        f"k2_device_ms={k2_ms:.3f} k2_share_of_busy={k2_ms / busy_ms:.3f}")
    log(f"phase {phase} prefill device time by kernel (profiler, ms): "
        f"{_top(by_kernel)}")
    return dict(launches=counts["flash_attention"], ms=ms)


def matmul_weights(cfg) -> int:
    """The weights a token multiplies: the active parameters (for MoE the
    router, the top-k routed and the shared experts) without the
    embedding table, which is gathered; the norms' scales (a few d_model
    a layer) are counted with them."""
    return cfg.n_active_params() - cfg.vocab * cfg.d_model


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


# ---------------------------------------------------------------------------
# phases 12-14: the MoE and training slice (deepseek-moe-16b serving and
# prefill, training at full width)
# ---------------------------------------------------------------------------

def moe_config(n_layers=None, **changes):
    """deepseek-moe-16b, its depth cut to ``n_layers`` when given."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    if n_layers is not None:
        changes["n_layers"] = n_layers
    return dataclasses.replace(cfg, **changes) if changes else cfg


def phase_moe_serve(device):
    """``ServeEngine`` on deepseek-moe-16b at full width and depth with the
    JAX serve command's traffic, K4 launched once a layer a step; then
    the serve command (reduced config) on the card -> (params, the run's
    numbers)."""
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.serving import DurableRequestQueue
    cfg = moe_config()
    reqs = command_requests(cfg)
    eng, r = drive_engine(cfg, None, reqs, SERVE_BATCH, SERVE_NEW, device,
                          {"decode_attention": cfg.n_layers})
    params = eng.params
    del eng
    s = step_numbers(cfg, params, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW - 2,
                     device)
    log(f"phase 12 serve smoke {cfg.name} full width ({cfg.n_layers} layers:"
        f" a dense FFN of {cfg.dense_ff_first}, then {cfg.n_experts} routed "
        f"experts of {cfg.d_ff}, top-{cfg.top_k}, and {cfg.n_shared_experts}"
        f" shared; d_model {cfg.d_model}, {cfg.n_params()} params, "
        f"{cfg.param_dtype}, "
        f"max_len {SERVE_MAX_LEN}; the JAX serve command's traffic): "
        f"{r['n']}/{len(reqs)} requests answered, batch {SERVE_BATCH}, "
        f"{SERVE_NEW} tokens each, " + _serve_line(r, s))
    log(f"phase 12 serve smoke: serve_step device time by kernel at the "
        f"last position (profiler, ms per step): {_top(s['by_kernel'])}")
    with tempfile.TemporaryDirectory() as tmp:
        serve.main(["--dir", tmp, "--arch", MOE_ARCH])
        served = DurableRequestQueue(tmp)
        answered = len(served.responses())
        served.close()
    if answered != SERVE_REQUESTS:
        raise AssertionError(f"serve command: {answered} responses")
    log(f"phase 12 python -m repro_torch.launch.serve --arch {MOE_ARCH} "
        f"(reduced, cuda): {answered} responses durable")
    return params, r


def moe_check_config():
    """deepseek-moe-16b cut to MOE_CHECK_LAYERS layers for the fp32 model
    check, with the capacity factor raised to n_experts / top_k so that no
    (token, expert) pair is dropped: a decode step routes its 4 tokens as
    one chunk with a capacity of 1 at the config's 1.25, where the forward
    routes chunks of 128 with a capacity of 15, so with drops the two drop
    different pairs by design (the reduced configs route drop-free for the
    same reason)."""
    cfg = moe_config(MOE_CHECK_LAYERS)
    return moe_config(MOE_CHECK_LAYERS,
                      capacity_factor=cfg.n_experts / cfg.top_k)


def moe_drops(cfg, params, x) -> int:
    """(token, expert) pairs of ``x`` past their expert's capacity, counted
    from the router's choices as ``moe_ffn`` chunks and routes them."""
    import math

    import torch
    from repro_torch.models.moe import _moe_chunks, _route
    T = x.shape[0] * x.shape[1]
    nc = _moe_chunks(T)
    tc = T // nc
    cap = int(max(1, math.ceil(tc * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor)))
    _, top_e = _route(cfg, params, x.reshape(nc, tc, -1))
    counts = torch.stack([torch.bincount(e.reshape(-1),
                                         minlength=cfg.n_experts)
                          for e in top_e])
    return int((counts - cap).clamp_min(0).sum())


def phase_moe_layer_check(device) -> None:
    """One deepseek-moe-16b MoE layer at full width in fp32 (TF32 off), at
    the prefill's and a decode step's shapes (MOE_LAYER_SHAPES).  Drop-free
    (capacity factor n_experts / top_k, no drop counted), ``moe_ffn`` on
    the card equals ``moe_ffn_dense_reference``, which runs every expert
    on every token and so shares none of the dispatch.  At the config's
    capacity factor, where capacity binds (drops counted, more than 0),
    ``moe_ffn`` on the card equals the same function on the CPU, which
    tests/test_torch_moe.py holds to the JAX package's: the card's stable
    argsort, searchsorted and scatter with repeated drop rows drop the same
    pairs.  At the prefill shape the gradients of a random projection of
    the output with respect to the input and every parameter are held to
    the CPU's as well.  Tolerance MOE_TOL relative and MOE_TOL of the
    largest value absolute; gradients GRAD_TOL likewise."""
    import torch
    from repro_torch.models.moe import init_moe, moe_ffn, \
        moe_ffn_dense_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = moe_config(param_dtype="float32", compute_dtype="float32")
    free = moe_config(param_dtype="float32", compute_dtype="float32",
                      capacity_factor=base.n_experts / base.top_k)
    params = init_moe(base, torch.Generator(device=device).manual_seed(0),
                      device)
    cpu = {k: v.cpu() for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(13)
    parts = []
    for B, S in MOE_LAYER_SHAPES:
        x = _randn(gen, (B, S, base.d_model), "float32", device)
        if moe_drops(free, params, x):
            raise AssertionError(f"MoE B={B} S={S}: drops at capacity "
                                 f"factor {free.capacity_factor}")
        with torch.no_grad():
            ref = moe_ffn_dense_reference(free, params, x)
            err = hold(moe_ffn(free, params, x), ref, MOE_TOL,
                       MOE_TOL * float(ref.abs().max()),
                       f"MoE B={B} S={S} vs the dense reference")
        drops = moe_drops(base, params, x)
        if drops == 0 or drops != moe_drops(base, cpu, x.cpu()):
            raise AssertionError(f"MoE B={B} S={S}: {drops} drops at "
                                 f"capacity factor {base.capacity_factor} "
                                 f"on the card, "
                                 f"{moe_drops(base, cpu, x.cpu())} on the CPU")
        live = {k: v.clone().requires_grad_() for k, v in params.items()}
        live_cpu = {k: v.clone().requires_grad_() for k, v in cpu.items()}
        xg, xg_cpu = x.clone().requires_grad_(), x.cpu().requires_grad_()
        out, out_cpu = moe_ffn(base, live, xg), moe_ffn(base, live_cpu,
                                                        xg_cpu)
        bind = hold(out.detach().cpu(), out_cpu.detach(), MOE_TOL,
                    MOE_TOL * float(out_cpu.detach().abs().max()),
                    f"MoE B={B} S={S} binding capacity, card vs CPU")
        line = (f"B={B} S={S}: drop-free vs dense max_abs_err={err:.3e}; "
                f"capacity factor {base.capacity_factor}, {drops} of "
                f"{B * S * base.top_k} pairs dropped on the card and the "
                f"CPU, card vs CPU max_abs_err={bind:.3e}")
        if S > 1:
            cot = _randn(gen, out.shape, "float32", device)
            names = ["x"] + list(live)
            grads = torch.autograd.grad((out * cot).sum(),
                                        [xg] + list(live.values()))
            grads_cpu = torch.autograd.grad(
                (out_cpu * cot.cpu()).sum(), [xg_cpu] + list(
                    live_cpu.values()))
            gerr = max(hold(g.cpu(), gc, GRAD_TOL,
                            GRAD_TOL * float(gc.abs().max()),
                            f"MoE binding capacity grad {n}, card vs CPU")
                       for n, g, gc in zip(names, grads, grads_cpu))
            line += (f", gradients of x and {len(live)} parameters "
                     f"max_abs_err={gerr:.3e}")
            del grads, grads_cpu, cot
        parts.append(line)
        del live, live_cpu, xg, xg_cpu, out, out_cpu, ref, x
    del params, cpu
    torch.cuda.empty_cache()
    log(f"phase 13 MoE layer {base.name} full width fp32 ({base.n_experts} "
        f"experts of {base.d_ff}, top-{base.top_k}, {base.n_shared_experts} "
        f"shared; rtol=MOE_TOL={MOE_TOL}, atol=MOE_TOL x max|ref|, "
        f"gradients {GRAD_TOL}): " + "; ".join(parts))


def train_batch(gen, cfg, B: int, S: int, device) -> dict:
    """Random tokens and their next tokens as labels."""
    import torch
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def train_flops(cfg, B: int, S: int) -> tuple:
    """(bf16 tensor-core flops, fp32 flops) of one training step's least
    work: 6 x the weights a token multiplies x tokens, and causal
    attention's two products three times (forward, and twice that
    backward); a mamba layer's scan, 6 fp32 flops a (step, channel,
    state), three times."""
    from repro_torch.models import layer_specs
    mixers = [m for m, _ in layer_specs(cfg)]
    attn = 3 * mixers.count("attn") * 4 * B * cfg.n_heads * cfg.head_dim \
        * S * (S + 1) // 2
    scan = 3 * mixers.count("mamba") * 6 * B * S * cfg.d_inner * \
        cfg.ssm_state
    return 6 * matmul_weights(cfg) * B * S + attn, scan


def train_cell(device, cfg, B: int, S: int, accum: int, steps: int,
               where: str) -> dict:
    """``make_train_step(cfg, accum)`` for ``steps`` steps in bf16 at
    full width from seed 0, with the gates: the first step's loss equals
    the loss through the kernels (``loss_fn(use_kernels=True)`` under
    no_grad, micro-batch by micro-batch, on the same parameters and
    batch) within TRAIN_LOSS_TOL; it is finite and within 0.5 of
    ln(vocab) + 1/2 (a random model's logits have unit variance at init,
    and E[logsumexp] of V unit normals is ln V + 1/2); the gradient norm
    is finite; every parameter was updated: after the first step each
    one's first moment (fp32) is nonzero somewhere.  (Its bf16 value need
    not change yet: the schedule's first learning rate, 3e-4 / 100 of
    warmup, moves a weight by less than half a bf16 step, and a norm
    scale of exactly 1.0 not at all; the count that did change is
    printed.)  -> numbers."""
    import math

    import torch
    from repro_torch.launch.steps import make_train_step, opt_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.adamw import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt = init_opt_state(opt_config(cfg), params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(11)
    batches = [train_batch(gen, cfg, B, S, device) for _ in range(steps)]
    with torch.no_grad():
        kernel_loss = sum(float(loss_fn(cfg, params, {
            k: v.reshape(accum, B // accum, S)[i]
            for k, v in batches[0].items()}, use_kernels=True))
            for i in range(accum)) / accum
    step = make_train_step(cfg, accum)
    first = params
    reset_counts()                      # the training path starts here
    times, losses, norms = [], [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 0:
            n_leaves = len(tree_leaves(first))
            changed = sum(not torch.equal(a, b) for a, b in
                          zip(tree_leaves(params), tree_leaves(first)))
            still = sum(not bool(m.abs().amax() > 0)
                        for m in tree_leaves(opt["m"]))
            del first
    counts = read_counts()              # ... and ends here
    expect_launches(counts, {}, where)  # the plain paths: no kernel
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ln_v = math.log(cfg.vocab)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{where}: losses {losses}, norms {norms}")
    if abs(losses[0] - kernel_loss) > TRAIN_LOSS_TOL:
        raise AssertionError(f"{where}: loss {losses[0]} vs the kernels' "
                             f"{kernel_loss}")
    if abs(losses[0] - (ln_v + 0.5)) > 0.5:
        raise AssertionError(f"{where}: loss {losses[0]}, ln(V) + 1/2 = "
                             f"{ln_v + 0.5}")
    if still:
        raise AssertionError(f"{where}: {still} of {n_leaves} parameters "
                             f"have a zero first moment after a step")

    def one():
        nonlocal params, opt
        params, opt, _ = step(params, opt, batches[-1])

    busy_ms, by_kernel = device_profile(one, 1)
    del params, opt
    torch.cuda.empty_cache()
    step_s = sum(times[1:]) / max(1, len(times) - 1)
    mm, fp32 = train_flops(cfg, B, S)
    bound_ms = (mm / BF16_FLOPS + fp32 / FP32_FLOPS) * 1e3
    return dict(init_s=init_s, times=times, losses=losses, norms=norms,
                kernel_loss=kernel_loss, ln_v=ln_v, step_ms=step_s * 1e3,
                tokens_per_s=B * S / step_s, bound_ms=bound_ms, mm=mm,
                fp32=fp32, busy_ms=busy_ms, by_kernel=by_kernel,
                peak_gb=peak_gb, n_leaves=n_leaves, changed=changed)


def _train_line(cfg, B, S, accum, r) -> str:
    return (f"{cfg.n_params()} params ({matmul_weights(cfg)} multiplied a "
            f"token), {cfg.param_dtype}, batch {B} x S={S}, accum {accum}: "
            f"losses={[round(x, 4) for x in r['losses']]} "
            f"kernels_loss={r['kernel_loss']:.4f} (|diff| "
            f"{abs(r['losses'][0] - r['kernel_loss']):.2e} <= "
            f"{TRAIN_LOSS_TOL}) ln_v_plus_half={r['ln_v'] + 0.5:.4f} "
            f"grad_norms={[round(x, 4) for x in r['norms']]} "
            f"{r['n_leaves']}/{r['n_leaves']} parameters updated (first "
            f"moment nonzero), {r['changed']} of them changed in bf16 by "
            f"step 1; "
            f"step_s={[round(x, 3) for x in r['times']]} step_ms="
            f"{r['step_ms']:.1f} (the steps after the first) tokens_per_s="
            f"{r['tokens_per_s']:.1f} bound_ms={r['bound_ms']:.1f} "
            f"(operations: {r['mm']} bf16 flops at {BF16_FLOPS / 1e12:.0f} "
            f"TFLOP/s + {r['fp32']} fp32 at {FP32_FLOPS / 1e12:.0f}) "
            f"roofline_share={r['bound_ms'] / r['step_ms']:.4f} "
            f"device_busy_ms={r['busy_ms']:.1f} idle_share="
            f"{1 - r['busy_ms'] / r['step_ms']:.3f} init_s="
            f"{r['init_s']:.1f} peak_device_gb={r['peak_gb']:.2f}")


def phase_train(device) -> None:
    """Training at full width, depth cut: deepseek-moe-16b at
    TRAIN_MOE_LAYERS layers and falcon-mamba-7b at TRAIN_MAMBA_LAYERS,
    through the chunked attention and scan."""
    import dataclasses
    cfg = moe_config(TRAIN_MOE_LAYERS)
    r = train_cell(device, cfg, TRAIN_BATCH, TRAIN_LEN, TRAIN_ACCUM,
                   TRAIN_STEPS, f"train {cfg.name}")
    log(f"phase 14 train {cfg.name} full width, reduced: n_layers "
        f"{cfg.n_layers} (of 28: dense_first + {cfg.n_layers - 1} MoE), "
        + _train_line(cfg, TRAIN_BATCH, TRAIN_LEN, TRAIN_ACCUM, r))
    log(f"phase 14 train {cfg.name}: device time by kernel of one step "
        f"(profiler, ms): {_top(r['by_kernel'])}")
    mcfg = dataclasses.replace(mamba_config(), n_layers=TRAIN_MAMBA_LAYERS)
    r = train_cell(device, mcfg, 1, TRAIN_LEN, 1, 2, f"train {mcfg.name}")
    log(f"phase 14 train {mcfg.name} full width, reduced: n_layers "
        f"{mcfg.n_layers} (of 64), " + _train_line(mcfg, 1, TRAIN_LEN, 1, r))
    log(f"phase 14 train {mcfg.name}: device time by kernel of one step "
        f"(profiler, ms): {_top(r['by_kernel'])}")


def phase_grad_check(device) -> None:
    """One layer's training paths in fp32 at full width against autograd
    through the plain versions: deepseek-moe-16b's attention at S=4096
    (``causal_attention_chunked`` takes its chunked branch above 2048),
    and falcon-mamba-7b's scan at din 8192, ds 16, S=GRAD_SCAN_LEN."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ssm_scan import ssm_scan_plain
    from repro_torch.models.attention import causal_attention_chunked
    from repro_torch.models.mamba import selective_scan_chunked
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(12)
    cfg = moe_config()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ins = [_randn(gen, (1, TRAIN_LEN, n, hd), "float32", device)
           for n in (H, KV, KV)]
    cot = _randn(gen, (1, TRAIN_LEN, H, hd), "float32", device)
    errs = {}
    for name, fn in (("chunked", lambda q, k, v: causal_attention_chunked(
            q, k, v, H // KV)), ("plain", flash_attention_plain)):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fn(*leaves)
        errs[name] = [out.detach()] + list(torch.autograd.grad(
            (out * cot).sum(), leaves))
        del out, leaves
    attn_err = max(hold(a, b, GRAD_TOL, GRAD_TOL, f"attention grad {n}")
                   for n, a, b in zip(("out", "dq", "dk", "dv"),
                                      errs["chunked"], errs["plain"]))
    del errs, ins, cot
    torch.cuda.empty_cache()
    mcfg = mamba_config()
    args = scan_inputs(gen, 1, GRAD_SCAN_LEN, mcfg.d_inner, mcfg.ssm_state,
                       "float32", device)
    cy = _randn(gen, (1, GRAD_SCAN_LEN, mcfg.d_inner), "float32", device)
    ch = _randn(gen, (1, mcfg.d_inner, mcfg.ssm_state), "float32", device)
    res = {}
    for name, fn in (("chunked", selective_scan_chunked),
                     ("plain", ssm_scan_plain)):
        leaves = [t.clone().requires_grad_() for t in args]
        y, h = fn(*leaves)
        res[name] = [y.detach(), h.detach()] + list(torch.autograd.grad(
            (y * cy).sum() + (h * ch).sum(), leaves))
        del y, h, leaves
    scan_err = max(hold(a, b, GRAD_TOL, GRAD_TOL, f"scan grad {n}")
                   for n, a, b in zip(("y", "h", "d_dt", "d_B", "d_C",
                                       "d_x", "d_A"),
                                      res["chunked"], res["plain"]))
    del res, args
    torch.cuda.empty_cache()
    log(f"phase 14 fp32 gradients, one layer at full width, chunked vs "
        f"autograd through the plain version (rtol=atol={GRAD_TOL}): "
        f"attention B=1 S={TRAIN_LEN} H={H} KV={KV} hd={hd} output, dq, "
        f"dk, dv max_abs_err={attn_err:.3e}; selective scan B=1 "
        f"S={GRAD_SCAN_LEN} din={mcfg.d_inner} ds={mcfg.ssm_state} y, "
        f"h_final and the five input gradients max_abs_err={scan_err:.3e}")


@contextlib.contextmanager
def plain_training_paths():
    """Inside: the model's training paths are the oracles, with autograd
    through them -- ``flash_attention_plain`` (all S x S scores) for
    ``causal_attention_chunked``, ``ssm_scan_plain`` (a step at a time)
    for ``selective_scan_chunked``, ``moe_ffn_dense_reference`` (every
    expert on every token) for ``moe_ffn``."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ssm_scan import ssm_scan_plain
    from repro_torch.models import attention, blocks, mamba
    from repro_torch.models.moe import moe_ffn_dense_reference
    swaps = [(attention, "causal_attention_chunked",
              lambda q, k, v, n_kv_groups: flash_attention_plain(q, k, v)),
             (mamba, "selective_scan_chunked", ssm_scan_plain),
             (blocks, "moe_ffn", moe_ffn_dense_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_train_grad_check(device) -> None:
    """The whole train step against autograd through the oracles, in fp32
    (TF32 off), for each TRAIN_CHECK model at full width, depth cut:
    ``make_train_step(cfg, accum=2)`` (chunked attention and scan, the
    dispatching MoE, remat "nothing", two micro-batches summed) takes one
    step; the reference is ``torch.autograd.grad`` of ``loss_fn`` over the
    whole batch inside :func:`plain_training_paths`, with no remat.  MoE
    routes drop-free (capacity factor n_experts / top_k), where the dense
    reference is exact.  After one step AdamW's first moment is (1 - b1)
    x the clipped gradient, so every leaf of it is held to the reference's
    gradient clipped by the reference's norm: GRAD_TOL relative and
    GRAD_TOL of the leaf's largest value absolute; the loss and the norm
    to GRAD_TOL relative.  No kernel is launched."""
    import dataclasses
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, opt_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.adamw import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, n_layers, B, S in TRAIN_CHECK:
        cfg = get_config(arch)
        changes = dict(n_layers=n_layers, param_dtype="float32",
                       compute_dtype="float32")
        if cfg.n_experts:
            changes["capacity_factor"] = cfg.n_experts / cfg.top_k
        cfg = dataclasses.replace(cfg, **changes)
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0))
        batch = train_batch(torch.Generator(device=device).manual_seed(14),
                            cfg, B, S, device)
        ocfg = opt_config(cfg)
        reset_counts()
        _, opt, metrics = make_train_step(cfg, accum=2)(
            params, init_opt_state(ocfg, params), batch)
        expect_launches(read_counts(), {}, f"train check {cfg.name}")
        moments = tree_leaves(opt["m"])
        n_leaves = len(moments)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        del opt, metrics
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with plain_training_paths(), torch.enable_grad():
            ref_loss = loss_fn(cfg, live, batch, remat_policy="none_inference")
            grads = torch.autograd.grad(ref_loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        ref_loss = float(ref_loss.detach())
        del leaves, live, params
        ref_norm = math.sqrt(sum(float(g.square().sum()) for g in grads))
        clip = min(1.0, ocfg.grad_clip / max(ref_norm, 1e-9))
        for name, mine, ref in (("loss", loss, ref_loss),
                                ("grad_norm", norm, ref_norm)):
            if abs(mine - ref) > GRAD_TOL * abs(ref):
                raise AssertionError(f"train check {cfg.name}: {name} "
                                     f"{mine} vs the oracles' {ref}")
        err = 0.0
        for i, (m, g) in enumerate(zip(moments, grads)):
            want = (1 - ocfg.b1) * clip * g
            err = max(err, hold(m, want, GRAD_TOL,
                                GRAD_TOL * float(want.abs().max()),
                                f"train check {cfg.name} leaf {i} "
                                f"{tuple(g.shape)}"))
        del moments, grads
        torch.cuda.empty_cache()
        log(f"phase 14 train step check {cfg.name} full width fp32, "
            f"reduced: n_layers {n_layers}, batch {B} x S={S}, accum 2, "
            f"remat nothing, vs autograd through flash_attention_plain, "
            f"ssm_scan_plain and moe_ffn_dense_reference: loss {loss:.6f} "
            f"vs {ref_loss:.6f}, grad_norm {norm:.6f} vs "
            f"{ref_norm:.6f}, first moments of {n_leaves} parameters "
            f"max_abs_err={err:.3e} (rtol={GRAD_TOL}, atol={GRAD_TOL} x "
            f"the leaf's max)")


def phase_train_driver(device) -> None:
    """The ``train()`` driver at full width (deepseek-moe-16b cut to
    DRIVER_LAYERS layers): DRIVER_STEPS steps with a checkpoint at the
    last; the checkpoint restored equals the state bit for bit; a second
    call resumes from it and runs one more step.  Then the command line,
    on the reduced config: a crash at step 6 (exit 42) and a rerun that
    resumes from step 4 and consumes every shard once."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import DurableCheckpointer
    from repro_torch.data import DurableShardQueue
    from repro_torch.launch.train import state_from_numpy, train
    from repro_torch.optim.adamw import tree_leaves
    cfg = moe_config(DRIVER_LAYERS)
    ckpt_bytes = 10 * cfg.n_params()    # bf16 params, fp32 m and v
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"phase 14 disk: {free} bytes free under {tempfile.gettempdir()}"
            f" for checkpoints of about {ckpt_bytes} bytes (two kept)")
        if free < 2 * ckpt_bytes + (4 << 30):
            raise AssertionError(f"only {free} bytes free for two "
                                 f"checkpoints of {ckpt_bytes}")
        lines = []

        def keep(msg):
            lines.append(msg)
            log(f"  train(): {msg}")

        first = train(cfg, steps=DRIVER_STEPS, batch=DRIVER_BATCH,
                      seq_len=DRIVER_LEN, ckpt_dir=tmp,
                      ckpt_every=DRIVER_STEPS, device=device, log=keep)
        for save in first["saves"]:
            log(f"phase 14 checkpoint at step {save['step']}: "
                f"{save['bytes']} bytes in {save['seconds']:.2f} s "
                f"({save['bytes'] / save['seconds'] / 1e9:.2f} GB/s, "
                f"device to host, npz write and fsync)")
        t0 = time.perf_counter()
        step, shards, _ = DurableCheckpointer(
            os.path.join(tmp, "ckpt"), background=False).restore_latest()
        back = {k: state_from_numpy(v, device, cfg.param_dtype)
                for k, v in shards[0].items()}
        restore_s = time.perf_counter() - t0
        del shards
        saved = {"params": first["params"], "opt": first["opt_state"]}
        pairs = list(zip(tree_leaves(back), tree_leaves(saved)))
        if step != DRIVER_STEPS or not all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
            raise AssertionError("the restored checkpoint differs from the "
                                 "saved state")
        del back, saved, pairs, first
        torch.cuda.empty_cache()
        lines.clear()
        second = train(cfg, steps=DRIVER_STEPS + 1, batch=DRIVER_BATCH,
                       seq_len=DRIVER_LEN, ckpt_dir=tmp,
                       ckpt_every=DRIVER_STEPS, device=device, log=keep)
        if not lines[0].startswith(f"[recovery] resumed from step "
                                   f"{DRIVER_STEPS}") or \
                second["start_step"] != DRIVER_STEPS or \
                len(second["losses"]) != 1:
            raise AssertionError(f"train() did not resume: {lines}")
        log(f"phase 14 train() {cfg.name} full width, reduced: n_layers "
            f"{cfg.n_layers} ({cfg.n_params()} params), batch {DRIVER_BATCH}"
            f" x S={DRIVER_LEN}: {DRIVER_STEPS} steps, checkpoint at step "
            f"{DRIVER_STEPS} restored bit for bit ({restore_s:.2f} s to read"
            f" and place on the card), a second call resumed from step "
            f"{DRIVER_STEPS} and ran step {DRIVER_STEPS + 1} (loss "
            f"{second['losses'][0]:.4f})")
        del second
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tmp = tempfile.mkdtemp(prefix="repro_torch_train_cli_")
    try:
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                MOE_ARCH, "--steps", "12", "--ckpt-every", "4",
                "--ckpt-dir", tmp]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        p1 = subprocess.run(args + ["--crash-at", "6"], env=env, cwd=ROOT,
                            capture_output=True, text=True, timeout=300)
        if p1.returncode != 42 or "step 4: " not in p1.stdout:
            raise AssertionError(f"train --crash-at 6: exit "
                                 f"{p1.returncode}\n{p1.stdout}\n"
                                 f"{p1.stderr[-3000:]}")
        p2 = subprocess.run(args, env=env, cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
        steps = [ln.split(":")[0] for ln in p2.stdout.splitlines()
                 if ln.startswith("step ")]
        if p2.returncode != 0 or "[recovery] resumed from step 4" not in \
                p2.stdout or "done: 12 steps" not in p2.stdout or \
                steps != [f"step {i}" for i in range(5, 13)]:
            raise AssertionError(f"train rerun: exit {p2.returncode}\n"
                                 f"{p2.stdout}\n{p2.stderr[-3000:]}")
        q = DurableShardQueue(os.path.join(tmp, "data"))
        cursor = q.recover()
        q.close()
        if cursor != 12:
            raise AssertionError(f"data cursor {cursor} after 12 steps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 14 python -m repro_torch.launch.train --arch {MOE_ARCH} "
        f"--steps 12 --ckpt-every 4 (reduced, cuda): --crash-at 6 exited 42"
        f" after step 6; the rerun resumed from step 4, ran steps 5-12, "
        f"printed 'done: 12 steps', and the data cursor is 12: shards 0-11 "
        f"each consumed once in the committed history")


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
    params, moe_serve = phase_moe_serve(device)
    moe_prefill = phase_prefill(device, params, moe_config(), 13)
    del params
    torch.cuda.empty_cache()
    check = moe_check_config()
    log(f"phase 13 model check config: {check.name} reduced: n_layers "
        f"{check.n_layers} (65 GB in fp32 at full depth), capacity_factor "
        f"{check.capacity_factor:.4f} = n_experts / top_k, so no pair is "
        f"dropped (see moe_check_config)")
    phase_model_check(device, check, PREFILL_LEN, MODEL_STEPS, 13)
    phase_moe_layer_check(device)
    phase_grad_check(device)
    phase_train_grad_check(device)
    phase_train(device)
    phase_train_driver(device)
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
        "launches_deepseek_moe": moe_serve["launches"]["decode_attention"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
        "launches": prefill["launches"], **flash,
        "launches_deepseek_moe": moe_prefill["launches"],
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
