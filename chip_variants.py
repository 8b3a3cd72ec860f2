#!/usr/bin/env python3
"""What each design choice of the tensor-core attention kernels costs, on
one NVIDIA GPU.

Run from the repository root: ``python3 chip_variants.py``.  It writes
edited copies of ``src/repro_torch/csrc/{flash,decode}_attention.cu`` into
``build/repro_torch/variants/``, builds each with the port's own nvcc
flags, binds it in place of the source's library, and times it in turns
with the source (source, variants, variants in reverse, source) on the
same inputs, with CUDA events:

- K2 and K4 without the second (lo) product of P V, so with P rounded
  once to bf16: the time the hi + lo split costs, and how many outputs
  then miss the bf16 tolerance (rtol 2e-2, atol 1e-3);
- K4 with a ring of 2 or 4 stages a warp instead of 3 (3, 2 and 1
  blocks a SM at hd 128);
- K4's split target ``BLOCKS_PER_SM`` from 1 to 32 blocks a SM;
- one PyTorch SDPA call on the same inputs, with its outputs counted
  against the same bf16 tolerance (it is a yardstick, not a variant).

Shapes: K2 at yi-6b's prefill (B=1, S=4096, 32/4 heads, hd 128, causal);
K4 at B=128, S=32768 with full lengths and at the chat serving cell's
B=32, S=2048 with lengths drawn in [1000, 2048).  All bf16.  Nothing here
changes the port; it needs the card and exits 2 without one.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = 20
DECODE_CELLS = {"b128_s32768": (128, 32768, None),
                "chat_b32_s2048": (32, 2048, (1000, 2048))}
# the lo products of P V, as they stand in each source
FLASH_LO = """#pragma unroll
        for (int i = 0; i < VP; ++i) {
          attn::mma_bf16(acc[2 * (dp + i)], pl, vb[i][0], vb[i][1]);
          attn::mma_bf16(acc[2 * (dp + i) + 1], pl, vb[i][2], vb[i][3]);
        }"""
DECODE_LO = """      attn::mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
      attn::mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);"""
DECODE_STAGES = "constexpr int STAGES = 3;"
DECODE_BOUNDS = "__launch_bounds__(THREADS, 2)\ndecode_split_mma_kernel"


def build_variant(name: str, tag: str, edits):
    """The C launch function of ``csrc/<name>.cu`` with ``edits`` ((old,
    new) pairs, each found exactly once) applied, built and bound."""
    from repro_torch.kernels import build
    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"{tag}: the edit does not match once")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{tag}.cu").write_text(src)
    lib = out / f"lib{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(lib), str(out / f"{tag}.cu")],
                   check=True, capture_output=True)
    n_ptr, n_int = (4, 7) if name == "flash_attention" else (8, 8)
    return build.bind(ctypes.CDLL(str(lib)), f"{name}_launch", n_ptr, n_int)


def misses(out, ref) -> int:
    out, ref = out.float(), ref.float()
    return int(((out - ref).abs() > 1e-3 + 2e-2 * ref.abs()).sum())


def report(where: str, tag: str, call, ref) -> None:
    import chip_smoke as cs
    out = call()
    ms = cs.cuda_ms(call, REPS)
    print(f"{where} {tag}: ms={ms:.4f} outside_bf16_tol={misses(out, ref)} "
          f"max_abs_err={float((out.float() - ref.float()).abs().max()):.3e}",
          flush=True)


def in_turns(module, fns: dict, call, ref, where: str) -> None:
    """Time each of ``fns`` (bound C functions) as ``module``'s kernel,
    in the order given and then reversed."""
    original = module._kernel
    try:
        for tag in list(fns) + list(fns)[::-1]:
            module._kernel = lambda f=fns[tag]: f
            report(where, tag, call, ref)
    finally:
        module._kernel = original


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.kernels.decode_attention as da
    import repro_torch.kernels.flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)

    flash = {"source": fa._kernel(),
             "one_bf16_p": build_variant("flash_attention", "flash_one_p",
                                         [(FLASH_LO, "")])}
    decode = {"source": da._kernel(),
              "one_bf16_p": build_variant("decode_attention",
                                          "decode_one_p", [(DECODE_LO, "")])}
    for stages, blocks in ((2, 3), (4, 1)):
        decode[f"stages_{stages}"] = build_variant(
            "decode_attention", f"decode_stages{stages}",
            [(DECODE_STAGES, f"constexpr int STAGES = {stages};"),
             (DECODE_BOUNDS, DECODE_BOUNDS.replace(", 2)", f", {blocks})"))])

    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, H, KV, hd = cs.FLASH_TIMED
    q = cs._randn(gen, (B, S, H, hd), "bfloat16", "cuda")
    k = cs._randn(gen, (B, S, KV, hd), "bfloat16", "cuda")
    v = cs._randn(gen, (B, S, KV, hd), "bfloat16", "cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ref = fa.flash_attention_plain(q, k, v)
    where = f"flash B={B} S={S} H={H} KV={KV} hd={hd} causal"
    in_turns(fa, flash, lambda: fa.flash_attention(q, k, v), ref, where)
    report(where, "sdpa", lambda: sdpa(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2), ref)
    del q, k, v, ref

    H, KV, hd = 32, 4, 128
    for cell, (B, S, drawn) in DECODE_CELLS.items():
        q = cs._randn(gen, (B, H, hd), "bfloat16", "cuda")
        k = cs._randn(gen, (B, S, KV, hd), "bfloat16", "cuda")
        v = cs._randn(gen, (B, S, KV, hd), "bfloat16", "cuda")
        lengths = (torch.full((B,), S, device="cuda") if drawn is None else
                   torch.randint(*drawn, (B,), generator=gen,
                                 device="cuda")).to(torch.int32)
        bound_ms = 2 * int(lengths.sum()) * KV * hd * 2 / \
            cs.HBM_BYTES_PER_S * 1e3
        where = f"decode {cell} (byte bound {bound_ms:.4f} ms)"

        def call():
            return da.decode_attention(q, k, v, lengths)

        ref = da.decode_attention_plain(q, k, v, lengths)
        in_turns(da, decode, call, ref, where)
        mask = (torch.arange(S, device="cuda")[None, :] <
                lengths[:, None])[:, None, None, :]
        report(where, "sdpa", lambda: sdpa(
            q.view(B, KV, H // KV, hd), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask).reshape(B, H, hd), ref)
        target = da.BLOCKS_PER_SM
        try:
            for blocks in (1, 2, 4, 8, 16, 32):
                da.BLOCKS_PER_SM = blocks
                plan = da.split_plan(B, S, KV, da._sm_count(0))
                print(f"{where} BLOCKS_PER_SM={blocks} (n_splits, "
                      f"split_len)={plan}: ms="
                      f"{cs.cuda_ms(call, REPS):.4f}", flush=True)
        finally:
            da.BLOCKS_PER_SM = target
        del q, k, v, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
