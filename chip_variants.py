#!/usr/bin/env python3
"""What each design choice of the port's CUDA kernels costs, on one NVIDIA
GPU.

Run from the repository root: ``python3 chip_variants.py``.  It writes
edited copies of ``src/repro_torch/csrc/{fleet_step,ssm_scan,flash_attention,
decode_attention}.cu`` into ``build/repro_torch/variants/``, builds each
with the port's own nvcc flags, binds it in place of the source's library,
and times it in turns with the source (source, variants, variants in
reverse, source) on the same inputs, with CUDA events:

- K1, the fleet chunk stepper, with cached/finval/everfl packed into one
  byte a line (bits 0-2 of the ``cached`` plane, packed before and
  unpacked after each timed chunk: a kernel-only change the exposed state
  does not show), with 64 or 256 threads a block instead of 128, with
  a persistent grid of 2, 4, 6, 8 or 16 blocks an SM instead of 3, and
  with the state laid out instance-minor as ``[X, N]`` or instance-major
  as ``[N, X]`` (the reference's) instead of in warp tiles; at
  the fleet main path's OptLinkedQ cell (1,000,000 instances, chunk 48),
  on chunk 0 and on chunk 1, each result held to the source's;
- K3, the selective scan, with 16 or 4 lanes a channel (1 or 4 states a
  lane) instead of 8, with a ring of 1 or 3 stages instead of 2, and
  with two groups of a channel's steps unrolled together instead of one,
  and with chunks of 32 or 128 steps instead of 64 (the SASS instruction
  counts of the source's kernels are printed first); then, timing only,
  copies that each leave one part of the chunk out (step loads, exps,
  shuffles, the convert pass, the y stores); at
  falcon-mamba-7b's prefill shape with bf16 inputs, each held to the plain
  version within 1e-4;

- K2 and K4 without the second (lo) product of P V, so with P rounded
  once to bf16: the time the hi + lo split costs, and how many outputs
  then miss the bf16 tolerance (rtol 2e-2, atol 1e-3);
- K4 with a ring of 2 or 4 stages a warp instead of 3 (3, 2 and 1
  blocks a SM at hd 128);
- K4's split target ``BLOCKS_PER_SM`` from 1 to 32 blocks a SM;
- one PyTorch SDPA call on the same inputs, with its outputs counted
  against the same bf16 tolerance (it is a yardstick, not a variant).

Attention shapes: K2 at yi-6b's prefill (B=1, S=4096, 32/4 heads, hd
128, causal); K4 at B=128, S=32768 with full lengths and at the chat
serving cell's B=32, S=2048 with lengths drawn in [1000, 2048).  All
bf16.  Nothing here changes the port; it needs the card and exits 2
without one.
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
FLEET_BLOCK = "#define BLOCK 128"
FLEET_BLOCKS_PER_SM = "#define BLOCKS_PER_SM 3"
# K1's line state as one byte a line: bit 0 cached, bit 1 finval, bit 2
# everfl, in the cached plane (replaces the source's struct Lines)
PACKED_LINES = """struct Lines {
  Col<uint8_t> packed;

  __device__ __forceinline__ Lines(const FsArgs& A, int64_t i)
      : packed(col<uint8_t>(A.cached, i, A.nl)) {}
  __device__ __forceinline__ int classify_recache(int ln) const {
    const int b = packed[ln];
    packed[ln] = static_cast<uint8_t>((b & 4) | 1);
    return (b & 1) ? EV_HIT : (b & 2) ? EV_POSTFLUSH
                            : (b & 4) ? EV_COLD_NVM : EV_COLD_DRAM;
  }
  __device__ __forceinline__ void recache(int ln) const {
    packed[ln] = static_cast<uint8_t>((packed[ln] & 4) | 1);
  }
  __device__ __forceinline__ void invalidate(int ln) const {
    packed[ln] = 6;
  }
  __device__ __forceinline__ void mark_flushed(int ln) const {
    packed[ln] |= 4;
  }
};
"""
SASS_OPS = ("MUFU", "FFMA", "FMUL", "FADD", "FSEL", "SHFL", "LDS", "STS",
            "LDGSTS", "BAR")
SCAN_NS = "constexpr int NS = 2;"
SCAN_STAGES = "constexpr int STAGES = 2;"
SCAN_T = "constexpr int T = 64;"
# parts of K3's chunk left out, one at a time (timing only)
SCAN_PARTS = {
    "without_step_loads": [
        ("*reinterpret_cast<const float4*>(&s.bc[u + q][g * NS + j]);",
         "make_float4(ddx.x, ddx.y, ddx.y, ddx.x);"),
        ("const float2 ddx = s.dx[u + q][cl];",
         "const float2 ddx = make_float2(1e-3f * (u + q + t0), "
         "1e-3f * (q + 1));")],
    "without_exps": [("const float decay = exp2_approx(ddx.x * A2[j]);",
                      "const float decay = ddx.x * A2[j];")],
    "without_shuffles": [
        ("part[q] = keep + __shfl_xor_sync(FULL, send, w);",
         "part[q] = keep + send;")],
    "without_convert_pass": [
        ("      s.dx[r][q] = make_float2(d, d * to_f(st.x[r][q]));", ""),
        ("      s.bc[r][j] = make_float2(to_f(st.B[r][j]), "
         "to_f(st.C[r][j]));", "")],
    "without_y_stores": [
        ("        a.y[(row0 + t0 + r) * a.din + c0 + q] = s.y[r][q];",
         "        if (s.y[r][q] == 12345.f) a.y[0] = 1.f;")],
}
SCAN_STEP_LOOP = "#pragma unroll 1\n    for (int u = 0; u < T; u += LANES) {"


def build_variant(name: str, tag: str, edits) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``edits`` ((old, new) pairs,
    each found exactly once) applied, built and loaded."""
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
    return ctypes.CDLL(str(lib))


def attention_variant(name: str, tag: str, edits):
    """An attention variant's launch function, bound as the source's."""
    from repro_torch.kernels import build
    n_ptr, n_int = (4, 7) if name == "flash_attention" else (8, 8)
    return build.bind(build_variant(name, tag, edits), f"{name}_launch",
                      n_ptr, n_int)


def block_of(src: str, head: str) -> str:
    """The text of the block that starts at ``head`` and ends at the first
    line ``};`` after it."""
    start = src.index(head)
    return src[start:src.index("\n};\n", start) + 4]


def fleet_variants(cs) -> None:
    """K1's variants on chunks 0 and 1 of the main path's OptLinkedQ
    cell.  Each variant takes the state in its own form (``forms``),
    converted from the source's before its timed chunks and back after
    them, and its result must equal the source's."""
    import numpy as np
    import torch
    import repro_torch.kernels.fleet_step as fs
    from repro_torch.fleet import FleetConfig, build_fleet
    from repro_torch.fleet.torchexec import TorchBackend
    from repro_torch.kernels import build
    src = (build.CSRC / "fleet_step.cu").read_text()
    libs = {"source": fs._library(),
            "packed_line_byte": build_variant(
                "fleet_step", "fleet_packed",
                [(block_of(src, "struct Lines {"), PACKED_LINES)])}
    for threads in (64, 256):
        libs[f"block_{threads}"] = build_variant(
            "fleet_step", f"fleet_block{threads}",
            [(FLEET_BLOCK, f"#define BLOCK {threads}")])
    for blocks in (2, 4, 6, 8, 16):
        libs[f"blocks_per_sm_{blocks}"] = build_variant(
            "fleet_step", f"fleet_sm{blocks}",
            [(FLEET_BLOCKS_PER_SM, f"#define BLOCKS_PER_SM {blocks}")])
    for layout in ("xn", "nx"):
        libs[f"layout_{layout}"] = build_variant(
            "fleet_step", f"fleet_{layout}", layout_edits(src, layout))
    for lib in libs.values():
        lib.fleet_step_launch.argtypes = [ctypes.POINTER(fs._Args)]
        lib.fleet_step_launch.restype = ctypes.c_int
    forms = {"packed_line_byte": (pack_lines, unpack_lines),
             "layout_xn": (lambda st: relayout(st, "xn"),
                           lambda st: tiled(st, "xn")),
             "layout_nx": (lambda st: relayout(st, "nx"),
                           lambda st: tiled(st, "nx"))}

    cfg = FleetConfig(queue="OptLinkedQ", model="optane-clwb",
                      instances=cs.MAIN_INSTANCES, ops=cs.MAIN_OPS,
                      chunk=cs.CHUNK, backend="cuda", device="cuda", seed=0)
    fleet = build_fleet(cfg)
    kb = TorchBackend(fleet.template, cfg.instances, "cuda")
    kinds = [torch.as_tensor(np.ascontiguousarray(
        fleet.kinds[c * cs.CHUNK:(c + 1) * cs.CHUNK])).cuda()
        for c in range(2)]
    # the source's states before and after each chunk
    states = [{k: v.clone() for k, v in kb.st.items()}]
    for c in range(2):
        fs.fleet_step(kb.st, kinds[c], c * cs.CHUNK, kb.progs, kb.err)
        states.append({k: v.clone() for k, v in kb.st.items()})
    del kb.st
    original = fs._library, fs._check_state
    try:
        for tag in list(libs) + list(libs)[::-1]:
            fs._library = lambda lib=libs[tag]: lib
            into, back = forms.get(tag, (clone_state, dict))
            if tag.startswith("layout_"):      # shapes the wrapper refuses
                fs._check_state = lambda *a: None
            for c in range(2):
                start = into(states[c])
                st = clone_state(start)
                ms = cs.time_chunk(fs.fleet_step, st, start, kinds[c],
                                   c * cs.CHUNK, kb.progs, kb.err, REPS)
                got = back(st)
                if not all(torch.equal(got[k], states[c + 1][k])
                           for k in got):
                    raise AssertionError(f"K1 {tag} chunk {c}: the state "
                                         f"differs from the source's")
                print(f"fleet OptLinkedQ {cfg.instances} instances chunk "
                      f"{c} {tag}: ms={ms:.4f} state == source", flush=True)
                del start, st, got
                torch.cuda.empty_cache()
            fs._check_state = original[1]
    finally:
        fs._library, fs._check_state = original


def clone_state(st: dict) -> dict:
    out = {k: v.clone() for k, v in st.items()}
    return _Widths(out, st.widths) if isinstance(st, _Widths) else out


def pack_lines(st: dict) -> dict:
    """A copy of ``st`` whose ``cached`` plane holds cached | finval << 1 |
    everfl << 2."""
    out = clone_state(st)
    out["cached"] = st["cached"] | (st["finval"] << 1) | (st["everfl"] << 2)
    return out


def unpack_lines(st: dict) -> dict:
    packed = st["cached"]
    return dict(st, cached=packed & 1, finval=(packed >> 1) & 1,
                everfl=(packed >> 2) & 1)


def layout_edits(src: str, layout: str):
    """Edits that give K1 the plain instance-minor ``[X, N]`` layout
    ("xn", entry j of instance i at j N + i) or the reference's
    instance-major ``[N, X]`` ("nx", at i X + j) instead of warp tiles."""
    import re
    head = "template <typename T>\nstruct Col {"
    span = src[src.index(head):src.index(
        "template <typename T>\n__device__ __forceinline__ void reverse")]
    at = "static_cast<T*>(base) + i, n" if layout == "xn" else \
        "static_cast<T*>(base) + i * width, 1"
    helper = f"""template <typename T>
struct Col {{
  T* p;
  int64_t s;
  __device__ __forceinline__ T& operator[](int j) const {{
    return p[j * s];
  }}
}};

template <typename T>
__device__ __forceinline__ Col<T> col(void* base, int64_t i, int width,
                                      int64_t n) {{
  return Col<T>{{{at}}};
}}

"""
    calls = re.findall(r"col<\w+>\(A\.\w+, i, [\w.]+\)", src)
    return [(span, helper)] + [(c, c[:-1] + ", A.n)") for c in calls]


def relayout(st: dict, layout: str) -> dict:
    """The source's warp-tiled state in ``layout`` ("xn" or "nx"); the
    wrapper reads the widths of ``persisted`` and ``slots`` from their
    second axis, which ``_Width`` keeps."""
    from repro_torch.fleet.torchexec import from_tiles
    n = st["head"].shape[0]
    out = {}
    for k, v in st.items():
        if v.dim() == 3:
            rows = from_tiles(v, n)
            out[k] = rows if layout == "nx" else rows.t().contiguous()
        else:
            out[k] = v.clone()
    return _Widths(out, {k: st[k].shape[1] for k in ("persisted", "slots")})


def tiled(st: dict, layout: str) -> dict:
    from repro_torch.fleet.torchexec import to_tiles
    out = {}
    for k in st:
        v = dict.__getitem__(st, k)
        if v.dim() == 2:
            out[k] = to_tiles((v if layout == "nx" else v.t())
                              .contiguous())
        else:
            out[k] = v
    return out


class _Widths(dict):
    """A state dict whose ``persisted`` and ``slots`` report the source's
    width on their second axis, whatever their layout."""

    def __init__(self, st, widths):
        super().__init__(st)
        self.widths = widths

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if key in self.widths:
            return _Shaped(v, self.widths[key])
        return v

    def items(self):
        return ((k, dict.__getitem__(self, k)) for k in self)


class _Shaped:
    def __init__(self, t, width):
        self.t, self.shape = t, (0, width)

    def data_ptr(self):
        return self.t.data_ptr()

    def copy_(self, v):
        self.t.copy_(v)


def scan_variants(cs) -> None:
    """K3's variants at the prefill shape with bf16 inputs."""
    import torch
    import repro_torch.kernels.ssm_scan as ss
    from repro_torch.kernels import build
    fns = {"source": ss._kernel()}
    for tag, old, new in (("lanes_16", SCAN_NS, "constexpr int NS = 1;"),
                          ("lanes_4", SCAN_NS, "constexpr int NS = 4;"),
                          ("stages_1", SCAN_STAGES,
                           "constexpr int STAGES = 1;"),
                          ("stages_3", SCAN_STAGES,
                           "constexpr int STAGES = 3;"),
                          ("steps_unrolled_2", SCAN_STEP_LOOP,
                           SCAN_STEP_LOOP.replace("unroll 1", "unroll 2")),
                          ("chunk_32", SCAN_T, "constexpr int T = 32;"),
                          ("chunk_128", SCAN_T, "constexpr int T = 128;")):
        fns[tag] = build.bind(build_variant("ssm_scan", f"scan_{tag}",
                                            [(old, new)]),
                              "ssm_scan_launch", 7, 6)
    for op in SASS_OPS:                 # what the source compiled to
        for fn, count in build.sass_opcode_counts("ssm_scan", op).items():
            print(f"ssm_scan SASS {op} in {fn}: {count}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, S, din, ds = cs.SSM_TIMED
    args = cs.scan_inputs(gen, B, S, din, ds, "bfloat16", "cuda")
    y_ref, h_ref = ss.ssm_scan_plain(*args)
    where = f"ssm_scan B={B} S={S} din={din} ds={ds} bf16"
    original = ss._kernel
    try:
        for tag in list(fns) + list(fns)[::-1]:
            ss._kernel = lambda f=fns[tag]: f
            y, h = ss.ssm_scan(*args)
            err = max(cs.hold(y, y_ref, cs.SSM_TOL, cs.SSM_TOL, where),
                      cs.hold(h, h_ref, cs.SSM_TOL, cs.SSM_TOL, where))
            ms = cs.cuda_ms(lambda: ss.ssm_scan(*args), REPS)
            print(f"{where} {tag}: ms={ms:.4f} max_abs_err={err:.3e}",
                  flush=True)
    finally:
        ss._kernel = original
    scan_parts(cs, args, fns["source"], where)


def scan_parts(cs, args, source, where: str) -> None:
    """What each part of K3's chunk costs: the source against copies that
    leave one part out (the shared-memory loads of a step, the exps, the
    shuffles of y's reduce-scatter, the convert pass, the stores of y).
    Their results are wrong by design and not checked; only their times
    are read."""
    import repro_torch.kernels.ssm_scan as ss
    from repro_torch.kernels import build
    fns = {"source": source}
    for tag, edits in SCAN_PARTS.items():
        fns[tag] = build.bind(build_variant("ssm_scan", f"scan_{tag}",
                                            edits), "ssm_scan_launch", 7, 6)
    original = ss._kernel
    try:
        for tag in list(fns) + list(fns)[::-1]:
            ss._kernel = lambda f=fns[tag]: f
            ms = cs.cuda_ms(lambda: ss.ssm_scan(*args), REPS)
            print(f"{where} {tag}: ms={ms:.4f} (result not checked)",
                  flush=True)
    finally:
        ss._kernel = original


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

    fleet_variants(cs)
    scan_variants(cs)
    torch.cuda.empty_cache()

    flash = {"source": fa._kernel(),
             "one_bf16_p": attention_variant("flash_attention",
                                             "flash_one_p",
                                             [(FLASH_LO, "")])}
    decode = {"source": da._kernel(),
              "one_bf16_p": attention_variant("decode_attention",
                                              "decode_one_p",
                                              [(DECODE_LO, "")])}
    for stages, blocks in ((2, 3), (4, 1)):
        decode[f"stages_{stages}"] = attention_variant(
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
