"""The rounding of the tensor-core attention kernels, emulated on the CPU.

K2's bf16 kernel (``flash_fwd_mma_kernel``) and K4's (``decode_split_mma_kernel``)
take Q, K and V as the bf16 values they are given, unscaled; the scores
are fp32 sums of their products, scaled afterwards (folded with log2(e)
into exp2); keys come in tiles of 64 (K4: slices of 16 keys a warp, each
warp with its own online softmax, merged in the block and then across
splits); the softmax weights P enter the P V product as bf16, and P V is
summed in fp32.  The emulation below does that arithmetic in plain
PyTorch, and the tests hold it to the JAX oracles (``flash_attention_ref``,
``decode_attention_ref``) and to the port's plain versions at the bf16
tolerance that ``chip_smoke.py`` holds the kernels to (``ATTN_TOL``: rtol
2e-2, atol 1e-3).  It is not the kernels: it checks that their rounding
choices can meet that tolerance, and which cannot.  One bf16 rounding of
P cannot: near an output that cancels, its error exceeds atol.  So P goes
in as a pair of bf16, hi = bf16(p) and lo = bf16(p - hi), in two products.

Inputs are made with numpy from a seed.  Causal tiles past the diagonal,
which the kernel does not visit, are visited here fully masked: that
leaves m, l and the sum exactly as they were.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.build import parse_sass_counts  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    BLOCK_K, decode_attention_plain, split_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)

TOL = dict(rtol=2e-2, atol=1e-3)      # chip_smoke.py ATTN_TOL["bfloat16"]
LOG2E = math.log2(math.e)
WARPS, WARP_KEYS = 4, 16              # K4: a warp's keys of each step
NEG_INF = -math.inf


def _exp2_diff(a, m, sl2):
    """exp2(a sl2 - offset) with the kernels' offset, m sl2, or 0 where
    the running max m is -inf: 0 for a masked score a = -inf."""
    offset = torch.where(m == NEG_INF, 0.0, m * sl2)
    return torch.exp2(a * sl2 - offset)


def _weights(p, split: bool):
    """P as the P V product sees it: bf16 hi, plus bf16 lo if split."""
    hi = p.bfloat16().float()
    return hi + (p - hi).bfloat16().float() if split else hi


def emulate_flash(q, k, v, causal: bool, split: bool = True):
    """bf16 q (B, S, H, hd), k, v (B, S, KV, hd) -> bf16 (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    sl2 = LOG2E / math.sqrt(hd)
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    m = torch.full((B, KV, H // KV, S), NEG_INF)
    l = torch.zeros(m.shape)
    acc = torch.zeros(m.shape + (hd,))
    rows = torch.arange(S)
    for k0 in range(0, S, BLOCK_K):
        cols = torch.arange(k0, min(k0 + BLOCK_K, S))
        s = torch.einsum("bskgh,btkh->bkgst", qf, k[:, cols].float())
        if causal:
            s = s.masked_fill(cols[None, :] > rows[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = _exp2_diff(m, m_new, sl2)
        p = _exp2_diff(s, m_new[..., None], sl2)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", _weights(p, split), v[:, cols].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).bfloat16()


def emulate_decode(q, k, v, lengths, split: bool = True, sm_count=132):
    """bf16 q (B, H, hd), k, v (B, S, KV, hd), lengths (B,) -> bf16
    (B, H, hd), split as ``split_plan`` splits it on ``sm_count`` SMs."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1 / math.sqrt(hd)
    sl2 = scale * LOG2E
    n_splits, split_len = split_plan(B, S, KV, sm_count)
    qf = q.float().reshape(B, KV, G, hd)
    lens = lengths.long().clamp(max=S)
    o_part = torch.zeros(B, KV, n_splits, G, hd)
    m_part = torch.full((B, KV, n_splits, G), NEG_INF)
    l_part = torch.zeros(B, KV, n_splits, G)
    for sp in range(n_splits):
        start = sp * split_len
        end = torch.clamp(lens, max=start + split_len)      # (B,)
        m = torch.full((WARPS, B, KV, G), NEG_INF)
        l = torch.zeros(m.shape)
        acc = torch.zeros(m.shape + (hd,))
        for t0 in range(start, min(start + split_len, S), BLOCK_K):
            for w in range(WARPS):
                lo = t0 + w * WARP_KEYS
                hi = min(lo + WARP_KEYS, S)
                if lo >= hi:
                    continue
                cols = torch.arange(lo, hi)
                s = torch.einsum("bkgh,btkh->bkgt", qf, k[:, cols].float())
                s = s.masked_fill((cols[None, :] >= end[:, None])
                                  [:, None, None, :], NEG_INF)
                m_new = torch.maximum(m[w], s.amax(-1))
                alpha = _exp2_diff(m[w], m_new, sl2)
                p = _exp2_diff(s, m_new[..., None], sl2)
                l[w] = l[w] * alpha + p.sum(-1)
                acc[w] = acc[w] * alpha[..., None] + torch.einsum(
                    "bkgt,btkh->bkgh", _weights(p, split), v[:, cols].float())
                m[w] = m_new
        # the block's merge of its warps, m in units of scaled scores
        m_s = torch.where(m == NEG_INF, NEG_INF, m * scale)
        m_max = m_s.amax(0)
        alpha = torch.where(m_s == NEG_INF, 0.0, torch.exp(m_s - m_max))
        o_part[:, :, sp] = (acc * alpha[..., None]).sum(0)
        l_part[:, :, sp] = (l * alpha).sum(0)
        m_part[:, :, sp] = m_max
    # the merge kernel across splits
    m_max = m_part.amax(2, keepdim=True)
    alpha = torch.where(m_part == NEG_INF, 0.0, torch.exp(m_part - m_max))
    out = (o_part * alpha[..., None]).sum(2) / \
        (l_part * alpha).sum(2).clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).bfloat16()


def _inputs(seed, *shapes):
    """numpy normals -> (jax bf16, torch bf16) pairs of the same values."""
    rng = np.random.RandomState(seed)
    out = []
    for shape in shapes:
        a = rng.randn(*shape).astype(np.float32)
        out.append((jnp.asarray(a, jnp.bfloat16),
                    torch.from_numpy(a).bfloat16()))
    return out


def _close(out, ref):
    """``out`` (torch) within TOL of ``ref`` (a jax array or a tensor)."""
    if isinstance(ref, torch.Tensor):
        ref = ref.float().numpy()
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


def _misses(out, ref) -> int:
    out, ref = out.float(), ref.float()
    return int(((out - ref).abs() >
                TOL["atol"] + TOL["rtol"] * ref.abs()).sum())


# ---------------------------------------------------------- flash attention
FLASH_SHAPES = [   # (B, S, H, KV, hd, causal)
    (2, 256, 4, 4, 64, True),     # the shapes of tests/test_torch_attention.py
    (2, 512, 8, 2, 64, True),
    (1, 1024, 8, 1, 128, True),
    (3, 384, 6, 2, 32, True),
    (2, 256, 4, 2, 64, False),
    (2, 200, 4, 2, 32, True),
    (1, 77, 8, 2, 64, False),
    # S at and around the 16-row and 64-key tiles; G = 1, 3 and 16
    (2, 1, 2, 2, 128, True), (2, 1, 6, 2, 64, False),
    (1, 15, 32, 2, 128, True), (1, 15, 2, 2, 16, False),
    (2, 17, 6, 2, 128, True), (1, 17, 32, 2, 64, False),
    (1, 63, 2, 2, 128, True), (2, 63, 6, 2, 32, False),
    (1, 65, 32, 2, 128, True), (2, 65, 2, 2, 64, False),
]


@pytest.mark.parametrize("B,S,H,KV,hd,causal", FLASH_SHAPES)
def test_flash_tile_rounding_meets_the_bf16_tolerance(B, S, H, KV, hd,
                                                      causal):
    (q, tq), (k, tk), (v, tv) = _inputs(B * 1000 + S + H, (B, S, H, hd),
                                        (B, S, KV, hd), (B, S, KV, hd))
    out = emulate_flash(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    _close(out, flash_attention_ref(q, k, v, causal=causal))
    _close(out, flash_attention_plain(tq, tk, tv, causal=causal))


# ----------------------------------------------------------- decode attention
DECODE_SHAPES = [  # (B, S, H, KV, hd, lengths or None = random)
    (2, 1024, 8, 2, 64, None),    # the shapes of tests/test_torch_attention.py
    (4, 512, 4, 4, 64, None),
    (1, 2048, 8, 1, 128, None),
    (3, 300, 8, 4, 32, None),
    # lengths at and around a warp's 16 keys and a step's 64; G = 1, 3, 16
    (5, 100, 2, 2, 128, [1, 15, 17, 63, 65]),
    (5, 100, 6, 2, 128, [1, 15, 17, 63, 65]),
    (5, 100, 32, 2, 128, [1, 15, 17, 63, 65]),
    (2, 1, 32, 2, 64, [1, 1]),                   # S = 1
]


@pytest.mark.parametrize("B,S,H,KV,hd,lens", DECODE_SHAPES)
def test_decode_tile_rounding_meets_the_bf16_tolerance(B, S, H, KV, hd,
                                                       lens):
    (q, tq), (k, tk), (v, tv) = _inputs(B * 100 + S + H, (B, H, hd),
                                        (B, S, KV, hd), (B, S, KV, hd))
    lens = np.asarray(lens if lens else
                      np.random.RandomState(S).randint(1, S + 1, (B,)),
                      np.int32)
    tl = torch.from_numpy(lens)
    out = emulate_decode(tq, tk, tv, tl)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    _close(out, decode_attention_ref(q, k, v, jnp.asarray(lens)))
    _close(out, decode_attention_plain(tq, tk, tv, tl))


# ------------------------------------------------- why P goes in as hi + lo
def test_one_bf16_rounding_of_p_misses_the_tolerance():
    """P rounded once to bf16 (the usual flash attention design) misses
    atol 1e-3 where an output cancels; hi + lo meets it on the same
    inputs.  Flash at a JAX test shape; decode at the smoke serving cell's
    short lengths (1-11 of 64 keys), where a row's weights are largest."""
    B, S, H, KV, hd = 1, 1024, 8, 1, 128
    (_, tq), (_, tk), (_, tv) = _inputs(7, (B, S, H, hd), (B, S, KV, hd),
                                        (B, S, KV, hd))
    ref = flash_attention_plain(tq, tk, tv)
    assert _misses(emulate_flash(tq, tk, tv, True, split=False), ref) > 0
    assert _misses(emulate_flash(tq, tk, tv, True, split=True), ref) == 0
    B, S, H, KV = 16, 64, 32, 4
    (_, tq), (_, tk), (_, tv) = _inputs(8, (B, H, hd), (B, S, KV, hd),
                                        (B, S, KV, hd))
    lens = torch.from_numpy(
        np.random.RandomState(0).randint(1, 12, (B,)).astype(np.int32))
    ref = decode_attention_plain(tq, tk, tv, lens)
    assert _misses(emulate_decode(tq, tk, tv, lens, split=False), ref) > 0
    assert _misses(emulate_decode(tq, tk, tv, lens, split=True), ref) == 0


# ------------------------------------------------------------- the HMMA check
def test_sass_counts_read_hmma_per_function():
    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi128E",
        "        /*0a30*/   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;",
        "        /*0a40*/   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;",
        "        /*0a50*/   FFMA R1, R2, R3, R4 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128E",
        "        /*0a50*/   FFMA R1, R2, R3, R4 ;",
        "        /*0a60*/   MOV R5, R6 ;   // HMMAX is not HMMA",
    ])
    assert parse_sass_counts(sass, "HMMA") == {
        "_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi128E": 2,
        "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128E": 0}
    assert parse_sass_counts("", "HMMA") == {}
