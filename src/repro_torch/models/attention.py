"""GQA attention: the training/prefill path and the one-token decode path.

The PyTorch counterpart of ``repro.models.attention``.  ``use_kernels``
plays the role of ``use_pallas``: True (the default) calls the kernel
wrappers, which launch the CUDA kernels on CUDA tensors and run their plain
versions on CPU tensors; False takes the JAX package's plain paths:
:func:`causal_attention_chunked` (online softmax over K/V blocks, each
step and each query block recomputed in the backward pass) for the full
sequence, the plain decode version for one token.  The kernels have no
backward, so training takes ``use_kernels=False``, as the JAX package's
train step takes ``use_pallas=False``.  The kernels and their plain
versions compute the softmax weights and P V in fp32; the chunked path
casts the weights to the value dtype first, as the JAX package's does,
which differs in bf16 only.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels.decode_attention import decode_attention, \
    decode_attention_plain
from ..kernels.flash_attention import flash_attention
from .common import (apply_mrope, apply_rope, dense_init, recompute,
                     rms_norm)
from .config import ModelConfig

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> dict:
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (d, H * hd), dt, device=device),
        "wk": dense_init(gen, (d, KV * hd), dt, device=device),
        "wv": dense_init(gen, (d, KV * hd), dt, device=device),
        "wo": dense_init(gen, (H * hd, d), dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=p["wq"].device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=p["wq"].device)
    return p


def _rope(cfg: ModelConfig, x, positions):
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        # text-only stub: all three section position ids coincide
        pos3 = positions[..., None, :].expand(
            *positions.shape[:-1], 3, positions.shape[-1])
        return apply_mrope(x, pos3, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def _qkv(cfg: ModelConfig, params, x, positions):
    B, S, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    return q, k, v


def causal_attention_reference(q, k, v, n_kv_groups: int) -> torch.Tensor:
    """O(S^2) einsum attention: the oracle and the short-sequence path.
    q (B, S, H, hd); k, v (B, S, KV, hd); H = KV * n_kv_groups.  The JAX
    package's, kept beside ``kernels.flash_attention_plain`` because it
    takes the scores' product in the inputs' dtype and casts the softmax
    weights to v's before P V, as the chunked path does; the plain version
    computes in fp32 throughout.  The two agree in fp32."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, n_kv_groups, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def _kv_step(m, l, acc, q_i, k_j, v_j, diagonal: bool):
    """One K/V block of the online softmax: (m, l, acc) fp32 running max,
    sum and output of the query block ``q_i`` (B, blk, KV, G, hd)."""
    blk = q_i.shape[1]
    scale = 1.0 / math.sqrt(q_i.shape[-1])
    s = (torch.einsum("bqkgh,btkh->bkgqt", q_i, k_j) * scale).float()
    if diagonal:        # the blocks below the diagonal are not masked
        mask = torch.ones((blk, blk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgqt,btkh->bkgqh", p.to(v_j.dtype), v_j)
    return m_new, l_new, acc_new


def _q_block(qi: int, q_i, kb, vb):
    """Query block ``qi`` against K/V blocks 0..qi -> (B, KV, G, blk, hd).
    The blocks past the diagonal, fully masked, would leave (m, l, acc) as
    they are, so they are not visited."""
    B, blk, KV, G, hd = q_i.shape
    f32 = dict(dtype=torch.float32, device=q_i.device)
    m = torch.full((B, KV, G, blk), NEG_INF, **f32)
    l = torch.zeros((B, KV, G, blk), **f32)
    acc = torch.zeros((B, KV, G, blk, hd), **f32)
    for j in range(qi + 1):
        m, l, acc = recompute(_kv_step, m, l, acc, q_i, kb[:, j], vb[:, j],
                              j == qi)
    return acc / l.clamp_min(1e-30)[..., None]


def causal_attention_chunked(q, k, v, n_kv_groups: int,
                             block: int = 1024) -> torch.Tensor:
    """Flash-style chunked causal attention (online softmax over K/V
    blocks), memory O(B S block): the reference path for S <= 2 block;
    above, the query blocks one after another, each step of a block and
    each block recomputed in the backward pass."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if S <= 2 * block:
        return causal_attention_reference(q, k, v, n_kv_groups)
    assert S % block == 0
    nb = S // block
    qg = q.reshape(B, nb, block, KV, n_kv_groups, hd)
    kb = k.reshape(B, nb, block, KV, hd)
    vb = v.reshape(B, nb, block, KV, hd)
    outs = [recompute(_q_block, qi, qg[:, qi], kb, vb) for qi in range(nb)]
    out = torch.stack(outs, dim=1)              # (B, nb, KV, G, blk, hd)
    out = out.movedim(-2, 2)                    # (B, nb, blk, KV, G, hd)
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention_block(cfg: ModelConfig, params, x, positions,
                    use_kernels: bool = True) -> torch.Tensor:
    """Full training/prefill causal attention sub-layer (no cache)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, params, x, positions)
    if use_kernels:
        out = flash_attention(q, k, v, causal=True)
    else:
        out = causal_attention_chunked(q, k, v,
                                       cfg.n_heads // cfg.n_kv_heads)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]


# ------------------------------------------------------------------ decode --
def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device=None) -> dict:
    dt = getattr(torch, cfg.compute_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention_block(cfg: ModelConfig, params, x, cache: dict,
                           position: torch.Tensor,
                           use_kernels: bool = True
                           ) -> Tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d); cache holds max_len KV; position (B,)
    int32 is the index of the new token.  Returns (out (B, 1, d), cache).

    Unlike the JAX version, which returns a new cache, this writes the new
    token's K and V into ``cache`` in place, at ``position``, and returns
    the same dict."""
    B = x.shape[0]
    hd, H = cfg.head_dim, cfg.n_heads
    q, k, v = _qkv(cfg, params, x, position[:, None])
    rows = torch.arange(B, device=x.device)
    pos = position.long()
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    attend = decode_attention if use_kernels else decode_attention_plain
    out = attend(q[:, 0], cache["k"], cache["v"],
                 (position + 1).to(torch.int32))
    return out.reshape(B, 1, H * hd) @ params["wo"], cache
