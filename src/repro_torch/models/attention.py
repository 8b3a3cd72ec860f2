"""GQA attention: the training/prefill path and the one-token decode path.

The PyTorch counterpart of ``repro.models.attention``.  ``use_kernels``
plays the role of ``use_pallas``: True (the default) calls the kernel
wrappers, which launch the CUDA kernels on CUDA tensors and run their plain
versions on CPU tensors; False calls the plain versions directly, even on
CUDA tensors (tests and ``chip_smoke.py`` use it to hold the kernels to
them).  Both paths compute the softmax weights and P V in fp32, as the JAX
kernels and their oracles do; the JAX package's own plain paths cast the
weights to the value dtype first, which differs from this in bf16 only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.decode_attention import decode_attention, \
    decode_attention_plain
from ..kernels.flash_attention import flash_attention, flash_attention_plain
from .common import apply_mrope, apply_rope, dense_init, rms_norm
from .config import ModelConfig


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


def attention_block(cfg: ModelConfig, params, x, positions,
                    use_kernels: bool = True) -> torch.Tensor:
    """Full training/prefill causal attention sub-layer (no cache)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, params, x, positions)
    attend = flash_attention if use_kernels else flash_attention_plain
    out = attend(q, k, v, causal=True)
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
