"""Layer composition: (mixer, ffn) sub-layer pairs with pre-RMSNorm.

The PyTorch counterpart of ``repro.models.blocks``: attention or mamba
mixers, and dense, DeepSeekMoE's wider ``dense_first`` or MoE FFNs.
``use_kernels`` is the JAX package's ``use_pallas``: True runs the kernel
wrappers, False the chunked training paths.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .attention import (attention_block, decode_attention_block,
                        init_attention, init_attn_cache)
from .common import act_fn, dense_init, rms_norm
from .config import LayerSpec, ModelConfig
from .mamba import (init_mamba, init_mamba_cache, mamba_block,
                    mamba_decode_step)
from .moe import init_moe, moe_ffn


def init_dense_ffn(cfg: ModelConfig, gen: torch.Generator, d_ff: int,
                   device=None) -> dict:
    d = cfg.d_model
    dt = getattr(torch, cfg.param_dtype)
    p = {"w1": dense_init(gen, (d, d_ff), dt, device=device),
         "w2": dense_init(gen, (d_ff, d), dt, device=device)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, (d, d_ff), dt, device=device)
    return p


def dense_ffn(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = x @ params["w1"]
    if cfg.act in ("swiglu", "geglu"):
        h = act(h) * (x @ params["w3"])
    else:
        h = act(h)
    return h @ params["w2"]


def init_layer(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator,
               device=None) -> dict:
    mixer, ffn = spec
    dt = getattr(torch, cfg.param_dtype)
    p = {"norm1": torch.ones((cfg.d_model,), dtype=dt, device=device),
         "mixer": (init_attention(cfg, gen, device) if mixer == "attn"
                   else init_mamba(cfg, gen, device))}
    if ffn != "none":
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        if ffn == "moe":
            p["ffn"] = init_moe(cfg, gen, device)
        else:
            width = cfg.dense_ff_first if ffn == "dense_first" else cfg.d_ff
            p["ffn"] = init_dense_ffn(cfg, gen, width, device)
    return p


def _ffn(cfg: ModelConfig, spec: LayerSpec, params, x):
    if spec[1] != "none":
        ffn = moe_ffn if spec[1] == "moe" else dense_ffn
        x = x + ffn(cfg, params["ffn"],
                    rms_norm(x, params["norm2"], cfg.norm_eps))
    return x


def apply_layer(cfg: ModelConfig, spec: LayerSpec, params, x, positions,
                use_kernels: bool = True) -> torch.Tensor:
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if spec[0] == "attn":
        h = attention_block(cfg, params["mixer"], h, positions, use_kernels)
    else:
        h = mamba_block(cfg, params["mixer"], h, use_kernels)
    return _ffn(cfg, spec, params, x + h)


# ------------------------------------------------------------------ decode --
def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device=None) -> dict:
    if spec[0] == "attn":
        return init_attn_cache(cfg, batch, max_len, device)
    return init_mamba_cache(cfg, batch, device)


def apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, params, x, cache,
                       position, use_kernels: bool = True
                       ) -> Tuple[torch.Tensor, dict]:
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if spec[0] == "attn":
        h, cache = decode_attention_block(cfg, params["mixer"], h, cache,
                                          position, use_kernels)
    else:
        h, cache = mamba_decode_step(cfg, params["mixer"], h, cache)
    return _ffn(cfg, spec, params, x + h), cache
