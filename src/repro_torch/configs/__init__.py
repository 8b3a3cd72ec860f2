"""Architecture registry: ``get_config(arch_id)`` + reduced smoke variants.

Reduced configs keep the *family shape* (same pattern: GQA ratios, MoE
expert structure, hybrid interleave) at toy width/depth so one train step
runs on a single CPU device in seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..models.config import ModelConfig, SHAPES, ShapeConfig

from .jamba_v01_52b import CONFIG as _jamba
from .command_r_plus_104b import CONFIG as _commandr
from .yi_6b import CONFIG as _yi
from .phi4_mini_3_8b import CONFIG as _phi4
from .nemotron_4_340b import CONFIG as _nemotron
from .falcon_mamba_7b import CONFIG as _falconmamba
from .qwen2_vl_72b import CONFIG as _qwen2vl
from .musicgen_medium import CONFIG as _musicgen
from .deepseek_moe_16b import CONFIG as _deepseek
from .dbrx_132b import CONFIG as _dbrx

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    _jamba, _commandr, _yi, _phi4, _nemotron, _falconmamba,
    _qwen2vl, _musicgen, _deepseek, _dbrx,
]}

# short aliases for --arch
ALIASES = {
    "jamba": "jamba-v0.1-52b",
    "command-r-plus": "command-r-plus-104b",
    "yi": "yi-6b",
    "phi4-mini": "phi4-mini-3.8b",
    "nemotron": "nemotron-4-340b",
    "falcon-mamba": "falcon-mamba-7b",
    "qwen2-vl": "qwen2-vl-72b",
    "musicgen": "musicgen-medium",
    "deepseek-moe": "deepseek-moe-16b",
    "dbrx": "dbrx-132b",
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    return ARCHS[arch]


def reduced_config(arch: str) -> ModelConfig:
    """Toy-size config of the same family for CPU smoke tests."""
    cfg = get_config(arch)
    period = cfg.attn_every or 0
    n_layers = period if cfg.family == "hybrid" else 2
    if cfg.dense_ff_first:
        n_layers = 3
    heads = 4
    kv = max(1, round(heads * cfg.n_kv_heads / cfg.n_heads)) \
        if cfg.n_heads else 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads, n_kv_heads=kv, d_head=16,
        d_ff=0 if cfg.family == "ssm" else 96,
        vocab=512,
        n_experts=min(cfg.n_experts, 8),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        dense_ff_first=128 if cfg.dense_ff_first else 0,
        dt_rank=8 if cfg.ssm_state else 0,
        # drop-free routing so decode (T=1) and teacher-forced forward agree
        capacity_factor=16.0,
        param_dtype="float32", compute_dtype="float32",
    )


def applicable_shapes(arch: str) -> List[ShapeConfig]:
    """The assigned shape set, honoring the long_500k sub-quadratic skip."""
    cfg = get_config(arch)
    shapes = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        shapes.append(SHAPES["long_500k"])
    return shapes


__all__ = ["ARCHS", "ALIASES", "get_config", "reduced_config",
           "applicable_shapes", "SHAPES"]
