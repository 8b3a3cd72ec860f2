"""Model configuration for the assigned architecture zoo.

A model is a decoder-only stack described as:
  * optional ``prefix`` layers (unstacked, e.g. DeepSeekMoE's dense layer 0),
  * a repeated ``pattern`` of sub-layer specs scanned ``n_periods`` times
    (jax.lax.scan over stacked params keeps HLO size / compile time bounded),
  * embeddings + final norm + LM head.

Each pattern element is a (mixer, ffn) pair:
  mixer ∈ {"attn", "mamba"};  ffn ∈ {"dense", "moe", "none"}.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

LayerSpec = Tuple[str, str]     # (mixer, ffn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                   # dense FFN hidden (per-expert hidden for MoE)
    vocab: int
    d_head: Optional[int] = None
    act: str = "swiglu"         # swiglu | sq_relu | geglu
    rope: str = "rope"          # rope | mrope | none
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_bias: bool = False
    qk_norm: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # apply MoE every k-th layer (jamba: 2)
    dense_ff_first: int = 0     # DeepSeekMoE: dense FFN width for layer 0
    capacity_factor: float = 1.25
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    # --- hybrid ---
    attn_every: int = 0         # jamba: one attn layer per 8 (at position 4)
    attn_position: int = 4
    # --- frontend stub (vlm/audio): inputs may be precomputed embeddings ---
    embed_stub: bool = False
    # perf knobs (hillclimb levers; see EXPERIMENTS.md §Perf)
    attn_unroll_q: bool = False   # unroll q-blocks, skip masked KV blocks
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    sub_quadratic: bool = False

    # ------------------------------------------------------------ derived --
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))

    # ------------------------------------------------------- layer pattern --
    def layer_pattern(self) -> Tuple[List[LayerSpec], int, List[LayerSpec]]:
        """Returns (prefix_specs, n_periods, period_pattern)."""
        if self.family == "ssm":
            return [], self.n_layers, [("mamba", "none")]
        if self.family == "hybrid":
            period = self.attn_every or 8
            pat: List[LayerSpec] = []
            for i in range(period):
                mixer = "attn" if i == self.attn_position else "mamba"
                ffn = "moe" if (self.n_experts and i % self.moe_every == 1) \
                    else "dense"
                pat.append((mixer, ffn))
            assert self.n_layers % period == 0
            return [], self.n_layers // period, pat
        if self.family == "moe":
            if self.dense_ff_first:
                return ([("attn", "dense_first")], self.n_layers - 1,
                        [("attn", "moe")])
            return [], self.n_layers, [("attn", "moe")]
        # dense / vlm / audio
        return [], self.n_layers, [("attn", "dense")]

    def n_params(self) -> int:
        """Total parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        prefix, periods, pat = self.layer_pattern()
        total = V * d * (1 if self.tie_embeddings else 2)
        gated = self.act in ("swiglu", "geglu")

        def ffn_params(kind: str) -> int:
            if kind == "none":
                return 0
            if kind == "dense":
                return d * dff * (3 if gated else 2)
            if kind == "dense_first":
                return d * self.dense_ff_first * (3 if gated else 2)
            per_exp = d * dff * (3 if gated else 2)
            return (self.n_experts + self.n_shared_experts) * per_exp \
                + d * self.n_experts    # router

        def mixer_params(kind: str) -> int:
            if kind == "attn":
                return d * hd * (H + 2 * KV) + H * hd * d
            din, ds, dtr = self.d_inner, self.ssm_state, self.dt_rank_
            return (d * 2 * din            # in_proj
                    + din * self.ssm_conv  # conv
                    + din * (dtr + 2 * ds) # x_proj (dt, B, C)
                    + dtr * din + din      # dt_proj, dt_bias
                    + din * ds + din       # A_log, D
                    + din * d)             # out_proj

        def norms(ff: str) -> int:
            return d if ff == "none" else 2 * d

        for (mx, ff) in prefix:
            total += mixer_params(mx) + ffn_params(ff) + norms(ff)
        for (mx, ff) in pat:
            total += periods * (mixer_params(mx) + ffn_params(ff) + norms(ff))
        total += d   # final norm
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.n_params()
        d, dff = self.d_model, self.d_ff
        gated = self.act in ("swiglu", "geglu")
        per_exp = d * dff * (3 if gated else 2)
        inactive = (self.n_experts - self.top_k) * per_exp
        _, periods, pat = self.layer_pattern()
        n_moe_layers = periods * sum(1 for (_, f) in pat if f == "moe")
        return self.n_params() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
