"""CausalLM: init / forward / loss / decode over the layer stack.

The PyTorch counterpart of ``repro.models.model``.  Parameters are dicts
of tensors under the JAX names, but the layers are a flat list
(``params["layers"]``, prefix layers first, then period by period)
instead of the JAX package's ``prefix`` list plus ``stack`` of period
parameters stacked on a leading axis: PyTorch runs the layers in a Python
loop, so nothing needs stacking.  The cache is a list of per-layer dicts
in the same order -- ``{"k", "v"}`` for an attention layer, ``{"h",
"conv"}`` for a mamba layer -- updated in place by :func:`serve_step`.

Remat, where the JAX package wraps its scan body in ``jax.checkpoint``:
``remat_policy`` "nothing" recomputes each period of layers in the
backward pass (``torch.utils.checkpoint``), "dots" keeps the outputs of
its 2-D matrix products and recomputes the rest (selective checkpointing,
as ``dots_with_no_batch_dims_saveable``), "none_inference" keeps
everything.  Remat applies only while autograd records.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .blocks import (apply_layer, apply_layer_decode, init_layer,
                     init_layer_cache)
from .common import dense_init, rms_norm
from .config import LayerSpec, ModelConfig


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The spec of every layer, in the order of ``params["layers"]``."""
    prefix, periods, pattern = cfg.layer_pattern()
    return list(prefix) + list(pattern) * periods


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> dict:
    """Random parameters drawn from ``gen`` on ``device`` (the generator's
    device by default): at full width, pass a CUDA generator so the draws
    happen on the card."""
    device = device if device is not None else gen.device
    dt = getattr(torch, cfg.param_dtype)
    params: Dict[str, object] = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dt, 1.0, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                       device=device)
    params["layers"] = [init_layer(cfg, spec, gen, device)
                        for spec in layer_specs(cfg)]
    return params


def _embed(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"]
    return params["embed"][batch["tokens"]]


def _lm_head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy: keep 2-D matrix products (no batch
    dims), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str, fn, x):
    if policy == "none_inference" or not torch.is_grad_enabled():
        return fn(x)
    if policy == "nothing":
        return checkpoint(fn, x, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, x, use_reentrant=False, context_fn=functools
                          .partial(create_selective_checkpoint_contexts,
                                   _save_dots))
    raise ValueError(f"remat_policy {policy!r}")


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            use_kernels: bool = True,
            remat_policy: str = "nothing") -> torch.Tensor:
    """batch has "tokens" (B, S) or "embeds" (B, S, d) -> logits
    (B, S, V)."""
    x = _embed(params, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    prefix, periods, pattern = cfg.layer_pattern()
    specs, layers = layer_specs(cfg), params["layers"]
    for spec, lp in zip(specs[:len(prefix)], layers[:len(prefix)]):
        x = apply_layer(cfg, spec, lp, x, positions, use_kernels)
    for p in range(periods):
        first = len(prefix) + p * len(pattern)
        period = list(zip(pattern, layers[first:first + len(pattern)]))

        def body(h, period=period):
            for spec, lp in period:
                h = apply_layer(cfg, spec, lp, h, positions, use_kernels)
            return h

        x = _remat(remat_policy, body, x)
    return _lm_head(cfg, params, x)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            use_kernels: bool = False,
            remat_policy: str = "nothing") -> torch.Tensor:
    """Mean next-token cross entropy over batch["labels"] (B, S): fp32
    logits, logsumexp minus the gold logit."""
    logits = forward(cfg, params, batch, use_kernels, remat_policy).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])
    return (logz - gold[..., 0]).mean()


# ------------------------------------------------------------------ decode --
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> List[dict]:
    return [init_layer_cache(cfg, spec, batch, max_len, device)
            for spec in layer_specs(cfg)]


def serve_step(cfg: ModelConfig, params, cache: List[dict],
               batch: Dict[str, torch.Tensor], position: torch.Tensor,
               use_kernels: bool = True
               ) -> Tuple[torch.Tensor, List[dict]]:
    """One decode step: batch has "tokens" (B, 1) (or "embeds" (B, 1, d));
    position (B,) int32 is the write index.  Returns (logits (B, V),
    cache), the cache updated in place."""
    x = _embed(params, batch)
    for spec, lp, lc in zip(layer_specs(cfg), params["layers"], cache):
        x, _ = apply_layer_decode(cfg, spec, lp, x, lc, position, use_kernels)
    return _lm_head(cfg, params, x)[:, 0], cache
