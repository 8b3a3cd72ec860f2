"""Step functions and input specs for the train, prefill and serve cells.

The PyTorch counterparts of ``repro.launch.steps``: ``opt_config``,
``accum_steps``, ``input_specs`` (meta tensors, where the JAX package
returns ``ShapeDtypeStruct``s) and the train, prefill and serve steps.
The train step runs the model's plain paths (``use_kernels=False``: the
chunked attention and scan), as the JAX package's runs
``use_pallas=False``: the kernels have no backward.  The sharding hooks
(``constrain``, ``grad_shardings``) come with the sharding slice.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..models import forward, loss_fn, serve_step
from ..models.config import ModelConfig, ShapeConfig
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import tree_leaves, tree_map


def opt_config(cfg: ModelConfig) -> AdamWConfig:
    """int8-quantized AdamW state for the largest models (>= 200B
    params)."""
    big = cfg.n_params() > 200e9
    return AdamWConfig(state_dtype="int8" if big else "float32")


def accum_steps(cfg: ModelConfig, shape: ShapeConfig, n_data_shards: int,
                seq_shard: bool, budget_bytes: float = 2.5e9) -> int:
    """Gradient-accumulation factor bounding the saved activations a
    device holds: the residual stream carried between periods,
    (B/dp/accum, S[, /tp], D) bf16 x n_periods; SSM/hybrid configs also
    bound the selective scan's (B_mb, chunk, d_inner, ds) fp32 blocks."""
    _, periods, _ = cfg.layer_pattern()
    per_seq = shape.seq_len * cfg.d_model * 2
    if seq_shard:
        per_seq = per_seq / 16
    b_shard = max(1, shape.global_batch // n_data_shards)
    total = b_shard * per_seq * periods
    accum = max(1, int(math.ceil(total / budget_bytes)))
    if cfg.ssm_state:
        # keep ~3 live (B_mb, 128, din, ds) fp32 scan blocks under budget
        per_b = 3 * 128 * cfg.d_inner * cfg.ssm_state * 4
        accum = max(accum, int(math.ceil(b_shard * per_b / budget_bytes)))
    # accum must divide the per-shard batch
    while b_shard % accum and accum < b_shard:
        accum += 1
    return min(accum, b_shard)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """The batch of a cell as meta tensors (shapes and dtypes, no data)."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.embed_stub:
            return {"embeds": spec((B, S, cfg.d_model), torch.bfloat16),
                    "labels": spec((B, S))}
        return {"tokens": spec((B, S)), "labels": spec((B, S))}
    if shape.kind == "prefill":
        if cfg.embed_stub:
            return {"embeds": spec((B, S, cfg.d_model), torch.bfloat16)}
        return {"tokens": spec((B, S))}
    # decode: one new token against a cache of S
    if cfg.embed_stub:
        batch = {"embeds": spec((B, 1, cfg.d_model), torch.bfloat16)}
    else:
        batch = {"tokens": spec((B, 1))}
    batch["position"] = spec((B,))
    return batch


# ------------------------------------------------------------------- steps --
def make_train_step(cfg: ModelConfig, accum: int = 1,
                    use_kernels: bool = False,
                    remat_policy: str = "nothing",
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """-> ``train_step(params, opt_state, batch)`` -> (new params, new
    state, metrics with "loss", "grad_norm" and "lr").  With ``accum`` >
    1 the batch is split into that many micro-batches along its first
    axis, their gradients summed in ``accum_dtype`` (bf16 where the JAX
    dry run takes it, above 200B parameters) and averaged, as the JAX
    package's ``lax.scan`` does.  The metrics stay on the device.
    ``use_kernels=True`` runs the kernels' plain versions on CPU tensors,
    with autograd through them, and raises on CUDA tensors: the kernels
    have no backward."""
    ocfg = opt_config(cfg)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            loss = loss_fn(cfg, live, batch, use_kernels, remat_policy)
            # a leaf the loss does not reach (the embedding under
            # "embeds") gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            mbs = [{k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                    [i] for k, v in batch.items()} for i in range(accum)]
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                  device=p.device), params)
            lsum = 0.0
            for mb in mbs:
                loss, g = value_and_grad(params, mb)
                tree_map(lambda a, b: a.add_(b.to(accum_dtype)), gsum, g)
                lsum = lsum + loss
                del g
            grads = tree_map(lambda g: g.div_(accum), gsum)
            loss = lsum / accum
        new_params, new_opt, metrics = adamw_update(ocfg, params, grads,
                                                    opt_state)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, use_kernels: bool = True
                      ) -> Callable:
    def prefill_step(params, batch):
        return forward(cfg, params, batch, use_kernels,
                       remat_policy="none_inference")[:, -1]
    return prefill_step


def make_serve_step(cfg: ModelConfig, use_kernels: bool = True) -> Callable:
    def step(params, cache, batch):
        position = batch["position"]
        toks = {k: v for k, v in batch.items() if k != "position"}
        return serve_step(cfg, params, cache, toks, position, use_kernels)
    return step
