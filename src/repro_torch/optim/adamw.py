"""AdamW with optional block-wise int8 state quantization.

The PyTorch counterpart of ``repro.optim.adamw``: a global-norm clip, a
warmup-then-cosine schedule, fp32 moments, or (``state_dtype="int8"``)
moments kept as int8 blocks of 128 with an fp32 absmax scale each, which
cuts optimizer memory 4x.  Functions over the port's parameter trees
(dicts and lists of tensors); the step counter and the schedule stay on
the parameters' device, so an update never waits for the host.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

PyTree = Any
BLOCK = 128


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # float32 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000


def tree_leaves(tree: PyTree) -> list:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; a dict leaf of ``rest`` (an int8 state) is
    passed whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise int8 quantization along the flattened tensor; the values
    round half to even, as ``jnp.round``."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / scale.clamp_min(1e-12)).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def _sched(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(cfg: AdamWConfig, params: PyTree) -> PyTree:
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.state_dtype == "int8":
            q, s = _q8(z)
            return {"q": q, "s": s}
        return z
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"step": step, "m": tree_map(zero_like, params),
            "v": tree_map(zero_like, params)}


def adamw_update(cfg: AdamWConfig, params: PyTree, grads: PyTree,
                 state: PyTree) -> Tuple[PyTree, PyTree, dict]:
    """-> (new params, new state, {"grad_norm", "lr"}), the new tensors
    fresh (the inputs are left as they are)."""
    step = state["step"] + 1
    gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
    for g in tree_leaves(grads):           # the global-norm clip
        gnorm = gnorm + g.float().square().sum()
    gnorm = gnorm.sqrt()
    scale = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
    lr = _sched(cfg, step)
    c1 = 1 - torch.pow(cfg.b1, step.float())
    c2 = 1 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        if cfg.state_dtype == "int8":
            m = _dq8(m["q"], m["s"], p.shape)
            v = _dq8(v["q"], v["s"], p.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        if cfg.state_dtype == "int8":
            mq, ms = _q8(m)
            vq, vs = _q8(v)
            return p_new, {"q": mq, "s": ms}, {"q": vq, "s": vs}
        return p_new, m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (_pick(out, i) for i in range(3))
    return new_p, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}


def _pick(tree: PyTree, i: int) -> PyTree:
    """Element ``i`` of every (params, m, v) tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
