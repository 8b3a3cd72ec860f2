"""Shared building blocks: norms, rotary embeddings, activations, init.

The PyTorch counterpart of ``repro.models.common``, with its casts kept:
``rms_norm`` normalises in fp32, casts back and then multiplies by the
scale in the input's dtype; rotary embeddings rotate split halves in
fp32 and cast back.  :func:`recompute` is ``jax.checkpoint`` for the
training paths.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def recompute(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``) when autograd is recording, else a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def act_fn(name: str):
    if name == "swiglu":
        return F.silu
    if name == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        return lambda x: F.relu(x).square()
    raise ValueError(name)


# ----------------------------------------------------------------- rotary --
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """rope_freqs as fp32 on ``device``, copied there once: a copy from
    host memory at every call would make the host wait for the card."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); ang (..., S, hd/2) fp32, broadcast over heads."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = _freqs_on(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., :, None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary dims are partitioned into
    (temporal, height, width) sections, each rotated by its own position
    id.  positions: (..., 3, S); x: (..., S, H, hd)."""
    hd = x.shape[-1]
    half = hd // 2
    if sections is None:
        # Qwen2-VL proportions (16,24,24)/64, scaled to the head dim
        s1 = half // 4
        s2 = (half - s1 + 1) // 2
        sections = (s1, s2, half - s1 - s2)
    assert sum(sections) == half, (sections, hd)
    freqs = _freqs_on(hd, theta, x.device)
    p = positions.movedim(-2, -1)                   # (..., S, 3)
    per_freq = torch.cat(
        [p[..., i:i + 1].expand(*p.shape[:-1], s)
         for i, s in enumerate(sections)], dim=-1)  # (..., S, half)
    return _rotate(x, per_freq.float() * freqs)


# ------------------------------------------------------------------- init --
def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """Normal(0, scale / sqrt(shape[0])) drawn in fp32 from ``gen`` and
    cast to ``dtype``; drawn on ``device`` (the generator's device by
    default)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / np.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device if device is not None else gen.device)
    return (w * std).to(dtype)
