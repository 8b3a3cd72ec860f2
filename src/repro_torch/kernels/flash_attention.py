"""Causal or non-causal GQA attention forward: a CUDA kernel and its plain
version.

``q`` (B, S, H, hd) attends to ``k``/``v`` (B, S, KV, hd); the G = H / KV
query heads of a group share one kv head.  Scores and softmax are fp32,
the output is cast to q's dtype -- the semantics of ``flash_attention_ref``
in the JAX package.

This replaces the Pallas kernel ``flash_attention_kernel`` in
``src/repro/kernels/flash_attention/kernel.py`` (online softmax over K/V
tiles, stopping at the causal diagonal).  Two implementations of one
function live here:

* :func:`flash_attention_plain` -- einsum, mask, softmax, einsum, in
  fp32.  The CPU tests hold it to the JAX oracle, and ``chip_smoke.py``
  holds the kernel to it on the card.
* the CUDA kernel in ``src/repro_torch/csrc/flash_attention.cu`` (one
  block per batch row, query head and 64-query tile), built at first use
  (:mod:`.build`).

:func:`flash_attention` is the wrapper: the plain version for CPU tensors,
the kernel for CUDA tensors, no other path.  The kernel takes fp32 and
bf16, head_dim 16, 32, 64, 128 or 192 and any S; anything else raises.
It has no backward: on a CUDA input that requires grad, with grad
enabled, it raises (training takes ``causal_attention_chunked``).
"""
from __future__ import annotations

import functools
import math

import torch

from .build import bind, check, load_library, refuse_grad

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 192)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, S, KV, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous, "
                             f"16-byte aligned and on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of float32 or "
                         f"bfloat16")
    if hd not in HEAD_DIMS or B * H > 65535:
        raise ValueError(f"flash_attention: head_dim {hd}, B * H {B * H}; "
                         f"the kernel takes head_dim in {HEAD_DIMS} and "
                         f"B * H <= 65535")


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind(load_library("flash_attention"), "flash_attention_launch",
                4, 7)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    refuse_grad("flash_attention", (q, k, v),
                "use_kernels=False (models.attention."
                "causal_attention_chunked)")
    _check(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   stream, DTYPES[q.dtype], B, S, H, k.shape[2], hd,
                   int(causal))
    check(rc, "flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    ``flash_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no implementation for "
                         f"{q.device}")
    out = _launch(q, k, v, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
