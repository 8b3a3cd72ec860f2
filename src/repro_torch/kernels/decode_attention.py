"""Single-token GQA decode attention over a KV cache: a CUDA kernel and its
plain version.

``q`` (B, H, hd) is one new query token per sequence; ``k``/``v``
(B, S, KV, hd) is the cache; ``lengths`` (B,) int32 is the number of
valid positions of each sequence (the rest is masked out).  Scores and
softmax are fp32, the output is cast to q's dtype -- the semantics of
``decode_attention_ref`` in the JAX package.

This replaces the Pallas kernel ``decode_attention_kernel`` in
``src/repro/kernels/decode_attention/kernel.py`` (split-K flash decoding
with a renormalized merge across splits).  Two implementations of one
function live here:

* :func:`decode_attention_plain` -- einsum, mask, softmax, einsum, in
  fp32.  The CPU tests hold it to the JAX oracle, and ``chip_smoke.py``
  holds the kernel to it on the card.
* the CUDA kernel in ``src/repro_torch/csrc/decode_attention.cu`` (one
  block per batch row, kv head and split of the cache, then a merge
  kernel), built at first use (:mod:`.build`).

:func:`decode_attention` is the wrapper: the plain version for CPU
tensors, the kernel for CUDA tensors, no other path.  The kernel takes
fp32 and bf16, head_dim 16, 32, 64, 128 or 192, 1 to 16 query heads per
kv head, any S, and lengths in [1, S]; anything else raises.  It has no
backward: on a CUDA input that requires grad, with grad enabled, it
raises.
"""
from __future__ import annotations

import functools
import math

import torch

from .build import bind, check, load_library, refuse_grad

NEG_INF = -1e30
BLOCK_K = 64                # keys per tile of the kernel
HEAD_DIMS = (16, 32, 64, 128, 192)
MAX_GROUP = 16              # query heads per kv head
BLOCKS_PER_SM = 8           # split target of the grid
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); k, v (B, S, KV, hd); lengths (B,) -> (B, H, hd)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, S: int, KV: int, sm_count: int):
    """-> (n_splits, split_len): enough (batch, kv head, split) blocks for
    about BLOCKS_PER_SM per SM, each split a whole number of key tiles."""
    tiles = -(-S // BLOCK_K)
    n = max(1, min(tiles, -(-BLOCKS_PER_SM * sm_count // (B * KV))))
    split_len = -(-tiles // n) * BLOCK_K
    return -(-S // split_len), split_len


def _check(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, hd = q.shape
    _, S, KV, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or H % KV or S < 1:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous, "
                             f"16-byte aligned and on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of float32 or "
                         f"bfloat16")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError("decode_attention: lengths must be int32 (B,)")
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention: head_dim {hd}, group "
                         f"{H // KV}; the kernel takes head_dim in "
                         f"{HEAD_DIMS} and groups up to {MAX_GROUP}")


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind(load_library("decode_attention"), "decode_attention_launch",
                8, 8)


def _launch(q, k, v, lengths) -> torch.Tensor:
    refuse_grad("decode_attention", (q, k, v),
                "use_kernels=False (the plain decode path)")
    _check(q, k, v, lengths)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    n_splits, split_len = split_plan(B, S, KV,
                                     _sm_count(q.device.index or 0))
    # the partials are freed when this returns; the caching allocator
    # hands their memory out again only to work queued after this launch
    # on the same stream
    f32 = dict(device=q.device, dtype=torch.float32)
    o_part = torch.empty((B * KV, n_splits, G, hd), **f32)
    m_part = torch.empty((B * KV, n_splits, G), **f32)
    l_part = torch.empty((B * KV, n_splits, G), **f32)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   lengths.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
                   l_part.data_ptr(), out.data_ptr(), stream,
                   DTYPES[q.dtype], B, S, KV, G, hd, n_splits, split_len)
    check(rc, "decode_attention")
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    ``decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no implementation for "
                         f"{q.device}")
    out = _launch(q, k, v, lengths)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
