"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The PyTorch counterpart of ``repro.models.moe``, with its dispatch kept
exactly, so that the same tokens are dropped in the same order:

* the router's logits in fp32, a softmax, the top-k gates renormalised;
* per chunk of tokens (:func:`_moe_chunks`), the (token, expert) pairs
  sorted by expert with a stable sort, each pair's position inside its
  expert from ``searchsorted(..., side="left")``, and a capacity of
  ``ceil(tc * k / E * capacity_factor)`` rows an expert: pairs past it are
  dropped (GShard/Switch), written to an extra row that is then cut off,
  as the JAX package's ``mode="drop"`` scatter discards them, so the op
  stays differentiable;
* the expert products on the (E, chunks * capacity, d) buffer;
* the combine as a segment sum (``index_add``) of the gated rows, and
  the always-on shared experts (DeepSeekMoE).

The expert products are batched matrix products, as the JAX package's are
einsums outside any Pallas kernel.  Where the JAX package ``vmap``s the
routing over chunks, the chunk is a batch dimension here.
"""
from __future__ import annotations

import math

import torch

from .common import act_fn, dense_init
from .config import ModelConfig


def init_moe(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    d, dff, E, S = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_shared_experts
    dt = getattr(torch, cfg.param_dtype)
    gated = cfg.act in ("swiglu", "geglu")
    p = {"router": dense_init(gen, (d, E), dt, device=device),
         "w1": dense_init(gen, (E, d, dff), dt, device=device),
         "w2": dense_init(gen, (E, dff, d), dt, device=device)}
    if gated:
        p["w3"] = dense_init(gen, (E, d, dff), dt, device=device)
    if S:
        p["sh_w1"] = dense_init(gen, (d, S * dff), dt, device=device)
        p["sh_w2"] = dense_init(gen, (S * dff, d), dt, device=device)
        if gated:
            p["sh_w3"] = dense_init(gen, (d, S * dff), dt, device=device)
    return p


def _moe_chunks(T: int) -> int:
    """Token chunks for locality: the routing and the capacity are per
    chunk, as in the JAX package."""
    for nc in (32, 16, 8, 4, 2, 1):
        if T % nc == 0 and T // nc >= 16:
            return nc
    return 1


def _gated_ffn(cfg: ModelConfig, x, w1, w3, w2, mm):
    act = act_fn(cfg.act)
    h = mm(x, w1)
    if cfg.act in ("swiglu", "geglu"):
        h = act(h) * mm(x, w3)
    else:
        h = act(h)
    return mm(h, w2)


def _shared(cfg: ModelConfig, params, xt):
    return _gated_ffn(cfg, xt, params["sh_w1"], params.get("sh_w3"),
                      params["sh_w2"], torch.matmul)


def _route(cfg: ModelConfig, params, xt):
    """xt (..., T, d) -> the renormalised top-k gates and their experts,
    (..., T, k) each; the router's logits in fp32."""
    logits = (xt @ params["router"]).float()
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates, cfg.top_k, dim=-1)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_g, top_e


def moe_ffn(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    nc = _moe_chunks(T)
    tc = T // nc                                # tokens per chunk
    xt = x.reshape(nc, tc, d)
    cap = int(max(1, math.ceil(tc * k / E * cfg.capacity_factor)))
    dev = x.device

    # ---- routing + chunk-local sort-based capacity dispatch -------------
    top_g, top_e = _route(cfg, params, xt)      # (nc, tc, k)
    flat_e = top_e.reshape(nc, tc * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(nc, E).contiguous())
    idx = torch.arange(tc * k, device=dev)
    pos_in_e = idx - torch.gather(seg_start, 1, sorted_e)
    keep = pos_in_e < cap
    slot = sorted_e * cap + pos_in_e
    token_of = order // k                       # (nc, tc*k)
    chunk = torch.arange(nc, device=dev)[:, None].expand(nc, tc * k)
    # dropped pairs go to the extra row E * cap, cut off below
    dest = torch.where(keep, slot, E * cap)
    buf = x.new_zeros((nc, E * cap + 1, d)).index_put(
        (chunk, dest), xt[chunk, token_of])
    xe = buf[:, :E * cap].reshape(nc, E, cap, d)

    # ---- expert computation ----------------------------------------------
    xe = xe.transpose(0, 1).reshape(E, nc * cap, d)
    ye = _gated_ffn(cfg, xe, params["w1"], params.get("w3"), params["w2"],
                    torch.bmm)                  # (E, nc*cap, d)
    ye = ye.reshape(E, nc, cap, d).transpose(0, 1)   # (nc, E, cap, d)

    # ---- chunk-local combine ---------------------------------------------
    yflat = ye.reshape(nc, E * cap, d)
    contrib = yflat[chunk, torch.where(keep, slot, 0)] * keep[..., None]
    gate_of = torch.gather(top_g.reshape(nc, tc * k), 1, order)
    contrib = contrib * gate_of[..., None].to(x.dtype)
    y = x.new_zeros((T, d)).index_add(
        0, (chunk * tc + token_of).reshape(-1), contrib.reshape(-1, d))

    # ---- shared experts (always on) --------------------------------------
    if cfg.n_shared_experts:
        y = y + _shared(cfg, params, xt.reshape(T, d))
    return y.reshape(B, S, d).to(x.dtype)


def moe_ffn_dense_reference(cfg: ModelConfig, params,
                            x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert evaluated densely, weighted by the top-k gates
    (equal to :func:`moe_ffn` when no pair is dropped)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    top_g, top_e = _route(cfg, params, xt)
    w = torch.zeros((xt.shape[0], cfg.n_experts), dtype=top_g.dtype,
                    device=x.device).scatter(1, top_e, top_g)
    act = act_fn(cfg.act)
    h = torch.einsum("td,edf->tef", xt, params["w1"])
    if cfg.act in ("swiglu", "geglu"):
        h = act(h) * torch.einsum("td,edf->tef", xt, params["w3"])
    else:
        h = act(h)
    ye = torch.einsum("tef,efd->ted", h, params["w2"])
    y = torch.einsum("ted,te->td", ye, w.to(x.dtype))
    if cfg.n_shared_experts:
        y = y + _shared(cfg, params, xt)
    return y.reshape(B, S, d).to(x.dtype)
