"""Mamba-1 block (selective state-space model).

The PyTorch counterpart of ``repro.models.mamba``, with its arithmetic
kept: in_proj -> (x, z); a causal depthwise conv (a sum of shifted
products in the compute dtype) and SiLU on x; softplus(dt) in the compute
dtype; ``A = -exp(A_log)`` in fp32; the selective scan in fp32; ``y + D x``
and ``y * silu(z)`` in fp32, cast back to x's dtype before out_proj.
``A_log`` and ``D`` are fp32 whatever ``param_dtype`` is.  The JAX block
casts dt, B, C and x to fp32 before the scan; here the scan takes them in
the compute dtype and widens them itself (exact, as the cast is): the
kernel each value as it reads it, so a bf16 model hands it bf16 tensors
and makes no fp32 copies; the chunked scan whole tensors.  ``D x`` is
fp32 by type promotion.

Two scan paths, as in the JAX package: the full-sequence block (prefill
and training) runs the selective scan (``use_kernels`` True: the
:func:`ssm_scan` wrapper, which launches the CUDA kernel on CUDA tensors
and runs its plain version on CPU tensors; False: the JAX package's
:func:`selective_scan_chunked`, an associative scan inside chunks of 128
steps with each chunk recomputed in the backward pass, which training
takes since the kernel has no backward); decode is the O(1) recurrent
state update.  Unlike the JAX decode step, which returns a new
``{"h", "conv"}``, this one copies the new state into the cache's
tensors in place.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssm_scan
from .common import dense_init, recompute
from .config import ModelConfig


def init_mamba(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    d, din, ds, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "in_proj": dense_init(gen, (d, 2 * din), dt, device=device),
        "conv_w": dense_init(gen, (cfg.ssm_conv, din), dt, scale=1.0,
                             device=device),
        "x_proj": dense_init(gen, (din, dtr + 2 * ds), dt, device=device),
        "dt_proj": dense_init(gen, (dtr, din), dt, device=device),
        "out_proj": dense_init(gen, (din, d), dt, device=device),
    }
    dev = p["in_proj"].device
    p["dt_bias"] = torch.zeros((din,), dtype=dt, device=dev)
    # A initialised to -[1..ds] (S4D-real), stored as its log
    p["A_log"] = torch.log(torch.arange(
        1, ds + 1, dtype=torch.float32, device=dev)).expand(din, ds) \
        .contiguous()
    p["D"] = torch.ones((din,), dtype=torch.float32, device=dev)
    return p


def _ssm_inputs(cfg: ModelConfig, params, xc: torch.Tensor):
    """xc (B, S, din) post-conv activations -> (dt, B_t, C_t), contiguous
    and in the compute dtype (the scan and the decode step widen them to
    fp32 as they read them)."""
    ds, dtr = cfg.ssm_state, cfg.dt_rank_
    proj = xc @ params["x_proj"]                    # (B, S, dtr + 2 ds)
    dt_in, Bt, Ct = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_in @ params["dt_proj"] + params["dt_bias"])
    return dt, Bt.contiguous(), Ct.contiguous()


def _causal_conv(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel (k, din); x (B, S, din)."""
    k, S = cfg.ssm_conv, x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    w = params["conv_w"]                            # (k, din)
    return sum(pad[:, i:i + S, :] * w[i] for i in range(k))


def _scan_pairs(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over dim 1 of the pairs (a, b) under
    (a1, b1) then (a2, b2) = (a1 a2, b1 a2 + b2): log2(n) shifted passes
    (Hillis-Steele), each step combined with the one ``o`` before it."""
    o = 1
    while o < a.shape[1]:
        a, b = (torch.cat([a[:, :o], a[:, :-o] * a[:, o:]], dim=1),
                torch.cat([b[:, :o], b[:, :-o] * a[:, o:] + b[:, o:]],
                          dim=1))
        o *= 2
    return a, b


def _chunk_step(h, dti, xi, Bi, Ci, A):
    """One chunk of steps from the carried state h (B, din, ds) ->
    (h at its last step, y (B, c, din))."""
    a = torch.exp(dti[..., None] * A)                   # (B, c, din, ds)
    b = (dti * xi)[..., None] * Bi[:, :, None, :]       # (B, c, din, ds)
    a_cum, b_cum = _scan_pairs(a, b)
    hs = a_cum * h[:, None] + b_cum
    y = torch.einsum("bcds,bcs->bcd", hs, Ci)
    return hs[:, -1], y


def selective_scan_chunked(dt, Bt, Ct, x, A, chunk: int = 128, h0=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x (B, S, din); Bt, Ct (B, S, ds); A (din, ds) -> (y (B, S, din),
    h_final (B, din, ds)), fp32: the inputs are widened to fp32 (exact),
    S is padded with zero steps to whole chunks (dt = 0 leaves h as it
    is), and each chunk is recomputed in the backward pass, so only the
    states at chunk boundaries are kept."""
    dt, Bt, Ct, x = (t.float() for t in (dt, Bt, Ct, x))
    Bsz, S, din = x.shape
    pad = (-S) % chunk
    if pad:
        dt, x, Bt, Ct = (F.pad(t, (0, 0, 0, pad)) for t in (dt, x, Bt, Ct))
    h = torch.zeros((Bsz, din, Bt.shape[-1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0
    ys = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        h, y = recompute(_chunk_step, h, dt[:, sl], x[:, sl], Bt[:, sl],
                         Ct[:, sl], A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_block(cfg: ModelConfig, params, x: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence (prefill) mamba sub-layer. x (B, S, d)."""
    xi, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xi = F.silu(_causal_conv(cfg, params, xi))
    dt, Bt, Ct = _ssm_inputs(cfg, params, xi)
    A = -torch.exp(params["A_log"])
    scan = ssm_scan if use_kernels else selective_scan_chunked
    y, _ = scan(dt, Bt, Ct, xi, A)
    y = y + params["D"] * xi                        # fp32 by promotion
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"]


# ------------------------------------------------------------------ decode --
def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=getattr(torch, cfg.compute_dtype),
                            device=device),
    }


def mamba_decode_step(cfg: ModelConfig, params, x: torch.Tensor,
                      cache: dict) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d) -> (out (B, 1, d), cache): the O(1) state update, with
    the new ``h`` and conv window copied into ``cache`` in place."""
    xi, z = (x[:, 0] @ params["in_proj"]).chunk(2, dim=-1)  # (B, din)
    # conv over [cache window, new token]: exact fp32 products summed in
    # fp32 and rounded once, as the JAX einsum does
    win = torch.cat([cache["conv"], xi[:, None].to(cache["conv"].dtype)],
                    dim=1)                          # (B, k, din)
    w = params["conv_w"]                            # (k, din)
    conv = (win.float() * w.float()).sum(dim=1)
    xc = F.silu(conv.to(torch.promote_types(win.dtype, w.dtype)))
    dt, Bt, Ct = _ssm_inputs(cfg, params, xc[:, None])
    dt, Bt, Ct = dt[:, 0], Bt[:, 0], Ct[:, 0]       # (B,din),(B,ds),(B,ds)
    A = -torch.exp(params["A_log"])
    xf = xc.float()
    a = torch.exp(dt[..., None] * A)                # (B, din, ds)
    h = a * cache["h"] + (dt * xf)[..., None] * Bt[:, None, :]
    y = (h * Ct[:, None, :]).sum(dim=-1) + params["D"] * xf
    y = (y * F.silu(z.float())).to(x.dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return (y @ params["out_proj"])[:, None], cache
