"""Mamba-1 selective scan: a CUDA kernel and its plain version.

``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t`` and ``y_t = C_t . h_t``
over time, in fp32, for ``dt``, ``x`` (B, S, din), ``Bt``, ``Ct``
(B, S, ds) and ``A`` (din, ds); it returns ``y`` (B, S, din) and the
final state ``h`` (B, din, ds), both fp32 -- the semantics of
``ssm_scan_ref`` in the JAX package.

This replaces the Pallas kernel ``ssm_scan_kernel`` in
``src/repro/kernels/ssm_scan/kernel.py`` (body ``_ssm_kernel``), which
carries the state in VMEM across a sequential grid of time chunks.  Two
implementations of one function live here:

* :func:`ssm_scan_plain` -- a sequential fp32 loop over time.  The CPU
  tests hold it to the JAX oracle, and ``chip_smoke.py`` holds the kernel
  to it on the card.
* the CUDA kernel in ``src/repro_torch/csrc/ssm_scan.cu`` (one block per
  batch row and 16 channels, eight lanes a channel, the time loop inside
  the block, inputs staged through a ``cp.async`` ring), built at first
  use (:mod:`.build`).

:func:`ssm_scan` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, no other path.  The kernel takes fp32 or bf16
``dt``/``x``/``Bt``/``Ct`` (all four of one type), fp32 ``A``, any S and
din and ds up to 16; anything else raises.  It has no backward: on a
CUDA input that requires grad, with grad enabled, it raises (training
takes ``selective_scan_chunked``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .build import bind, check, load_library, refuse_grad

MAX_STATE = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssm_scan_plain(dt: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor,
                   x: torch.Tensor, A: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x (B, S, din); Bt, Ct (B, S, ds); A (din, ds); h0 (B, din, ds)
    or None for zeros -> (y (B, S, din), h_final (B, din, ds)), fp32."""
    Bsz, S, din = x.shape
    ds = Bt.shape[-1]
    dt, x, Bt, Ct, A = (t.float() for t in (dt, x, Bt, Ct, A))
    h = torch.zeros((Bsz, din, ds), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    dx = dt * x
    y = torch.empty((Bsz, S, din), dtype=torch.float32, device=x.device)
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + dx[:, t, :, None] * Bt[:, t, None, :]
        y[:, t] = (h * Ct[:, t, None, :]).sum(dim=-1)
    return y, h


def _check(dt, Bt, Ct, x, A):
    if x.dim() != 3 or Bt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)}, Bt "
                         f"{tuple(Bt.shape)}, A {tuple(A.shape)}")
    Bsz, S, din = x.shape
    ds = Bt.shape[-1]
    if dt.shape != x.shape or Bt.shape != (Bsz, S, ds) or \
            Ct.shape != Bt.shape or A.shape != (din, ds):
        raise ValueError(
            f"ssm_scan: dt {tuple(dt.shape)}, x {tuple(x.shape)}, Bt "
            f"{tuple(Bt.shape)}, Ct {tuple(Ct.shape)}, A {tuple(A.shape)} "
            f"do not match")
    for name, t in (("dt", dt), ("Bt", Bt), ("Ct", Ct), ("x", x), ("A", A)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous and on "
                             f"{x.device}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype
                                    for t in (dt, Bt, Ct)) \
            or A.dtype != torch.float32:
        raise ValueError(f"ssm_scan: dtypes dt {dt.dtype}, Bt {Bt.dtype}, "
                         f"Ct {Ct.dtype}, x {x.dtype}, A {A.dtype}; the "
                         f"kernel takes dt/Bt/Ct/x all float32 or all "
                         f"bfloat16, and A float32")
    if not (1 <= ds <= MAX_STATE) or not (1 <= Bsz <= 65535) or \
            S < 1 or din < 1:
        raise ValueError(f"ssm_scan: B {Bsz}, S {S}, din {din}, ds {ds}; "
                         f"the kernel takes ds in [1, {MAX_STATE}], B in "
                         f"[1, 65535] and S, din >= 1")


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind(load_library("ssm_scan"), "ssm_scan_launch", 7, 6)


def _copies_in_16_bytes(dt, Bt, Ct, x) -> bool:
    """Whether the kernel may stage the inputs with 16-byte ``cp.async``
    copies: a full state width, rows of whole 16-byte pieces and aligned
    pointers."""
    return Bt.shape[-1] == MAX_STATE and \
        x.shape[-1] * x.element_size() % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (dt, Bt, Ct, x))


def _launch(dt, Bt, Ct, x, A) -> Tuple[torch.Tensor, torch.Tensor]:
    refuse_grad("ssm_scan", (dt, Bt, Ct, x, A),
                "use_kernels=False (models.mamba.selective_scan_chunked)")
    _check(dt, Bt, Ct, x, A)
    Bsz, S, din = x.shape
    ds = Bt.shape[-1]
    y = torch.empty((Bsz, S, din), dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, din, ds), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(dt.data_ptr(), x.data_ptr(), Bt.data_ptr(),
                   Ct.data_ptr(), A.data_ptr(), y.data_ptr(), h.data_ptr(),
                   stream, DTYPES[x.dtype], Bsz, S, din, ds,
                   int(_copies_in_16_bytes(dt, Bt, Ct, x)))
    check(rc, "ssm_scan")
    return y, h


def ssm_scan(dt: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor,
             x: torch.Tensor, A: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    ``ssm_scan.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return ssm_scan_plain(dt, Bt, Ct, x, A)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no implementation for {x.device}")
    out = _launch(dt, Bt, Ct, x, A)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
