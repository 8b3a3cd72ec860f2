"""The bf16 mamba block's feed to the selective scan (CPU).

In a bf16 model the port's mamba block hands the scan ``dt``, ``B``,
``C`` and ``x`` as bf16 tensors, where the JAX block (and the port before
it) made fp32 copies of them first.  The scan widens them itself, which
is exact, as the cast is; so the output must equal, bit for bit, the
block that feeds fp32 copies.  Both scan paths: the kernel wrapper
(``use_kernels`` True) and the chunked scan (False).  The decode step, which takes
the same inputs from ``_ssm_inputs``, must be unchanged bit for bit too.
Reduced falcon-mamba, random weights from a seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import mamba as tm  # noqa: E402

B, S = 2, 24


def _bf16_layer():
    cfg = dataclasses.replace(reduced_config("falcon-mamba"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params["layers"][0]["mixer"]


def _fp32_copies_block(cfg, p, x, scan):
    """The block as it was: dt, B, C and x cast to fp32 before the scan."""
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xi = F.silu(tm._causal_conv(cfg, p, xi))
    dt, Bt, Ct = (t.float() for t in tm._ssm_inputs(cfg, p, xi))
    xf = xi.float()
    y, _ = scan(dt, Bt, Ct, xf, -torch.exp(p["A_log"]))
    y = y + p["D"] * xf
    return (y * F.silu(z.float())).to(x.dtype) @ p["out_proj"]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bf16_block_hands_the_scan_bf16_and_matches_fp32_copies(
        use_kernels, monkeypatch):
    cfg, p = _bf16_layer()
    x = torch.from_numpy(np.random.RandomState(4).randn(
        B, S, cfg.d_model).astype(np.float32)).to(torch.bfloat16)
    name = "ssm_scan" if use_kernels else "selective_scan_chunked"
    scan = getattr(tm, name)
    seen = []

    def spy(*args):
        seen.append(tuple(a.dtype for a in args))
        assert all(a.is_contiguous() for a in args)
        return scan(*args)

    monkeypatch.setattr(tm, name, spy)
    out = tm.mamba_block(cfg, p, x, use_kernels=use_kernels)
    assert seen == [(torch.bfloat16,) * 4 + (torch.float32,)]
    old = _fp32_copies_block(cfg, p, x, scan)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.equal(out, old)


def test_bf16_decode_step_is_unchanged(monkeypatch):
    """Two decode steps with the compute-dtype inputs and two with fp32
    copies of them give the same outputs and cache, bit for bit."""
    cfg, p = _bf16_layer()
    xs = torch.from_numpy(np.random.RandomState(5).randn(
        2, B, 1, cfg.d_model).astype(np.float32)).to(torch.bfloat16)

    def run():
        cache = tm.init_mamba_cache(cfg, B)
        outs = [tm.mamba_decode_step(cfg, p, x, cache)[0] for x in xs]
        return outs, cache

    new_outs, new_cache = run()
    real = tm._ssm_inputs
    monkeypatch.setattr(tm, "_ssm_inputs", lambda *a: tuple(
        t.float() for t in real(*a)))
    old_outs, old_cache = run()
    for a, b in zip(new_outs, old_outs):
        assert torch.equal(a, b)
    for key in ("h", "conv"):
        assert torch.equal(new_cache[key], old_cache[key]), key
    assert bool(new_cache["h"].abs().sum() > 0)
