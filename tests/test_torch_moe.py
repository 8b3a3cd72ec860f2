"""The port's MoE FFN against the JAX package's (CPU, fp32).

* ``moe_ffn`` equals ``moe_ffn_dense_reference`` when no (token, expert)
  pair is dropped (a high capacity factor);
* with the capacity binding (capacity factor 1.0 or lower, at least one
  drop asserted), ``moe_ffn`` and its gradients equal JAX ``moe_ffn``'s:
  the same pairs are dropped, in the same stable order, including the
  decode shape where a batch of 4 tokens is one chunk of capacity 1.

The JAX parameters of a reduced MoE layer are carried across by
``params_from_jax``; inputs are numpy draws from a seed.  Tolerance on
the outputs: 1e-5 relative, and 1e-5 of the output's largest magnitude
absolute.  Both packages compute in fp32, in other orders, and the
outputs reach ~30 (the reference's expert init scales by 1/sqrt(E), not
by the fan-in), so a small output that cancels larger terms carries
their rounding, ~1e-5 absolute.  On the gradients 1e-4 (as the loss
gradients in tests/test_torch_train.py): a gradient sums more products
than an output.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.moe import moe_ffn as ref_moe_ffn  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.moe import (_moe_chunks, _route,  # noqa: E402
                                    moe_ffn, moe_ffn_dense_reference)

TOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["deepseek-moe", "jamba", "dbrx"]


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reduced arch's JAX parameters (the capacity factor does not
    enter them)."""
    cfg = ref_reduced_config(arch)
    return jax.jit(lambda k: ref_init_params(cfg, k))(jax.random.PRNGKey(0))


def _layer(arch, capacity_factor):
    """(JAX config, port config, JAX MoE params, port MoE params) of the
    first MoE layer of the reduced arch."""
    jcfg = dataclasses.replace(ref_reduced_config(arch),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(reduced_config(arch),
                              capacity_factor=capacity_factor)
    jp = _jax_params(arch)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    _, _, pattern = cfg.layer_pattern()
    i = [f for _, f in pattern].index("moe")
    ref = jax.tree.map(lambda a: a[0], jp["stack"][f"sub{i}"]["ffn"])
    n_prefix = len(jp["prefix"])
    return jcfg, cfg, ref, tp["layers"][n_prefix + i]["ffn"]


def _drops(cfg, params, x) -> int:
    """(token, expert) pairs past their expert's capacity."""
    T = x.shape[0] * x.shape[1]
    nc = _moe_chunks(T)
    tc = T // nc
    cap = int(max(1, math.ceil(tc * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor)))
    _, top_e = _route(cfg, params, x.reshape(nc, tc, -1))
    counts = torch.stack([torch.bincount(e.reshape(-1),
                                         minlength=cfg.n_experts)
                          for e in top_e])
    return int((counts - cap).clamp_min(0).sum())


def _x(cfg, B, S, seed):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_equals_dense_reference_without_drops(arch):
    _, cfg, _, p = _layer(arch, 16.0)
    x = torch.from_numpy(_x(cfg, 2, 40, 1))
    assert _drops(cfg, p, x) == 0
    ref = moe_ffn_dense_reference(cfg, p, x)
    torch.testing.assert_close(moe_ffn(cfg, p, x), ref, rtol=TOL,
                               atol=TOL * float(ref.abs().max()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S,capacity_factor", [(2, 40, 1.0), (4, 16, 0.5),
                                                 (4, 1, 1.0)])
def test_moe_with_binding_capacity_matches_jax(arch, B, S, capacity_factor):
    """Forward and the gradients with respect to the input and every
    parameter, through the dropped pairs' discarded writes."""
    jcfg, cfg, jparams, p = _layer(arch, capacity_factor)
    x = _x(cfg, B, S, 2)
    xt = torch.from_numpy(x)
    assert _drops(cfg, p, xt) > 0
    assert not torch.allclose(moe_ffn(cfg, p, xt),
                              moe_ffn_dense_reference(cfg, p, xt), rtol=0.1,
                              atol=0.1)
    cot = np.random.RandomState(3).randn(*x.shape).astype(np.float32)

    def ref_loss(prm, xx):
        return jnp.sum(ref_moe_ffn(jcfg, prm, xx) * cot)

    ref_out = jax.jit(lambda prm, xx: ref_moe_ffn(jcfg, prm, xx))(
        jparams, jnp.asarray(x))
    ref_gp, ref_gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jparams, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xg = xt.clone().requires_grad_()
    out = moe_ffn(cfg, leaves, xg)
    ref_out = np.asarray(ref_out)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=TOL,
                               atol=TOL * np.abs(ref_out).max())
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [xg] + list(leaves.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_gx),
                               **GRAD_TOL)
    for name, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_gp[name]),
                                   err_msg=name, **GRAD_TOL)


def test_decode_capacity_of_deepseek_moe_at_full_width():
    """deepseek-moe-16b's decode batch of 4: one chunk of 4 tokens and a
    capacity of ceil(4 * 6 / 64 * 1.25) = 1 row an expert."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-moe-16b")
    assert _moe_chunks(4) == 1
    assert int(max(1, math.ceil(4 * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor))) == 1
