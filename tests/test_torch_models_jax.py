"""The port's model against the JAX package's (CPU, fp32).

For every reduced arch (attention or mamba mixers, dense or MoE FFNs),
the JAX ``init_params`` are carried across by ``params_from_jax`` and the
same numpy-made tokens go through both packages:

* ``forward`` logits equal JAX ``forward(use_pallas=False)``;
* a sequence of ``serve_step`` logits, and the cache after every step
  (K/V for attention, ``h`` and the conv window for mamba), equal JAX
  ``serve_step``'s;
* decode == forward holds in the port (as tests/test_models_smoke.py);
* the port's own ``init_params`` has ``cfg.n_params()`` parameters;
* the mamba block equals JAX ``mamba_block`` on both of its scan paths.

Tolerance 1e-4 (absolute and relative) on logits of magnitude up to ~5:
both packages compute in fp32, but XLA and PyTorch sum the matmuls, the
softmax and the scan in other orders, which measured about 5e-6 here.
The reduced MoE configs route without drops (capacity factor 16), so
decode (one token a step) and forward agree.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import serve_step as ref_serve_step  # noqa: E402
from repro.models.mamba import mamba_block as ref_mamba_block  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import (forward, init_cache,  # noqa: E402
                                init_params, serve_step)
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.mamba import mamba_block  # noqa: E402

PORTED = ["yi-6b", "phi4-mini", "command-r-plus", "nemotron", "qwen2-vl",
          "musicgen", "falcon-mamba", "jamba", "deepseek-moe", "dbrx"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 12


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX params, the port's params carried across) for one arch."""
    cfg = ref_reduced_config(arch)
    jp = ref_init_params(cfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp))


def n_params(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(n_params(x) for x in items)


def _tokens(cfg, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(arch):
    cfg = reduced_config(arch)
    jp, tp = _params(arch)
    tok = _tokens(cfg)
    ref = jax.jit(lambda p, t: ref_forward(cfg, p, {"tokens": t}))(
        jp, jnp.asarray(tok))
    out = forward(cfg, tp, {"tokens": torch.from_numpy(tok).long()})
    assert out.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_serve_steps_and_caches_match_jax(arch):
    cfg = reduced_config(arch)
    jp, tp = _params(arch)
    tok = _tokens(cfg, seed=2)
    step = jax.jit(lambda p, c, t, q: ref_serve_step(cfg, p, c,
                                                     {"tokens": t}, q))
    jc = ref_init_cache(cfg, B, 16)
    tc = init_cache(cfg, B, 16)
    prefix, periods, pattern = cfg.layer_pattern()
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jl, jc = step(jp, jc, jnp.asarray(tok[:, t:t + 1]), jnp.asarray(pos))
        tl, tc = serve_step(cfg, tp, tc,
                            {"tokens": torch.from_numpy(tok[:, t:t + 1])
                             .long()}, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pairs = list(zip(jc["prefix"], tc))
        for p in range(periods):
            for i in range(len(pattern)):
                pairs.append((jax.tree.map(lambda a: a[p],
                                           jc["stack"][f"sub{i}"]),
                              tc[len(prefix) + p * len(pattern) + i]))
        for ref_c, mine in pairs:
            assert sorted(mine) == sorted(ref_c)
            for key in ref_c:
                np.testing.assert_allclose(mine[key].numpy(),
                                           np.asarray(ref_c[key]), **TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch):
    cfg = reduced_config(arch)
    _, tp = _params(arch)
    tok = torch.from_numpy(_tokens(cfg, seed=7)).long()
    full = forward(cfg, tp, {"tokens": tok})
    cache = init_cache(cfg, B, S)
    outs = []
    for t in range(S):
        lg, cache = serve_step(cfg, tp, cache, {"tokens": tok[:, t:t + 1]},
                               torch.full((B,), t, dtype=torch.int32))
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, dim=1), full, **TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_match_formula(arch):
    cfg = reduced_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert n_params(params) == cfg.n_params()
    assert n_params(_params(arch)[1]) == cfg.n_params()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_block_matches_jax(use_pallas):
    """The port's mamba block against JAX's, layer 0 of reduced
    falcon-mamba: use_pallas False is the chunked scan, True the Pallas
    kernel in interpret mode; the port runs its plain scan (CPU tensors)
    with ``use_kernels`` False and through the wrapper with True."""
    cfg = reduced_config("falcon-mamba")
    jp, tp = _params("falcon-mamba")
    x = np.random.RandomState(3).randn(B, 16, cfg.d_model).astype(
        np.float32)
    ref = ref_mamba_block(ref_reduced_config("falcon-mamba"),
                          jax.tree.map(lambda a: a[0],
                                       jp["stack"]["sub0"]["mixer"]),
                          jnp.asarray(x), use_pallas)
    out = mamba_block(cfg, tp["layers"][0]["mixer"], torch.from_numpy(x),
                      use_kernels=use_pallas)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_mamba_keeps_fp32_leaves_in_a_bf16_model():
    """``A_log`` and ``D`` stay fp32 whatever ``param_dtype`` is, in the
    port's own init and through ``params_from_jax`` (bit for bit)."""
    import dataclasses
    cfg = dataclasses.replace(ref_reduced_config("falcon-mamba"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, ref_init_params(cfg, jax.random.PRNGKey(0)))
    mine = dataclasses.replace(reduced_config("falcon-mamba"),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    for params in (params_from_jax(mine, jp),
                   init_params(mine, torch.Generator().manual_seed(0))):
        assert n_params(params) == mine.n_params()
        for layer in params["layers"]:
            mixer = layer["mixer"]
            assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
            assert mixer["in_proj"].dtype == torch.bfloat16
    carried = params_from_jax(mine, jp)["layers"][1]["mixer"]
    np.testing.assert_array_equal(
        carried["A_log"].numpy(), jp["stack"]["sub0"]["mixer"]["A_log"][1])
    np.testing.assert_array_equal(
        carried["in_proj"].view(torch.uint16).numpy(),
        jp["stack"]["sub0"]["mixer"]["in_proj"][1].view(np.uint16))
