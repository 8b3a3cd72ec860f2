"""The port's attention kernels' plain versions against the JAX oracles
(CPU).

K2 (``flash_attention_plain``) is held to ``flash_attention_ref`` and to
the model's chunked path ``causal_attention_chunked``; K4
(``decode_attention_plain``) to ``decode_attention_ref``.  The shapes and
tolerances are those of ``tests/test_kernels.py``: 2e-5 in fp32, 2e-2 in
bf16 (the two frameworks round bf16 at other places), 2e-4 against the
chunked path.  The inputs are made with numpy from a seed and handed to
both.  The wrappers run the plain versions on CPU tensors, count no
launch, and raise on any device that is neither CPU nor CUDA.  Both
kernels' shape checks take head_dim 192 (nemotron-4-340b).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro.models.attention import causal_attention_chunked  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain, split_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a, name):
    """One numpy array -> (jax array, torch tensor) of the same values."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(out, ref, **tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# ---------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (2, 256, 4, 4, 64, True),     # the shapes of tests/test_kernels.py
    (2, 512, 8, 2, 64, True),
    (1, 1024, 8, 1, 128, True),
    (3, 384, 6, 2, 32, True),
    (2, 256, 4, 2, 64, False),    # non-causal
    (2, 200, 4, 2, 32, True),     # S not a multiple of any tile
    (1, 77, 8, 2, 64, False),
])
def test_flash_plain_matches_ref(B, S, H, KV, hd, causal, dtype):
    rng = np.random.RandomState(B * 1000 + S + H)
    q, tq = _pair(rng.randn(B, S, H, hd).astype(np.float32), dtype)
    k, tk = _pair(rng.randn(B, S, KV, hd).astype(np.float32), dtype)
    v, tv = _pair(rng.randn(B, S, KV, hd).astype(np.float32), dtype)
    out = flash_attention_plain(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, flash_attention_ref(q, k, v, causal=causal), **_tol(dtype))


def test_flash_plain_matches_model_chunked_path():
    rng = np.random.RandomState(1)
    B, S, H, KV, hd = 2, 512, 8, 2, 64
    q, tq = _pair(rng.randn(B, S, H, hd).astype(np.float32), "float32")
    k, tk = _pair(rng.randn(B, S, KV, hd).astype(np.float32), "float32")
    v, tv = _pair(rng.randn(B, S, KV, hd).astype(np.float32), "float32")
    ref = causal_attention_chunked(q, k, v, H // KV, block=128)
    _close(flash_attention_plain(tq, tk, tv), ref, rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------- decode attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 1024, 8, 2, 64),          # the shapes of tests/test_kernels.py
    (4, 512, 4, 4, 64),
    (1, 2048, 8, 1, 128),
    (3, 300, 8, 4, 32),           # S not a multiple of any tile
])
def test_decode_plain_matches_ref(B, S, H, KV, hd, dtype):
    rng = np.random.RandomState(B * 100 + S)
    q, tq = _pair(rng.randn(B, H, hd).astype(np.float32), dtype)
    k, tk = _pair(rng.randn(B, S, KV, hd).astype(np.float32), dtype)
    v, tv = _pair(rng.randn(B, S, KV, hd).astype(np.float32), dtype)
    lens = rng.randint(1, S + 1, (B,)).astype(np.int32)
    out = decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, decode_attention_ref(q, k, v, jnp.asarray(lens)),
           **_tol(dtype))


@pytest.mark.parametrize("lens", [[1, 512], [512, 1], [137, 255]])
def test_decode_plain_edge_lengths(lens):
    rng = np.random.RandomState(3)
    B, S, H, KV, hd = 2, 512, 4, 2, 64
    q, tq = _pair(rng.randn(B, H, hd).astype(np.float32), "float32")
    k, tk = _pair(rng.randn(B, S, KV, hd).astype(np.float32), "float32")
    v, tv = _pair(rng.randn(B, S, KV, hd).astype(np.float32), "float32")
    lens = np.asarray(lens, np.int32)
    out = decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    _close(out, decode_attention_ref(q, k, v, jnp.asarray(lens)),
           rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,KV", [(16, 32768, 4), (128, 32768, 4),
                                    (4, 2048, 4), (32, 2048, 4), (2, 77, 1)])
def test_decode_split_plan_covers_the_cache(B, S, KV):
    """Every split is whole tiles, the splits cover [0, S) exactly once
    and none is empty."""
    n, split_len = split_plan(B, S, KV, sm_count=132)
    assert split_len % 64 == 0
    assert (n - 1) * split_len < S <= n * split_len


# ------------------------------------------------------------------ wrappers
def test_wrappers_run_plain_versions_on_cpu_tensors():
    rng = np.random.RandomState(9)
    q = torch.from_numpy(rng.randn(2, 40, 4, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 40, 2, 32).astype(np.float32))
    launches = flash_attention.launches, decode_attention.launches
    torch.testing.assert_close(flash_attention(q, k, k),
                               flash_attention_plain(q, k, k), rtol=0,
                               atol=0)
    lens = torch.tensor([3, 40], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q[:, 0], k, k, lens),
                               decode_attention_plain(q[:, 0], k, k, lens),
                               rtol=0, atol=0)
    assert (flash_attention.launches, decode_attention.launches) == \
        launches == (0, 0)


def test_wrappers_raise_on_other_devices():
    q = torch.zeros((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no implementation"):
        decode_attention(q[:, 0], q, q,
                         torch.ones(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("hd,ok", [(192, True), (128, True), (96, False),
                                   (256, False)])
def test_kernel_shape_checks_take_head_dim_192(hd, ok):
    """Both attention kernels take nemotron-4-340b's head_dim 192 (and
    refuse a head_dim they have no instantiation for) before any launch;
    the plain versions, the kernels' oracles, agree with the JAX oracles
    there."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    q = torch.zeros((1, 8, 12, hd))
    kv = torch.zeros((1, 8, 4, hd))
    checks = [lambda: kf._check(q, kv, kv),
              lambda: kd._check(q[:, 0].contiguous(), kv, kv,
                                torch.ones(1, dtype=torch.int32))]
    for check in checks:
        if ok:
            check()
        else:
            with pytest.raises(ValueError, match="head_dim"):
                check()


def test_plain_versions_match_refs_at_head_dim_192():
    rng = np.random.RandomState(7)
    B, S, H, KV, hd = 2, 40, 12, 4, 192
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, KV, hd).astype(np.float32)
    v = rng.randn(B, S, KV, hd).astype(np.float32)
    ref = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True)
    out = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol("float32"))
    lengths = np.array([1, 33], np.int32)
    ref = decode_attention_ref(jnp.asarray(q[:, 0]), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lengths))
    out = decode_attention_plain(torch.from_numpy(q[:, 0].copy()),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol("float32"))
