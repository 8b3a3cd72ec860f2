"""The port's selective scan (K3's plain version) against the JAX package
(CPU).

``ssm_scan_plain`` is held to the JAX oracle ``ssm_scan_ref``, to the
Pallas kernel ``ssm_scan_kernel`` run in interpret mode, and to the
model's chunked scan ``selective_scan_chunked``, on the shapes of
tests/test_kernels.py, for both outputs (``y`` and ``h_final``).  The
inputs are made with numpy from a seed and handed to both packages, in
fp32 and in bf16.  Tolerance rtol = atol = 1e-4 throughout, bf16 inputs
included: every path upcasts the same bf16 values and computes in fp32,
so the two frameworks differ only in the order of fp32 sums (the chunked
scan is given those values already upcast, as the model path hands it
fp32; it would otherwise round dt * x to bf16).  A ragged S, which the
Pallas kernel refuses (S % chunk), is held to the oracle alone.  The
wrapper runs the plain version on CPU tensors, counts no launch, and
raises on a device it has no implementation for; its checks refuse, before
any pointer reaches the kernel, what the kernel does not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.ssm_scan.kernel import ssm_scan_kernel  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro.models.mamba import selective_scan_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import (_check, ssm_scan,  # noqa: E402
                                          ssm_scan_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = dict(rtol=1e-4, atol=1e-4)
# (B, S, din, ds, block_d, chunk): the shapes of tests/test_kernels.py
SHAPES = [(2, 128, 64, 16, 32, 64), (1, 256, 128, 16, 128, 128),
          (3, 64, 96, 8, 48, 32)]


def _inputs(B, S, din, ds, dtype, seed):
    """numpy inputs as tests/test_kernels.py draws them -> (jax arrays,
    torch tensors) of the same values; A is fp32."""
    rng = np.random.RandomState(seed)
    arrs = [np.abs(rng.randn(B, S, din)) * 0.1, rng.randn(B, S, ds),
            rng.randn(B, S, ds), rng.randn(B, S, din)]
    jd, td = DTYPES[dtype]
    jx = [jnp.asarray(a.astype(np.float32), jd) for a in arrs]
    tx = [torch.from_numpy(a.astype(np.float32)).to(td) for a in arrs]
    A = -(np.abs(rng.randn(din, ds)) + 0.1).astype(np.float32)
    return jx + [jnp.asarray(A)], tx + [torch.from_numpy(A)]


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               **TOL)


def _reference(kind, jx, block_d, chunk):
    dt, Bt, Ct, x, A = jx
    if kind == "ssm_scan_ref":
        return ssm_scan_ref(dt, Bt, Ct, x, A)
    if kind == "pallas_interpret":
        return ssm_scan_kernel(dt, Bt, Ct, x, A, block_d=block_d,
                               chunk=chunk, interpret=True)
    up = [a.astype(jnp.float32) for a in (dt, Bt, Ct, x)]
    return selective_scan_chunked(*up, A, chunk=chunk)


@pytest.mark.parametrize("kind", ["ssm_scan_ref", "pallas_interpret",
                                  "selective_scan_chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,din,ds,block_d,chunk", SHAPES)
def test_plain_matches_jax(B, S, din, ds, block_d, chunk, dtype, kind):
    jx, tx = _inputs(B, S, din, ds, dtype, seed=B * 1000 + S + din)
    y, h = ssm_scan_plain(*tx)
    assert y.shape == (B, S, din) and h.shape == (B, din, ds)
    assert y.dtype == h.dtype == torch.float32
    y_ref, h_ref = _reference(kind, jx, block_d, chunk)
    _close(y, y_ref)
    _close(h, h_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_shape_matches_ref(dtype):
    """S=300 is no multiple of the Pallas kernel's chunk, din=100 of its
    block, and ds=5 fills no lane group: the oracle alone."""
    jx, tx = _inputs(2, 300, 100, 5, dtype, seed=11)
    y, h = ssm_scan_plain(*tx)
    y_ref, h_ref = ssm_scan_ref(*jx)
    _close(y, y_ref)
    _close(h, h_ref)


def test_h0_continues_a_scan():
    """A scan from h0 equals the oracle from h0, and two halves chained
    through h0 equal one scan over the whole sequence."""
    jx, tx = _inputs(2, 96, 64, 16, "float32", seed=3)
    h0 = np.random.RandomState(4).randn(2, 64, 16).astype(np.float32)
    y, h = ssm_scan_plain(*tx, h0=torch.from_numpy(h0))
    y_ref, h_ref = ssm_scan_ref(*jx, h0=jnp.asarray(h0))
    _close(y, y_ref)
    _close(h, h_ref)
    dt, Bt, Ct, x, A = tx
    y_all, h_all = ssm_scan_plain(dt, Bt, Ct, x, A)
    y1, h1 = ssm_scan_plain(dt[:, :40], Bt[:, :40], Ct[:, :40], x[:, :40], A)
    y2, h2 = ssm_scan_plain(dt[:, 40:], Bt[:, 40:], Ct[:, 40:], x[:, 40:], A,
                            h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, **TOL)
    torch.testing.assert_close(h2, h_all, **TOL)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    _, tx = _inputs(2, 64, 96, 8, "bfloat16", seed=5)
    launches = ssm_scan.launches
    y, h = ssm_scan(*tx)
    assert ssm_scan.launches == launches == 0
    y_ref, h_ref = ssm_scan_plain(*tx)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


def test_wrapper_raises_on_other_devices():
    _, tx = _inputs(1, 8, 32, 4, "float32", seed=6)
    with pytest.raises(ValueError, match="no implementation"):
        ssm_scan(*(t.to("meta") for t in tx))
    assert ssm_scan.launches == 0


def _bad(case, tx):
    dt, Bt, Ct, x, A = tx
    if case == "ds above 16":
        wide = torch.zeros(*Bt.shape[:2], 17)
        return dt, wide, wide, x, torch.zeros(A.shape[0], 17)
    if case == "mixed dtypes":
        return dt, Bt.bfloat16(), Ct, x, A
    if case == "bf16 A":
        return dt, Bt, Ct, x, A.bfloat16()
    if case == "not contiguous":
        return dt.transpose(0, 1).contiguous().transpose(0, 1), Bt, Ct, x, A
    return dt[:, :-1], Bt, Ct, x, A                  # "shapes differ"


@pytest.mark.parametrize("case", ["ds above 16", "mixed dtypes", "bf16 A",
                                  "not contiguous", "shapes differ"])
def test_kernel_checks_refuse_what_it_does_not_take(case):
    _, tx = _inputs(2, 8, 32, 4, "float32", seed=7)
    _check(*tx)
    with pytest.raises(ValueError, match="ssm_scan"):
        _check(*_bad(case, tx))
