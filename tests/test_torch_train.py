"""The port's training path against the JAX package's (CPU, fp32).

* ``causal_attention_chunked`` (a small ``block``, so that the chunked
  branch runs) and ``selective_scan_chunked`` equal JAX's, forward and
  gradient (``jax.grad`` against ``torch.autograd.grad``);
* ``loss_fn`` and its gradients equal ``jax.value_and_grad(loss_fn)`` for
  reduced yi-6b, falcon-mamba, deepseek-moe and jamba; remat ("nothing"
  and "dots") changes neither;
* ``adamw_update`` fed the same gradients gives the same parameters, with
  fp32 and with int8 state (whose int8 blocks are equal exactly);
* one ``make_train_step`` with ``accum=2`` equals JAX's; one train step of
  every reduced arch is finite and moves every parameter;
* the analogues of tests/test_pipeline_serving.py's data-queue tests on
  the port's copies, and the crash-restart of
  ``python -m repro_torch.launch.train --device cpu``; a bf16 checkpoint
  restores bit for bit.

Tolerances: 1e-4 (absolute and relative) on losses, outputs and
gradients, as tests/test_torch_models_jax.py on logits: both packages
compute in fp32 and sum in other orders.  1e-6 on parameters after an
update: the update moves them by about lr = 3e-4 or less, and both sides
take the same elementwise fp32 steps.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS  # noqa: E402
from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.steps import accum_steps as ref_accum_steps  # noqa: E402
from repro.launch.steps import input_specs as ref_input_specs  # noqa: E402
from repro.launch.steps import make_train_step as ref_train_step  # noqa
from repro.models.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import loss_fn as ref_loss_fn  # noqa: E402
from repro.models.attention import \
    causal_attention_chunked as ref_attention  # noqa: E402
from repro.models.mamba import \
    selective_scan_chunked as ref_scan  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data import DurableShardQueue  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import (accum_steps, input_specs,  # noqa
                                      make_train_step)
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.launch.train import (state_from_numpy,  # noqa: E402
                                      state_to_numpy)
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.models.attention import \
    causal_attention_chunked  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.mamba import selective_scan_chunked  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update,  # noqa: E402
                               init_opt_state)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_ARCHS = ["yi-6b", "falcon-mamba", "deepseek-moe", "jamba"]
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    """(JAX params, the port's params carried across) for one arch."""
    cfg = ref_reduced_config(arch)
    jp = jax.jit(lambda k: ref_init_params(cfg, k))(jax.random.PRNGKey(seed))
    return jp, params_from_jax(reduced_config(arch),
                               jax.tree.map(np.asarray, jp))


def _batch(cfg, seed=1, batch=B):
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab, (batch, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_leaves(tree):
    """The JAX tree's leaves in the port's order: prefix layers, then the
    stacked periods unstacked."""
    out = [tree[k] for k in ("embed", "final_norm", "lm_head") if k in tree]
    layers = list(tree.get("prefix", []))
    stack = tree["stack"]
    periods = jax.tree.leaves(stack)[0].shape[0]
    for p in range(periods):
        for i in range(len(stack)):
            layers.append(jax.tree.map(lambda a: a[p], stack[f"sub{i}"]))
    return out, layers


def _compare_trees(mine, ref, tol, what, atol_of_max=None):
    """The port's params-shaped tree against the JAX model tree (its
    stacked periods taken apart).  With ``atol_of_max`` the absolute
    tolerance of each leaf is that fraction of its largest reference
    value."""
    def close(a, r, msg):
        r = np.asarray(r)
        kw = dict(tol)
        if atol_of_max is not None:
            kw["atol"] = atol_of_max * float(np.abs(r).max())
        np.testing.assert_allclose(np.asarray(a), r, err_msg=msg, **kw)

    top, layers = _jax_leaves(ref)
    keys = [k for k in ("embed", "final_norm", "lm_head") if k in mine]
    for k, r in zip(keys, top):
        close(mine[k], r, f"{what} {k}")
    assert len(mine["layers"]) == len(layers)
    for n, (a, r) in enumerate(zip(mine["layers"], layers)):
        flat_m, flat_r = _flat(a), _flat_jax(r)
        assert sorted(flat_m) == sorted(flat_r)
        for key, val in flat_r.items():
            close(flat_m[key].detach(), val, f"{what} layer {n} {key}")


def _flat(tree, prefix=""):
    """{path: tensor} of a tree of dicts and lists."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ------------------------------------------------------- chunked paths --
@pytest.mark.parametrize("S_,block,G", [(64, 16, 2), (48, 8, 1)])
def test_chunked_attention_matches_jax(S_, block, G):
    rng = np.random.RandomState(4)
    KV, hd = 2, 16
    q = rng.randn(2, S_, KV * G, hd).astype(np.float32)
    k = rng.randn(2, S_, KV, hd).astype(np.float32)
    v = rng.randn(2, S_, KV, hd).astype(np.float32)
    cot = rng.randn(*q.shape).astype(np.float32)
    assert S_ > 2 * block               # the chunked branch

    def ref(q, k, v):
        return jnp.sum(ref_attention(q, k, v, G, block=block) * cot)

    ref_out = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            G, block=block)
    ref_g = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = causal_attention_chunked(*ts, G, block=block)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), ts)
    for g, r in zip(grads, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("S_,chunk", [(100, 32), (128, 128), (40, 16)])
def test_chunked_scan_matches_jax(S_, chunk):
    rng = np.random.RandomState(5)
    Bz, din, ds = 2, 12, 4
    dt = (np.abs(rng.randn(Bz, S_, din)) * 0.1).astype(np.float32)
    Bt = rng.randn(Bz, S_, ds).astype(np.float32)
    Ct = rng.randn(Bz, S_, ds).astype(np.float32)
    x = rng.randn(Bz, S_, din).astype(np.float32)
    A = -(np.abs(rng.randn(din, ds)) + 0.1).astype(np.float32)
    cy = rng.randn(Bz, S_, din).astype(np.float32)
    ch = rng.randn(Bz, din, ds).astype(np.float32)
    args = (dt, Bt, Ct, x, A)

    def ref(*a):
        y, h = ref_scan(*a, chunk=chunk)
        return jnp.sum(y * cy) + jnp.sum(h * ch)

    ry, rh = ref_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    ref_g = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(*args)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = selective_scan_chunked(*ts, chunk=chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(rh), **TOL)
    grads = torch.autograd.grad((y * torch.from_numpy(cy)).sum()
                                + (h * torch.from_numpy(ch)).sum(), ts)
    for name, g, r in zip("dt Bt Ct x A".split(), grads, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------- loss --
def _live(params):
    """The port's params as leaves that require grad, and the list."""
    leaves = []

    def one(t):
        t = t.detach().clone().requires_grad_()
        leaves.append(t)
        return t

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return one(x)

    return walk(params), leaves


def _grad_tree(params, grads):
    it = iter(grads)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return next(it)

    return walk(params)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    cfg = ref_reduced_config(arch)
    jp, _ = _params(arch)
    b = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    return jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(cfg, p, b)))(jp)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg = reduced_config(arch)
    _, tp = _params(arch)
    ref_loss, ref_grads = _ref_value_and_grad(arch)
    live, leaves = _live(tp)
    loss = loss_fn(cfg, live, _torch_batch(_batch(cfg)))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), **TOL)
    grads = torch.autograd.grad(loss, leaves)
    _compare_trees(_grad_tree(tp, grads), ref_grads, TOL, f"{arch} grad")


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-moe", "jamba"])
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_changes_neither_loss_nor_grads(arch, policy):
    cfg = reduced_config(arch)
    _, tp = _params(arch)
    b = _torch_batch(_batch(cfg, seed=2))
    out = {}
    for pol in ("none_inference", policy):
        live, leaves = _live(tp)
        loss = loss_fn(cfg, live, b, remat_policy=pol)
        out[pol] = (loss.detach(), torch.autograd.grad(loss, leaves))
    (l0, g0), (l1, g1) = out["none_inference"], out[policy]
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
    for a, r in zip(g1, g0):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- optimizer --
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("grad_scale", [1e-3, 0.05])
def test_adamw_matches_jax(state_dtype, grad_scale):
    """Updates with the same gradients (numpy draws) on the parameters of
    reduced deepseek-moe.  JAX's update runs on the port's tree of layers
    (as numpy arrays), so that both quantise the same tensors in the same
    blocks of 128.

    With gradients of 1e-3 the global norm stays under the clip, whose
    scale is then exactly 1: the first update's int8 blocks are equal
    exactly.  With 0.05 the clip binds; its scale comes from the global
    norm, summed in another order, which may differ in its last bit, so a
    moment on a rounding boundary of its block may take the neighbouring
    int8 value: there the int8 values may differ by 1 at most (the block
    scales are held to 1e-6, the parameters, updated from the unrounded
    moments, to 1e-6).

    fp32 state: a second update reads the first one's moments back.  An
    int8 state is compared after one update only: XLA fuses the moments'
    multiply-adds that PyTorch rounds twice, so a moment read back may
    differ by one step of its block, which moves a parameter by more than
    1e-6."""
    _, tp = _params("deepseek-moe")
    ocfg = AdamWConfig(state_dtype=state_dtype, warmup_steps=2)
    rcfg = RefAdamWConfig(state_dtype=state_dtype, warmup_steps=2)
    rng = np.random.RandomState(6)
    jp = _to_jax(tp)
    jstate = ref_init_opt_state(rcfg, jp)
    tstate = init_opt_state(ocfg, tp)
    update = jax.jit(lambda p, g, st: ref_adamw_update(rcfg, p, g, st))
    updates = 2 if state_dtype == "float32" else 1
    for step in range(updates):
        jg = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32)
                          * grad_scale, jp)
        tg = _to_torch(jg)
        jp, jstate, jm = update(jp, jg, jstate)
        tp, tstate, tm = adamw_update(ocfg, tp, tg, tstate)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert (float(jm["grad_norm"]) < rcfg.grad_clip) == (grad_scale
                                                            < 0.01)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        _compare_flat(tp, jp, PARAM_TOL, f"params step {step}")
        for which in ("m", "v"):
            if state_dtype == "int8":
                mine, ref = _flat(tstate[which]), _flat_jax(jstate[which])
                assert sorted(mine) == sorted(ref)
                for key in mine:
                    where = f"{which} {key} step {step}"
                    q, rq = mine[key].numpy(), np.asarray(ref[key])
                    if not key.endswith("/q"):
                        np.testing.assert_allclose(q, rq, err_msg=where,
                                                   **PARAM_TOL)
                    elif grad_scale < 0.01:
                        np.testing.assert_array_equal(q, rq, err_msg=where)
                    else:
                        assert np.abs(q.astype(int) - rq).max() <= 1, where
            else:
                _compare_flat(tstate[which], jstate[which], PARAM_TOL,
                              f"{which} step {step}")
    assert int(tstate["step"]) == int(jstate["step"]) == updates


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _compare_flat(mine, ref, tol, what):
    """Two trees of the same structure, leaf by leaf by path."""
    mine, ref = _flat(mine), _flat_jax(ref)
    assert sorted(mine) == sorted(ref)
    for key in mine:
        np.testing.assert_allclose(mine[key].detach().numpy(),
                                   np.asarray(ref[key]),
                                   err_msg=f"{what} {key}", **tol)


# ---------------------------------------------------------- train step --
def test_train_step_with_accumulation_matches_jax():
    cfg = reduced_config("deepseek-moe")
    jcfg = ref_reduced_config("deepseek-moe")
    jp, tp = _params("deepseek-moe", seed=3)
    b = _batch(cfg, seed=4, batch=4)
    ref = jax.jit(ref_train_step(jcfg, accum=2))
    jstate = ref_init_opt_state(RefAdamWConfig(), jp)
    jp2, _, jm = ref(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()})
    step = make_train_step(cfg, accum=2)
    tp2, tstate, tm = step(tp, init_opt_state(AdamWConfig(), tp),
                           _torch_batch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **TOL)
    _compare_trees(tp2, jp2, PARAM_TOL, "params after the step")
    assert int(tstate["step"]) == 1


def test_train_step_accumulating_in_bf16_matches_jax():
    """``accum_dtype`` bf16, as the JAX dry run takes above 200B
    parameters: the micro-batches' gradients rounded to bf16 and summed
    there.  Held on AdamW's first moment, (1 - b1) x the clipped mean
    gradient: an fp32 gradient that the two packages round to adjacent
    bf16 values moves the sum by a bf16 step (2^-8) of that gradient, so
    rtol 2^-7 and an atol of 2^-8 of the leaf's largest value.  (The
    parameters are not compared: the first update is lr x the sign of the
    mean gradient, which flips where the two micro-batches cancel.)"""
    cfg = reduced_config("deepseek-moe")
    jcfg = ref_reduced_config("deepseek-moe")
    jp, tp = _params("deepseek-moe", seed=3)
    b = _batch(cfg, seed=5, batch=4)
    ref = jax.jit(ref_train_step(jcfg, accum=2, accum_dtype=jnp.bfloat16))
    _, jstate, jm = ref(jp, ref_init_opt_state(RefAdamWConfig(), jp),
                        {k: jnp.asarray(v) for k, v in b.items()})
    step = make_train_step(cfg, accum=2, accum_dtype=torch.bfloat16)
    _, tstate, tm = step(tp, init_opt_state(AdamWConfig(), tp),
                         _torch_batch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **TOL)
    _compare_trees(tstate["m"], jstate["m"], dict(rtol=2 ** -7),
                   "first moment", atol_of_max=2 ** -8)
    _, fstate, _ = make_train_step(cfg, accum=2)(
        tp, init_opt_state(AdamWConfig(), tp), _torch_batch(b))
    assert not all(torch.equal(a, f) for a, f in zip(
        tree_leaves(tstate["m"]), tree_leaves(fstate["m"])))


def test_train_step_through_the_plain_versions_on_cpu():
    """On CPU tensors ``use_kernels=True`` takes the kernels' plain
    versions, with autograd through them (on CUDA tensors the kernels
    refuse inputs that require grad): the same step as the chunked paths
    within TOL (jamba: attention, mamba and MoE layers)."""
    cfg = reduced_config("jamba")
    _, tp = _params("jamba")
    b = _torch_batch(_batch(cfg, seed=6))
    out = [make_train_step(cfg, use_kernels=k)(
        tp, init_opt_state(AdamWConfig(), tp), b) for k in (False, True)]
    (p0, _, m0), (p1, _, m1) = out
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m1[key], m0[key], **TOL)
    for a, r in zip(tree_leaves(p1), tree_leaves(p0)):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_accum_steps_match_jax(arch):
    """Every shape, data-shard count and sequence sharding."""
    cfg, jcfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        for n_data in (1, 4, 16, 256):
            for seq_shard in (False, True):
                assert accum_steps(cfg, shape, n_data, seq_shard) == \
                    ref_accum_steps(jcfg, REF_SHAPES[name], n_data,
                                    seq_shard), (name, n_data, seq_shard)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(arch):
    """Meta tensors with the shapes and dtypes of JAX's
    ``ShapeDtypeStruct``s, for every shape."""
    cfg, jcfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        mine = input_specs(cfg, shape)
        ref = ref_input_specs(jcfg, REF_SHAPES[name])
        assert sorted(mine) == sorted(ref), name
        for key, spec in ref.items():
            assert mine[key].device.type == "meta"
            assert tuple(mine[key].shape) == tuple(spec.shape), (name, key)
            assert str(mine[key].dtype) == f"torch.{spec.dtype}", (name, key)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_train_step_every_arch(arch):
    """The analogue of tests/test_models_smoke.py's one train step: a
    finite loss and gradient norm, and every parameter moved."""
    cfg = reduced_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (2, 32)).astype(np.int32)
    b = {"labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    if cfg.embed_stub:
        b["embeds"] = torch.from_numpy(
            rng.randn(2, 32, cfg.d_model).astype(np.float32) * 0.02)
    else:
        b["tokens"] = torch.from_numpy(toks)
    step = make_train_step(cfg)
    new, _, met = step(params, init_opt_state(AdamWConfig(), params), b)
    assert bool(torch.isfinite(met["loss"])) and float(met["loss"]) > 0
    assert bool(torch.isfinite(met["grad_norm"]))
    for a, p in zip(tree_leaves(new), tree_leaves(params)):
        assert not torch.equal(a, p)


# ------------------------------------------------- data and checkpoints --
def test_shard_queue_order_and_recovery(tmp_path):
    q = DurableShardQueue(str(tmp_path))
    q.enqueue_shards([{"shard": i} for i in range(10)])
    seen = [q.next_shard()["shard"] for _ in range(4)]
    assert seen == [0, 1, 2, 3]
    q.commit_consumed(2)                # commit only the first three
    q.close()
    q2 = DurableShardQueue(str(tmp_path))   # crash: a new process view
    assert q2.recover() == 3
    assert q2.next_shard()["shard"] == 3, "uncommitted shard re-delivered"
    q2.close()


def test_exactly_once_across_crash(tmp_path):
    q = DurableShardQueue(str(tmp_path))
    q.enqueue_shards([{"shard": i} for i in range(8)])
    committed = []
    for i in range(5):
        s = q.next_shard()
        if i < 3:                       # only 3 consumptions get committed
            q.commit_consumed(s["_queue_index"])
            committed.append(s["shard"])
    q.close()                           # crash after
    q2 = DurableShardQueue(str(tmp_path))
    q2.recover()
    while (s := q2.next_shard()) is not None:
        q2.commit_consumed(s["_queue_index"])
        committed.append(s["shard"])
    assert committed == list(range(8))  # exactly once, in order
    q2.close()


def test_train_crash_restart_end_to_end(tmp_path):
    """A real abrupt exit and restart through the command line: the second
    run resumes from the last checkpoint, and the shards consumed across
    both runs, counted from the committed steps, are each taken once."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "yi-6b", "--steps", "12", "--ckpt-every", "4", "--ckpt-dir",
            str(tmp_path), "--batch", "2", "--seq-len", "32", "--device",
            "cpu"]
    p1 = subprocess.run(args + ["--crash-at", "6"], env=env,
                        capture_output=True, text=True, cwd=REPO)
    assert p1.returncode == 42, p1.stderr[-2000:]
    assert "step 4: " in p1.stdout and "[checkpointed]" in p1.stdout
    p2 = subprocess.run(args, env=env, capture_output=True, text=True,
                        cwd=REPO)
    assert p2.returncode == 0, p2.stderr[-2000:]
    assert "[recovery] resumed from step 4" in p2.stdout
    assert "done: 12 steps" in p2.stdout
    steps = [line.split(":")[0] for line in p2.stdout.splitlines()
             if line.startswith("step ")]
    assert steps == [f"step {i}" for i in range(5, 13)]
    q = DurableShardQueue(str(tmp_path / "data"))
    assert q.recover() == 12            # the cursor: shards 0-11 committed
    q.close()


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    from repro_torch.checkpoint import DurableCheckpointer
    cfg = dataclasses.replace(reduced_config("falcon-mamba"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(2))
    state = init_opt_state(AdamWConfig(state_dtype="int8"), params)
    ck = DurableCheckpointer(str(tmp_path), background=False)
    ck.save(1, {0: {"params": state_to_numpy(params),
                    "opt": state_to_numpy(state)}})
    _, shards, _ = ck.restore_latest()
    back = {k: state_from_numpy(v, "cpu", cfg.param_dtype)
            for k, v in shards[0].items()}
    for a, b in zip(tree_leaves(back), tree_leaves({"params": params,
                                                    "opt": state})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {t.dtype for t in tree_leaves(back["params"])} == {
        torch.bfloat16, torch.float32}
