"""The port's durable serving on the CPU: the analogues of
``test_serving_durable_roundtrip`` and ``test_serving_crash_replays_pending``
(tests/test_pipeline_serving.py), and token-for-token equality with the
JAX package's ``ServeEngine`` for the same requests and parameters
(reduced yi-6b, falcon-mamba and deepseek-moe, fp32; the MoE one with a
capacity that binds, so that both drop the same pairs): prompts of unequal
length (padded with token 0), teacher-forced prompt, greedy argmax, one
fence per batch.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.serving import DurableRequestQueue as RefQueue  # noqa: E402
from repro.serving import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import (DurableRequestQueue,  # noqa: E402
                                 ServeEngine)


def test_serving_durable_roundtrip(tmp_path):
    cfg = reduced_config("yi-6b")
    q = DurableRequestQueue(str(tmp_path))
    reqs = [{"id": f"r{i}", "prompt": [1 + i, 2, 3]} for i in range(6)]
    q.submit(reqs)
    eng = ServeEngine(cfg, q, max_len=32, device="cpu")
    n = eng.run(batch_size=4, max_new=4)
    assert n == 6
    assert eng.steps == 2 * (3 + 4 - 1)     # two batches, one step a token
    resps = q.responses()
    assert sorted(r["id"] for r in resps) == sorted(r["id"] for r in reqs)
    assert all(len(r["tokens"]) == 4 for r in resps)
    q.close()


def test_serving_crash_replays_pending(tmp_path):
    cfg = reduced_config("yi-6b")
    q = DurableRequestQueue(str(tmp_path))
    q.submit([{"id": f"r{i}", "prompt": [i + 1, 5]} for i in range(6)])
    eng = ServeEngine(cfg, q, max_len=32, device="cpu")
    eng.serve_once(batch_size=2, max_new=2)      # 2 responded
    q.close()                                    # crash
    q2 = DurableRequestQueue(str(tmp_path))
    pending = q2.recover()
    assert pending == 4
    eng2 = ServeEngine(cfg, q2, max_len=32, device="cpu")
    eng2.run(batch_size=4, max_new=2)
    assert len(q2.responses()) == 6
    ids = [r["id"] for r in q2.responses()]
    assert len(set(ids)) == 6
    q2.close()


def test_tokens_equal_the_jax_engine(tmp_path):
    cfg = ref_reduced_config("yi-6b")
    jp = ref_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    reqs = [{"id": f"r{i}", "prompt": rng.randint(
        0, cfg.vocab, (2 + i % 4,)).tolist()} for i in range(7)]
    ref_q = RefQueue(str(tmp_path / "jax"))
    ref_q.submit(reqs)
    RefEngine(cfg, ref_q, params=jp, max_len=32).run(batch_size=3,
                                                     max_new=6)
    q = DurableRequestQueue(str(tmp_path / "torch"))
    q.submit(reqs)
    params = params_from_jax(reduced_config("yi-6b"),
                             jax.tree.map(np.asarray, jp))
    ServeEngine(reduced_config("yi-6b"), q, params=params, max_len=32,
                device="cpu").run(batch_size=3, max_new=6)
    assert q.responses() == ref_q.responses()
    assert len(q.responses()) == 7
    ref_q.close()
    q.close()


def test_mamba_tokens_equal_the_jax_engine(tmp_path):
    """The mamba decode step carries its state (``h`` and the conv window)
    from step to step in the cache: tokens equal only if it advances."""
    cfg = ref_reduced_config("falcon-mamba")
    jp = ref_init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    reqs = [{"id": f"m{i}", "prompt": rng.randint(
        0, cfg.vocab, (3 + i % 3,)).tolist()} for i in range(5)]
    ref_q = RefQueue(str(tmp_path / "jax"))
    ref_q.submit(reqs)
    RefEngine(cfg, ref_q, params=jp, max_len=32).run(batch_size=2,
                                                     max_new=6)
    q = DurableRequestQueue(str(tmp_path / "torch"))
    q.submit(reqs)
    mine = reduced_config("falcon-mamba")
    params = params_from_jax(mine, jax.tree.map(np.asarray, jp))
    eng = ServeEngine(mine, q, params=params, max_len=32, device="cpu")
    eng.run(batch_size=2, max_new=6)
    assert q.responses() == ref_q.responses()
    assert len(q.responses()) == 5
    assert eng.steps == 2 * (4 + 6 - 1) + (5 + 6 - 1)
    ref_q.close()
    q.close()


def test_moe_tokens_equal_the_jax_engine(tmp_path):
    """Reduced deepseek-moe (its dense first layer, then MoE layers) with
    capacity factor 1.0: a decode step's batch of 3 tokens is one chunk
    with a capacity of one row an expert, so pairs are dropped, and the
    tokens equal only if both engines drop the same ones."""
    cfg = dataclasses.replace(ref_reduced_config("deepseek-moe"),
                              capacity_factor=1.0)
    jp = ref_init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.RandomState(3)
    reqs = [{"id": f"e{i}", "prompt": rng.randint(
        0, cfg.vocab, (2 + i % 3,)).tolist()} for i in range(6)]
    ref_q = RefQueue(str(tmp_path / "jax"))
    ref_q.submit(reqs)
    RefEngine(cfg, ref_q, params=jp, max_len=32).run(batch_size=3,
                                                     max_new=6)
    q = DurableRequestQueue(str(tmp_path / "torch"))
    q.submit(reqs)
    mine = dataclasses.replace(reduced_config("deepseek-moe"),
                               capacity_factor=1.0)
    params = params_from_jax(mine, jax.tree.map(np.asarray, jp))
    ServeEngine(mine, q, params=params, max_len=32, device="cpu").run(
        batch_size=3, max_new=6)
    assert q.responses() == ref_q.responses()
    assert len(q.responses()) == 6
    ref_q.close()
    q.close()


def test_engine_refuses_a_cache_too_short(tmp_path):
    cfg = reduced_config("yi-6b")
    q = DurableRequestQueue(str(tmp_path))
    q.submit([{"id": "r0", "prompt": [1, 2, 3, 4]}])
    eng = ServeEngine(cfg, q, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.run(batch_size=1, max_new=6)
    q.close()
