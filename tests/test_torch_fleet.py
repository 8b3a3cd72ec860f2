"""The PyTorch port's fleet executor against the JAX package (CPU).

The port (``src/repro_torch/``) keeps its own copies of the simulator and
the fleet lowering, and steps the fleet with the plain PyTorch version of
its chunk kernel on CPU tensors.  These tests hold it to the reference
package with exact integer equality -- counts and state are integers, so
there is no tolerance:

* the port's templates (dims, exported row, both opcode tables) equal the
  reference's for all 8 queues x 3 memory models;
* the port's ``run_fleet(backend="torch")`` counts equal the reference
  numpy stepper's, and its ``check_instances`` is 8/8 against
  ``run_batched``, for all 8 queues x 3 models;
* bail/rejoin on unclamped dequeue-heavy plans and the 400-op epoch
  reclamation cells stay exact;
* the plain stepper's record of the positions a chunk reaches (what the
  byte bound counts) covers every byte the chunk changes.

The full state after every chunk is held to the JAX opcode stepper and
the Pallas kernel in ``tests/test_torch_fleet_jax.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.harness import ALL_QUEUES  # noqa: E402
from repro.fleet import FleetConfig as RefConfig  # noqa: E402
from repro.fleet import build_template as ref_build_template  # noqa: E402
from repro.fleet import run_fleet as ref_run_fleet  # noqa: E402
from repro.fleet.lowering import encode_program as ref_encode  # noqa: E402
from repro_torch.fleet import (FleetConfig, build_fleet,  # noqa: E402
                               build_template, check_instances, run_fleet)
from repro_torch.fleet.lowering import encode_program  # noqa: E402
from repro_torch.fleet.torchexec import _ARRAY_FIELDS, tile_row  # noqa: E402
from repro_torch.kernels.fleet_step import (FleetStepPrograms,  # noqa: E402
                                            fleet_step_plain)

MODELS = ["optane-clwb", "eadr", "cxl"]


def _assert_all_ok(res, sample):
    rows = check_instances(res, sample=sample)
    bad = [r for r in rows if not r["ok"]]
    assert not bad, (
        f"{len(bad)}/{len(rows)} sampled instances diverged; first: "
        f"instance {bad[0]['instance']}\n fleet {bad[0]['fleet']}\n "
        f"ref   {bad[0]['ref']}")
    return rows


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("queue", list(ALL_QUEUES))
def test_template_matches_reference(queue, model):
    """Same FleetDims, same exported row, same opcode tables."""
    mine = build_template(queue, model, ops=96)
    ref = ref_build_template(queue, model, ops=96)
    assert mine.dims.__dict__ == ref.dims.__dict__
    assert mine.row.keys() == ref.row.keys()
    for key, val in ref.row.items():
        if isinstance(val, np.ndarray):
            assert np.array_equal(mine.row[key], val), key
            assert mine.row[key].dtype == val.dtype, key
        else:
            assert mine.row[key] == val, key
    for p, q in zip(mine.programs, ref.programs):
        a = encode_program(p, mine.dims.slot_attrs)
        b = ref_encode(q, ref.dims.slot_attrs)
        assert a.n_micro == b.n_micro
        assert np.array_equal(a.table, b.table)
        assert np.array_equal(p.base_counts, q.base_counts)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("queue", list(ALL_QUEUES))
def test_counts_match_numpy_reference(queue, model):
    """9 instances x 80 ops, chunk 32: every count equal to the reference
    numpy stepper's, and 8 sampled instances bit-identical to
    ``run_batched``."""
    cell = dict(queue=queue, model=model, instances=9, ops=80, chunk=32,
                seed=3)
    res = run_fleet(FleetConfig(backend="torch", device="cpu", **cell))
    ref = ref_run_fleet(RefConfig(backend="numpy", **cell))
    assert res.backend == "torch" and res.device == "cpu"
    assert np.array_equal(res.counts, ref.counts)
    assert len(_assert_all_ok(res, sample=8)) == 8


@pytest.mark.parametrize("queue", ["MSQ", "DurableMSQ", "LinkedQ",
                                   "NVTraverseQ", "OptUnlinkedQ"])
def test_bail_rejoin_exact(queue):
    """Deq-heavy unclamped plans drain queues: instances bail out of the
    tensor program, replay on real harnesses, rejoin -- still exact."""
    rng = np.random.default_rng(5)
    cell = dict(queue=queue, model="cxl", instances=6, ops=60, chunk=20,
                prefill=3, seed=2)
    kinds = (rng.random((60, 6)) < 0.65).astype(np.uint8)
    res = run_fleet(FleetConfig(backend="torch", device="cpu", **cell),
                    kinds=kinds)
    ref = ref_run_fleet(RefConfig(backend="numpy", **cell), kinds=kinds)
    assert res.bails > 0, "plans were meant to force empty-dequeue bails"
    assert (res.bails, res.residents) == (ref.bails, ref.residents)
    assert np.array_equal(res.counts, ref.counts)
    _assert_all_ok(res, sample=6)


@pytest.mark.parametrize("queue", ["UnlinkedQ", "OptLinkedQ"])
def test_epoch_reclamation_exact(queue):
    """400 ops cross several 64-op epoch advances: retired nodes move
    through limbo to the free stacks and are reallocated -- still exact."""
    cell = dict(queue=queue, model="optane-clwb", instances=4, ops=400,
                chunk=64, seed=7)
    res = run_fleet(FleetConfig(backend="torch", device="cpu", **cell))
    ref = ref_run_fleet(RefConfig(backend="numpy", **cell))
    assert res.bails == 0
    assert np.array_equal(res.counts, ref.counts)
    _assert_all_ok(res, sample=4)


@pytest.mark.parametrize("queue,ops", [("DurableMSQ", 96),
                                       ("OptUnlinkedQ", 96),
                                       ("UnlinkedQ", 200),
                                       ("OptLinkedQ", 200)])
def test_reach_record_covers_every_change(queue, ops):
    """``fleet_step_plain(reach=...)`` marks the positions a chunk reads or
    writes.  Recording leaves the result as it is, every state entry the
    chunk changes is marked, and reads add positions beyond the changes.
    200 ops cross three epoch advances, so limbo entries are freed."""
    n = 9
    fleet = build_fleet(FleetConfig(queue=queue, instances=n, ops=ops,
                                    chunk=ops, backend="torch", device="cpu",
                                    seed=7))
    t = fleet.template
    progs = FleetStepPrograms(t.programs, t.dims)
    kinds = torch.from_numpy(np.ascontiguousarray(fleet.kinds))
    before = tile_row(t.row, t.dims, n, "cpu")
    plain = {k: v.clone() for k, v in before.items()}
    rec = {k: v.clone() for k, v in before.items()}
    reach = {k: torch.zeros_like(before[k], dtype=torch.bool)
             for k in _ARRAY_FIELDS}
    err = torch.zeros(1, dtype=torch.int32)
    fleet_step_plain(plain, kinds, 0, progs, err)
    fleet_step_plain(rec, kinds, 0, progs, err, reach=reach)
    assert int(err) == 0
    for key in before:
        assert torch.equal(plain[key], rec[key]), key
    reached = changed = 0
    for key in _ARRAY_FIELDS:
        diff = rec[key] != before[key]
        assert not (diff & ~reach[key]).any(), f"{key}: change not reached"
        reached += int(reach[key].sum())
        changed += int(diff.sum())
    assert changed > 0 and reached > changed
    assert reach["ring_p"].any() and reach["cached"].any()
    if t.dims.uses_ssmem and ops >= 200:
        assert (rec["epoch"] - before["epoch"] == 3).all()
        # the free stack starts empty and is filled only by reclamation
        assert (before["nfree"] == 0).all() and (rec["nfree"] > 0).all()
        assert reach["limbo_e"].any() and reach["free_p"].any()
