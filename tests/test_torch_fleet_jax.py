"""The port's chunk stepper against the JAX package's (CPU).

One seeded fleet state goes through both packages chunk by chunk: the
reference's ``make_opcode_chunk_fn`` (the body of the Pallas kernel) and
the port's ``fleet_step`` on CPU tensors (its plain PyTorch version).
After every chunk the whole state -- every line plane, ring, stack, limbo
entry, slot, scalar and count -- must be equal.  The counts must also
equal the Pallas kernel's own, run in interpret mode as the JAX package's
tests run it.  Exact integer equality throughout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.harness import ALL_QUEUES  # noqa: E402
from repro.fleet import FleetConfig as RefConfig  # noqa: E402
from repro.fleet import build_template as ref_build_template  # noqa: E402
from repro.fleet import run_fleet as ref_run_fleet  # noqa: E402
from repro.fleet import jaxexec  # noqa: E402
from repro.fleet.state import replicate  # noqa: E402
from repro_torch.fleet import FleetConfig, build_template  # noqa: E402
from repro_torch.fleet import fleet_kinds, run_fleet  # noqa: E402
from repro_torch.fleet.torchexec import (state_to_numpy,  # noqa: E402
                                         state_to_torch, tile_row)
from repro_torch.kernels.fleet_step import (FleetStepPrograms,  # noqa: E402
                                            fleet_step)

STATE_CELLS = [(q, "optane-clwb") for q in ALL_QUEUES] + [
    (q, m) for q in ("DurableMSQ", "OptLinkedQ") for m in ("eadr", "cxl")]


def _jax_state(template, n):
    """The reference's field dict, as tests/test_fleet_opcode.py builds
    it for the opcode chunk fn."""
    state = replicate(template.row, template.dims, n)
    st = {f: getattr(state, f) for f in jaxexec._ARRAY_FIELDS}
    for f in jaxexec._SCALAR_FIELDS:
        st[f] = getattr(state, f)
    st["counts"] = state.counts.astype(np.int32)
    for attr, arr in state.slots.items():
        st["slot_" + attr] = arr
    return st


@pytest.mark.parametrize("queue", ["MSQ", "DurableMSQ", "OptUnlinkedQ",
                                   "OptLinkedQ"])
def test_state_to_torch_takes_both_reference_forms(queue):
    """The reference's ``FleetState`` (``replicate``'s output) and its
    field dict carry over to the same state, which is also the port's own
    template row tiled on the device."""
    n = 5
    ref_t = ref_build_template(queue, "optane-clwb", ops=96)
    from_state = state_to_torch(replicate(ref_t.row, ref_t.dims, n), "cpu")
    from_dict = state_to_torch(_jax_state(ref_t, n), "cpu")
    mine = build_template(queue, "optane-clwb", ops=96)
    tiled = tile_row(mine.row, mine.dims, n, "cpu")
    assert from_state.keys() == from_dict.keys() == tiled.keys()
    for key, val in tiled.items():
        assert torch.equal(from_state[key], val), key
        assert torch.equal(from_dict[key], val), key


@pytest.mark.parametrize("queue,model", STATE_CELLS)
def test_state_after_every_chunk_matches_jax_opcode(queue, model):
    n, ops, chunk = 9, 80, 32
    ref_t = ref_build_template(queue, model, ops=ops)
    st_ref = _jax_state(ref_t, n)
    fn = jax.jit(jaxexec.make_opcode_chunk_fn(jax, ref_t.programs,
                                              ref_t.dims))
    mine = build_template(queue, model, ops=ops)
    progs = FleetStepPrograms(mine.programs, mine.dims)
    st = state_to_torch(st_ref, "cpu")
    err = torch.zeros(1, dtype=torch.int32)
    kinds = fleet_kinds(n, ops, seed=3)
    adv_seen = False
    for start in range(0, ops, chunk):
        kc = kinds[start:start + chunk]
        st_ref = fn(st_ref, np.ascontiguousarray(kc.T),
                    np.arange(start, start + kc.shape[0], dtype=np.int32))
        fleet_step(st, torch.from_numpy(np.ascontiguousarray(kc)), start,
                   progs, err)
        assert int(err) == 0
        got = state_to_numpy(st)
        want = state_to_torch({k: np.asarray(v) for k, v in st_ref.items()},
                              "cpu")
        for key, val in state_to_numpy(want).items():
            assert np.array_equal(got[key], val), (key, start)
        adv_seen |= bool((got["epoch"] > ref_t.row["epoch"]).any())
    assert adv_seen or not mine.dims.uses_ssmem, \
        "the cell was meant to cross an epoch advance"
    assert fleet_step.launches == 0


@pytest.mark.parametrize("queue", ["DurableMSQ", "OptLinkedQ"])
def test_counts_match_pallas_interpret(queue):
    """The Pallas fleet kernel itself (interpret mode on the CPU)."""
    cell = dict(queue=queue, model="optane-clwb", instances=5, ops=96,
                chunk=48, seed=3)
    res = run_fleet(FleetConfig(backend="torch", device="cpu", **cell))
    ref = ref_run_fleet(RefConfig(backend="pallas", **cell))
    assert ref.backend == "pallas"
    assert np.array_equal(res.counts, ref.counts)
