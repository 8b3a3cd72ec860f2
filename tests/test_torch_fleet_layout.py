"""The port's warp-tiled fleet state layout against the reference's (CPU).

The port keeps every 2-D fleet field in warp tiles ``[T, X, 32]`` (entry
j of instance i at ``((i // 32) * X + j) * 32 + i % 32``, the lanes past
N zero); the JAX package keeps ``[N, X]``.  The conversion happens only
at the edges of ``repro_torch.fleet.torchexec``, and these tests hold
each edge to the reference layout with exact equality:

* ``state_to_torch`` then ``state_to_numpy`` gives back the reference
  state, for the 8 queues x 3 memory models templates, with every
  instance's row made different so that a transposition error shows;
* ``TorchBackend.rejoin``, ``retire_resident`` and ``counts`` have the
  effect on the port's state that ``NumpyBackend`` (the reference layout)
  has on its own;
* the tiled template row is in warp tiles, contiguous, its padding zero,
  and equal to the converted reference state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.harness import ALL_QUEUES  # noqa: E402
from repro.fleet import build_template as ref_build_template  # noqa: E402
from repro.fleet.state import replicate as ref_replicate  # noqa: E402
from repro_torch.fleet import build_fleet, FleetConfig  # noqa: E402
from repro_torch.fleet.runner import (NumpyBackend, RESIDENT,  # noqa: E402
                                      _replay)
from repro_torch.fleet.state import export_instance, replicate  # noqa: E402
from repro_torch.fleet.torchexec import (_ARRAY_FIELDS,  # noqa: E402
                                         _SCALAR_FIELDS, TILE, TorchBackend,
                                         from_tiles, n_tiles, state_to_numpy,
                                         state_to_torch, tile_row, to_tiles)

MODELS = ["optane-clwb", "eadr", "cxl"]


def _reference_fields(fs) -> dict:
    """A reference ``FleetState`` as ``state_to_numpy`` keys its arrays:
    int32 counts and the guard slots stacked as ``[N, n_slots]`` (one
    column of zeros when the template has none)."""
    out = {k: np.asarray(getattr(fs, k)) for k in
           _ARRAY_FIELDS + _SCALAR_FIELDS}
    out["counts"] = fs.counts.astype(np.int32)
    cols = [fs.slots[a] for a in fs.dims.slot_attrs]
    n = fs.head.shape[0]
    out["slots"] = (np.stack(cols, axis=-1) if cols
                    else np.zeros((n, 1))).astype(np.int32)
    return out


def _scrambled(template, n: int, seed: int):
    """``replicate``'s state with every entry of every instance redrawn,
    so that no two rows of a field are alike."""
    fs = ref_replicate(template.row, template.dims, n)
    rng = np.random.RandomState(seed)
    for name in _ARRAY_FIELDS + _SCALAR_FIELDS + ("counts",):
        arr = getattr(fs, name)
        hi = 2 if arr.dtype == np.bool_ else (255 if arr.dtype == np.uint8
                                              else 1 << 20)
        arr[...] = rng.randint(0, hi, size=arr.shape).astype(arr.dtype)
    for attr in fs.slots:
        fs.slots[attr][...] = rng.randint(0, 1 << 20, size=n)
    return fs


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("queue", list(ALL_QUEUES))
def test_round_trip_gives_back_the_reference_state(queue, model):
    n = 7
    fs = _scrambled(ref_build_template(queue, model, ops=96), n, seed=11)
    st = state_to_torch(fs, "cpu")
    for key in _ARRAY_FIELDS + ("counts", "slots"):
        assert st[key].shape[0] == n_tiles(n) and st[key].shape[2] == TILE
        assert st[key].is_contiguous(), key
        assert not st[key][-1, :, n % TILE:].any(), key     # padding
    back = state_to_numpy(st)
    want = _reference_fields(fs)
    assert back.keys() == want.keys()
    for key, val in want.items():
        assert back[key].shape == val.shape, key
        assert np.array_equal(back[key], val), key


@pytest.mark.parametrize("queue", ["DurableMSQ", "OptUnlinkedQ",
                                   "OptLinkedQ", "LinkedQ"])
def test_rejoin_retire_and_counts_match_the_reference_layout(queue):
    """Rejoin one instance with a row exported from a real harness that
    ran 30 ops, retire another: the port's state (read back in the
    reference layout) equals ``NumpyBackend``'s, and so do the counts."""
    n = 6
    fleet = build_fleet(FleetConfig(queue=queue, instances=n, ops=60,
                                    chunk=30, backend="torch", device="cpu",
                                    seed=4))
    t = fleet.template
    row = export_instance(_replay(t, fleet.kinds, 2, 30), t.dims)
    assert row is not None
    port = TorchBackend(t, n, "cpu", use_kernel=False)
    ref = NumpyBackend(t, replicate(t.row, t.dims, n))
    for be in (port, ref):
        be.rejoin(4, row)
        be.retire_resident(1)
    got, want = state_to_numpy(port.st), _reference_fields(ref.st)
    for key, val in want.items():
        assert np.array_equal(got[key], val), key
    assert got["bail_at"][1] == RESIDENT and got["active"][4]
    counts = port.counts()
    assert counts.dtype == np.int64 and counts.flags.c_contiguous
    assert np.array_equal(counts, ref.counts())
    assert not np.array_equal(counts[4], counts[0])


@pytest.mark.parametrize("n", [5, 32, 70])
def test_tiled_row_is_in_warp_tiles(n):
    t = ref_build_template("OptLinkedQ", "optane-clwb", ops=96)
    st = tile_row(t.row, t.dims, n, "cpu")
    ref = state_to_torch(ref_replicate(t.row, t.dims, n), "cpu")
    for key in _ARRAY_FIELDS + ("counts",):
        width = 12 if key == "counts" else len(t.row[key])
        assert st[key].shape == (n_tiles(n), width, TILE), key
        assert st[key].is_contiguous(), key
        assert np.array_equal(st[key][(n - 1) // TILE, :, (n - 1) % TILE]
                              .numpy(), np.asarray(t.row[key], np.int64)
                              .astype(st[key].numpy().dtype)), key
        assert torch.equal(st[key], ref[key]), key


def test_tiles_round_trip():
    a = torch.arange(70 * 3, dtype=torch.int32).view(70, 3)
    t = to_tiles(a)
    assert t.shape == (3, 3, TILE)
    assert int(t[1, 2, 5]) == int(a[37, 2])
    assert not t[2, :, 6:].any()
    assert torch.equal(from_tiles(t, 70), a)
