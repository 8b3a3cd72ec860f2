"""Rules the PyTorch port keeps (CPU).

* ``src/repro_torch/`` and ``chip_smoke.py`` import neither jax nor the
  JAX package ``repro``;
* the numpy-only modules the port copies from ``repro`` stay equal to
  their originals line for line (one import in ``core/burst.py`` is made
  relative), so the copies cannot drift silently;
* the fleet defaults to the CUDA kernel on the CUDA device, and asking for
  it where CUDA is missing raises instead of falling back;
* the kernel wrapper runs its plain version on CPU tensors and counts no
  launch.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fleet import (FleetConfig, build_template,  # noqa: E402
                               run_fleet)
from repro_torch.fleet.torchexec import TorchBackend, tile_row  # noqa: E402
from repro_torch.kernels.fleet_step import (FleetStepPrograms,  # noqa: E402
                                            fleet_step)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

COPIED = ["core/" + m + ".py" for m in (
    "memmodel", "nvram", "records", "opsched", "contention", "scheduler",
    "ssmem", "queue_base", "msq", "durable_msq", "izraelevitz", "unlinked",
    "linked", "opt_unlinked", "opt_linked", "harness", "burst")] + [
    "fleet/lowering.py", "fleet/state.py", "fleet/stepper.py"]
BURST_IMPORT = ("    from repro.fleet.lowering import (FleetLoweringError, "
                "encode_program,\n",
                "    from ..fleet.lowering import (FleetLoweringError, "
                "encode_program,\n")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}")


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_original(rel):
    mine = (PORT / rel).read_text().splitlines(keepends=True)
    ref = (REPO / "src" / "repro" / rel).read_text().splitlines(
        keepends=True)
    if rel == "core/burst.py":
        assert ref.count(BURST_IMPORT[0]) == 1
        ref = [BURST_IMPORT[1] if line == BURST_IMPORT[0] else line
               for line in ref]
    assert mine == ref, f"{rel} drifted from src/repro/{rel}"


def test_fleet_defaults_to_the_cuda_kernel():
    cfg = FleetConfig()
    assert cfg.backend == "cuda" and cfg.device == "cuda"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_cuda_backend_raises_without_cuda(device, monkeypatch):
    """No fallback: without a CUDA device the kernel backend raises,
    before any work is done, and so does the backend object itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FleetConfig(queue="MSQ", instances=4, ops=8, chunk=8,
                      backend="cuda", device=device)
    with pytest.raises((RuntimeError, ValueError)):
        run_fleet(cfg)
    t = build_template("MSQ", "optane-clwb", ops=8)
    with pytest.raises((RuntimeError, ValueError)):
        TorchBackend(t, 4, device, use_kernel=True)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    t = build_template("OptLinkedQ", "optane-clwb", ops=16)
    progs = FleetStepPrograms(t.programs, t.dims)
    st = tile_row(t.row, t.dims, 3, "cpu")
    before = {k: v.clone() for k, v in st.items()}
    err = torch.zeros(1, dtype=torch.int32)
    kinds = torch.from_numpy(np.zeros((4, 3), dtype=np.uint8))
    launches = fleet_step.launches
    fleet_step(st, kinds, 0, progs, err)
    assert fleet_step.launches == launches == 0
    assert int(err) == 0
    assert (st["length"] == before["length"] + 4).all()
    assert (st["counts"] != before["counts"]).any()


def test_error_word_flags_out_of_range_index():
    """An index outside its row is flagged, not clamped silently: a
    corrupted head makes the ring position negative."""
    t = build_template("DurableMSQ", "optane-clwb", ops=16)
    be = TorchBackend(t, 2, "cpu", use_kernel=False)
    be.st["head"][1] = -1000
    be.run_chunk(np.ones((2, 2), dtype=np.uint8), 0)
    with pytest.raises(RuntimeError, match="ring"):
        be.poll()
