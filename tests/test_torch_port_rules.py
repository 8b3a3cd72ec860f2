"""Rules the PyTorch port keeps (CPU).

* ``src/repro_torch/``, ``chip_smoke.py`` and ``chip_variants.py``
  import neither jax nor the JAX package ``repro``;
* the numpy-only modules the port copies from ``repro`` stay equal to
  their originals line for line (each import of ``repro`` in them is made
  relative, and nothing else changes), so the copies cannot drift
  silently;
* the fleet defaults to the CUDA kernel on the CUDA device, and asking for
  it where CUDA is missing raises instead of falling back; so do the
  serving engine and its command line, and the training command line;
* the kernel wrapper runs its plain version on CPU tensors and counts no
  launch;
* the attention and scan kernels, which have no backward, refuse a launch
  whose output autograd would need.
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
    "fleet/lowering.py", "fleet/state.py", "fleet/stepper.py",
    "models/config.py", "persist/__init__.py", "persist/wal.py",
    "persist/cursors.py", "serving/request_queue.py", "data/__init__.py",
    "data/pipeline.py", "checkpoint/__init__.py",
    "checkpoint/checkpointer.py"] + sorted(
    "configs/" + p.name for p in (REPO / "src" / "repro" / "configs").glob(
        "*.py"))
CONFIG_IMPORT = ("from repro.models.config import ModelConfig\n",
                 "from ..models.config import ModelConfig\n")
# the lines of each copy that change: its imports of repro made relative
CHANGED_IMPORT = {
    "core/burst.py": [(
        "    from repro.fleet.lowering import (FleetLoweringError, "
        "encode_program,\n",
        "    from ..fleet.lowering import (FleetLoweringError, "
        "encode_program,\n")],
    "configs/__init__.py": [(
        "from repro.models.config import ModelConfig, SHAPES, "
        "ShapeConfig\n",
        "from ..models.config import ModelConfig, SHAPES, ShapeConfig\n")],
    "serving/request_queue.py": [(
        "from repro.persist.wal import WriteAheadLog\n",
        "from ..persist.wal import WriteAheadLog\n")],
    "data/pipeline.py": [
        ("from repro.persist.cursors import CursorFile\n",
         "from ..persist.cursors import CursorFile\n"),
        ("from repro.persist.wal import WriteAheadLog\n",
         "from ..persist.wal import WriteAheadLog\n")],
}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "chip_variants.py"]


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
    if rel in CHANGED_IMPORT:
        changes = CHANGED_IMPORT[rel]
    elif rel.startswith("configs/"):
        changes = [CONFIG_IMPORT]
    else:
        changes = []
    for old, new in changes:
        assert ref.count(old) == 1
        ref = [new if line == old else line for line in ref]
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


def test_serving_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                       monkeypatch):
    import inspect

    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.serving import DurableRequestQueue, ServeEngine
    assert inspect.signature(ServeEngine).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = DurableRequestQueue(str(tmp_path / "q"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(reduced_config("yi-6b"), q)
    q.close()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--dir", str(tmp_path / "serve")])
    assert not (tmp_path / "serve").exists()


def test_training_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                        monkeypatch):
    import inspect

    from repro_torch.configs import reduced_config
    from repro_torch.launch import train
    assert inspect.signature(train.train).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train(reduced_config("yi-6b"), steps=1,
                    ckpt_dir=str(tmp_path / "fn"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "cli")])
    assert not (tmp_path / "fn").exists() and not (tmp_path / "cli").exists()


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssm_scan"])
def test_kernels_refuse_inputs_that_require_grad(name):
    """The launch path of each wrapper (``_launch``, which CUDA tensors
    take) raises before anything reaches the card when an input requires
    grad and grad is enabled, naming the path training takes instead.
    Here the tensors lie on the CPU: the guard runs first, so the launch
    is never reached."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    x = torch.zeros((1, 4, 16), requires_grad=True)
    args = {
        "flash_attention": lambda: (torch.zeros((1, 4, 2, 16),
                                                requires_grad=True),
                                    torch.zeros((1, 4, 2, 16)),
                                    torch.zeros((1, 4, 2, 16)), True),
        "decode_attention": lambda: (torch.zeros((1, 2, 16),
                                                 requires_grad=True),
                                     torch.zeros((1, 4, 2, 16)),
                                     torch.zeros((1, 4, 2, 16)),
                                     torch.ones(1, dtype=torch.int32)),
        "ssm_scan": lambda: (x, torch.zeros((1, 4, 2)),
                             torch.zeros((1, 4, 2)), torch.zeros((1, 4, 16)),
                             torch.zeros((16, 2))),
    }[name]()
    instead = {"flash_attention": "causal_attention_chunked",
               "decode_attention": "use_kernels=False",
               "ssm_scan": "selective_scan_chunked"}[name]
    with pytest.raises(RuntimeError, match=instead):
        mod._launch(*args)


def test_grad_guard_passes_without_grad():
    from repro_torch.kernels.build import refuse_grad
    x = torch.zeros(3, requires_grad=True)
    with torch.no_grad():
        refuse_grad("k", (x,), "the plain path")
    refuse_grad("k", (torch.zeros(3),), "the plain path")
    with pytest.raises(RuntimeError, match="the plain path"):
        refuse_grad("k", (torch.zeros(3), x), "the plain path")
