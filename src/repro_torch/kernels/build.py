"""Build and bind the port's CUDA sources.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/repro_torch/`` (listed in ``.gitignore``), at first use, keyed by a
hash of the source, the headers beside it and the flags.  No PyTorch
header is included, so a build takes seconds.  The wrappers bind the C
functions through ``ctypes``: ``c_void_p`` for every pointer and for the
stream, ``c_int`` for every int.  Each C function returns
``cudaGetLastError()`` after its launches; :func:`check` raises if that is
not 0.  The kernels have no backward, so :func:`refuse_grad` stops a
launch whose result autograd would need.  :func:`sass_opcode_counts` reads the built machine code back
(``cuobjdump -sass``), to show which instructions a kernel compiled to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_libraries(names: Iterable[str]) -> Dict[str, Tuple[Path, float,
                                                              str]]:
    """Compile ``csrc/<name>.cu`` for every name whose library is not built
    yet, one ``nvcc`` per source, all started together -> {name: (library
    path, build seconds, nvcc's log)}."""
    names = list(dict.fromkeys(names))
    out, running = {}, {}
    for name in names:
        lib = _target(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, log, t0) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exit {proc.returncode}\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, lib)
        out[name] = (lib, seconds, text)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: out[name] for name in names}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built here if missing)."""
    path, _, _ = build_libraries([name])[name]
    return ctypes.CDLL(str(path))


def bind(lib: ctypes.CDLL, fn: str, n_pointers: int, n_ints: int):
    """``lib.fn`` typed as (pointers..., stream, ints...) -> int."""
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * (n_pointers + 1) +
                  [ctypes.c_int] * n_ints)
    f.restype = ctypes.c_int
    return f


def parse_sass_counts(sass: str, opcode: str) -> Dict[str, int]:
    """{function: instructions of ``opcode``} in ``cuobjdump -sass`` text;
    ``HMMA`` counts ``HMMA.16816.F32.BF16`` and the other HMMA forms."""
    counts: Dict[str, int] = {}
    fn = None
    pattern = re.compile(rf"\b{re.escape(opcode)}(\.|\s)")
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and pattern.search(line):
            counts[fn] += 1
    return counts


def sass_opcode_counts(name: str, opcode: str) -> Dict[str, int]:
    """{kernel function: instructions of ``opcode``} in the machine code of
    the built ``csrc/<name>.cu`` library."""
    path, _, _ = build_libraries([name])[name]
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    return parse_sass_counts(sass, opcode)


def check(rc: int, what: str) -> None:
    """Raise unless the C function's ``cudaGetLastError()`` was 0."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def refuse_grad(what: str, tensors, instead: str) -> None:
    """Raise before a launch whose output autograd would need: the kernels
    write fresh tensors autograd does not see, so a gradient through them
    would be lost without a word.  ``instead`` names the path to take."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward and an "
                           f"input requires grad; use {instead}, or call it "
                           f"under torch.no_grad()")

