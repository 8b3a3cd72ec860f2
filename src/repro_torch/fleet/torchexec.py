"""PyTorch backend of the fleet executor: device-resident state stepped by
the opcode chunk stepper (:mod:`repro_torch.kernels.fleet_step`).

The counterpart of ``repro.fleet.jaxexec``.  State lives on one device as a
dict of tensors, instance axis first: uint8 line-state planes, int32
rings, stacks and limbo, int32 count deltas (int64 on the host, as in the
reference), the stacked guard-slot matrix ``slots`` (``[N, 1]`` of zeros
when the template has no guard slots) and thirteen per-instance scalars.
Each chunk is one call of the stepper, which updates the state in place;
one host read per chunk (:meth:`TorchBackend.poll`) brings back the bail
flags and the stepper's error word.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import Template

# FleetState fields carried on the device (leading instance axis)
_ARRAY_FIELDS = ("cached", "finval", "everfl", "persisted", "vtouched",
                 "ring_p", "ring_v", "free_p", "vfree",
                 "limbo_a", "limbo_e", "limbo_k")
_SCALAR_FIELDS = ("head", "length", "dummy_p", "dummy_v", "nfree", "cursor",
                  "nvfree", "vcursor", "nlimbo", "epoch", "opsctr",
                  "active", "bail_at")
_U8_FIELDS = frozenset(("cached", "finval", "everfl", "persisted",
                        "vtouched", "limbo_k"))


def _dtype(name: str):
    if name in _U8_FIELDS:
        return torch.uint8
    return torch.bool if name == "active" else torch.int32


def state_to_torch(fs, device) -> dict:
    """A reference fleet state -> the port's state dict on ``device``.

    ``fs`` is a ``FleetState`` (as ``replicate`` returns it) or its field
    dict in the JAX backends' layout (``slot_<attr>`` columns, int32
    ``counts``)."""
    if isinstance(fs, dict):
        fields = fs
        slot_cols = [v for k, v in fs.items() if k.startswith("slot_")]
    else:
        fields = {k: getattr(fs, k) for k in
                  _ARRAY_FIELDS + _SCALAR_FIELDS + ("counts",)}
        slot_cols = [fs.slots[a] for a in fs.dims.slot_attrs]
    st = {}
    for name in _ARRAY_FIELDS + _SCALAR_FIELDS:
        st[name] = torch.as_tensor(np.array(fields[name])).to(
            device, _dtype(name))
    st["counts"] = torch.as_tensor(
        np.asarray(fields["counts"]).astype(np.int32)).to(device)
    n = st["head"].shape[0]
    slots = (np.stack([np.asarray(c) for c in slot_cols], axis=-1)
             if slot_cols else np.zeros((n, 1)))
    st["slots"] = torch.as_tensor(slots.astype(np.int32)).to(device)
    return st


def state_to_numpy(st: dict) -> dict:
    """The port's state dict -> numpy arrays under the same keys."""
    return {k: v.cpu().numpy() for k, v in st.items()}


def tile_row(row: dict, dims, n: int, device) -> dict:
    """One exported template row tiled across ``n`` instances on the
    device (no N-row host copy: at 1M instances that would be gigabytes)."""
    st = {}
    for name in _ARRAY_FIELDS:
        r = torch.as_tensor(np.asarray(row[name])).to(device, _dtype(name))
        st[name] = r.expand(n, -1).contiguous()
    for name in _SCALAR_FIELDS[:-2]:
        st[name] = torch.full((n,), int(row[name]), dtype=torch.int32,
                              device=device)
    st["active"] = torch.ones(n, dtype=torch.bool, device=device)
    st["bail_at"] = torch.full((n,), -1, dtype=torch.int32, device=device)
    counts = torch.as_tensor(np.asarray(row["counts"]).astype(np.int32))
    st["counts"] = counts.to(device).expand(n, -1).contiguous()
    slots = [row["slots"][a] for a in dims.slot_attrs] or [0]
    st["slots"] = torch.tensor(slots, dtype=torch.int32,
                               device=device).expand(n, -1).contiguous()
    return st


class FleetStepError(RuntimeError):
    """The chunk stepper met an index outside a state row."""


class TorchBackend:
    """Device-resident fleet state; the runner's backend protocol
    (``run_chunk``, ``poll``, ``rejoin``, ``retire_resident``, ``counts``,
    ``chunk_phase``).  ``use_kernel`` selects the CUDA kernel (backend
    ``cuda``) or the plain PyTorch stepper (backend ``torch``)."""

    def __init__(self, template: Template, n: int, device="cuda",
                 use_kernel: bool = True):
        from ..kernels.fleet_step import FleetStepPrograms
        self.device = torch.device(device)
        if use_kernel and self.device.type != "cuda":
            raise ValueError(f"the cuda backend runs on a CUDA device, not "
                             f"{self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this host")
        self.use_kernel = use_kernel
        self.name = "cuda" if use_kernel else "torch"
        self.chunk_phase = "kernel-launch" if use_kernel else "chunk-step"
        self.t = template
        self.n = n
        self.progs = FleetStepPrograms(template.programs, template.dims)
        self.st = tile_row(template.row, template.dims, n, self.device)
        self.err = torch.zeros(1, dtype=torch.int32, device=self.device)

    def run_chunk(self, kinds: np.ndarray, start: int) -> None:
        from ..kernels.fleet_step import fleet_step, fleet_step_plain
        kt = torch.as_tensor(np.ascontiguousarray(kinds, dtype=np.uint8))
        kt = kt.to(self.device)
        step = fleet_step if self.use_kernel else fleet_step_plain
        step(self.st, kt, start, self.progs, self.err)

    def poll(self):
        from ..kernels.fleet_step import describe_error
        host = torch.cat([self.st["bail_at"],
                          self.st["active"].to(torch.int32),
                          self.err]).cpu().numpy()
        bail_at, active = host[:self.n], host[self.n:2 * self.n] != 0
        if host[-1]:
            raise FleetStepError(
                f"fleet_step error word {int(host[-1])}: index out of "
                f"range ({describe_error(int(host[-1]))})")
        fresh = (~active) & (bail_at >= 0)
        return np.nonzero(fresh)[0], bail_at

    def rejoin(self, i: int, row: dict) -> None:
        st = self.st
        for name, val in row.items():
            if name == "slots":
                for j, attr in enumerate(self.t.dims.slot_attrs):
                    st["slots"][i, j] = int(val[attr])
            elif name == "counts":
                st["counts"][i] = torch.as_tensor(
                    np.asarray(val).astype(np.int32))
            else:
                st[name][i] = torch.as_tensor(np.asarray(val)).to(
                    st[name].dtype)
        st["active"][i] = True
        st["bail_at"][i] = -1

    def retire_resident(self, i: int) -> None:
        from .runner import RESIDENT
        self.st["active"][i] = False
        self.st["bail_at"][i] = RESIDENT

    def counts(self) -> np.ndarray:
        return self.st["counts"].cpu().numpy().astype(np.int64)
