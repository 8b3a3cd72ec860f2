"""The fleet's opcode chunk stepper: a CUDA kernel and its plain version.

One call advances every queue instance's Stats-only state through a chunk
of C plan steps.  Per op and instance: tail record and bail detection;
the 64-op epoch advance with limbo -> free-stack reclamation; env binding
and allocations; the opcode-table walk (micro rows, the logical FIFO
update, aux rows); the static base counts.  Integers only, bit-exact.

This replaces the Pallas kernel ``make_pallas_chunk_fn`` in
``src/repro/kernels/fleet_step.py`` (its per-op body is
``repro.fleet.jaxexec._apply_opcode_one``).  Two implementations of one
function live here:

* :func:`fleet_step_plain` -- batched, masked PyTorch code over the
  instance axis; the opcode table is walked row by row on the host, since
  every instance shares it.  The CPU tests run it against the JAX package,
  and ``chip_smoke.py`` holds the kernel to it on the card.
* the CUDA kernel in ``src/repro_torch/csrc/fleet_step.cu`` (one thread per
  instance), built with ``nvcc`` into ``build/repro_torch/`` at first use
  and bound through ``ctypes``.

:func:`fleet_step` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, no other path.  Any index outside its row sets a
bit in the caller's error word (both versions); the backend reads it at
every poll and raises.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core.nvram import (EV_COLD_DRAM, EV_COLD_NVM, EV_DRAM, EV_HIT,
                          EV_POSTFLUSH, LINE_WORDS, N_EV)
from ..core.opsched import NULL
from ..fleet.lowering import (KIND_DEQ, KIND_ENQ, N_OPC, OPC_CLASS_P,
                              OPC_CLASS_V, OPC_LIMBO, OPC_NOP, OPC_PADD,
                              OPC_PDISCARD, OPC_RECACHE, OPC_SLOT,
                              OPC_ST_EVERFL, OPC_ST_INVAL, SYM,
                              encode_program)
from ..fleet.stepper import EPOCH_ADV_OPS
from ..fleet.torchexec import (_ARRAY_FIELDS, _SCALAR_FIELDS, TILE,
                               _dtype, n_tiles)
from .build import check, load_library

N_SYM = max(SYM.values()) + 1
E_NEW_P, E_NEW_V = SYM["new_p"], SYM["new_v"]
E_TAIL_P, E_TAIL_V = SYM["tail_p"], SYM["tail_v"]
E_HEAD_P, E_HEAD_V = SYM["head_p"], SYM["head_v"]
E_NEXT_P, E_NEXT_V = SYM["next_p"], SYM["next_v"]
E_PREV = SYM["prev"]

# error-word bits; the same values are defined in csrc/fleet_step.cu
ERR_LINE = 1          # persistent line index outside [0, nl)
ERR_VWORD = 2         # volatile word index outside [0, nvw)
ERR_RING = 4          # negative ring position operand
ERR_FREE = 8          # free-stack position outside its capacity
ERR_LIMBO = 16        # limbo position outside lcap, or a freed set that is
                      # not a prefix of the limbo ring
ERR_SLOT = 32         # slot index outside the slot matrix
ERR_OPCODE = 64       # unknown opcode or env symbol
ERR_PERSISTED = 128   # persisted-set line outside its plane
ERR_NAMES = {ERR_LINE: "line", ERR_VWORD: "volatile word", ERR_RING: "ring",
             ERR_FREE: "free stack", ERR_LIMBO: "limbo", ERR_SLOT: "slot",
             ERR_OPCODE: "opcode", ERR_PERSISTED: "persisted set"}

MAX_SLOT_GUARDS = 4

# state-dict keys, in the order of the kernel's argument struct
STATE_KEYS = _ARRAY_FIELDS + ("counts", "slots") + _SCALAR_FIELDS


def describe_error(word: int) -> str:
    return ", ".join(name for bit, name in ERR_NAMES.items() if word & bit)


@dataclass(frozen=True)
class ProgSpec:
    """One lowered program as the stepper consumes it: launch facts plus
    the opcode table (every instance shares both)."""
    code: int
    uses_ssmem: bool
    allocs_p: bool
    allocs_v: bool
    tail_guard: bool
    slot_guards: Tuple[int, ...]     # slot columns whose NULL value bails
    prev_slot: int                   # slot column bound to env "prev" (-1)
    table: np.ndarray                # (rows, 5) int32
    n_micro: int
    base_counts: np.ndarray          # (N_EV,) int32


def prog_spec(prog, dims) -> ProgSpec:
    """FleetProgram -> ProgSpec, with the guard and slot attributes turned
    into columns of the fleet-wide slot matrix."""
    opc = encode_program(prog, dims.slot_attrs)
    if (opc.table[:, 1] > 1).any():
        raise ValueError("per-tid address rows are not fleet programs")
    slot_guards, tail_guard = [], False
    for g in prog.guards:
        if g[0] == "slot_nonnull":
            slot_guards.append(dims.slot_attrs.index(g[1]))
        elif g[0] == "tail_persisted":
            tail_guard = True
        else:
            raise ValueError(f"unknown guard {g!r}")
    if len(slot_guards) > MAX_SLOT_GUARDS:
        raise ValueError(f"more than {MAX_SLOT_GUARDS} slot guards")
    prev = dims.slot_attrs.index(prog.slot_attrs[-1]) if prog.slot_attrs \
        else -1
    return ProgSpec(code=prog.code, uses_ssmem=bool(prog.uses_ssmem),
                    allocs_p=bool(prog.allocs_p),
                    allocs_v=bool(prog.allocs_v), tail_guard=tail_guard,
                    slot_guards=tuple(slot_guards), prev_slot=prev,
                    table=opc.table, n_micro=opc.n_micro,
                    base_counts=prog.base_counts.astype(np.int32))


class FleetStepPrograms:
    """Both programs of one template, plus the packed int32 constants the
    kernel copies into shared memory (tables, then base-count vectors),
    uploaded once per device."""

    def __init__(self, programs, dims):
        self.dims = dims
        self.specs = tuple(prog_spec(p, dims) for p in programs)
        parts, self.table_off, self.base_off, off = [], [], [], 0
        for s in self.specs:
            self.table_off.append(off)
            parts.append(s.table.reshape(-1))
            off += s.table.size
        for s in self.specs:
            self.base_off.append(off)
            parts.append(s.base_counts)
            off += N_EV
        self.consts = np.concatenate(parts).astype(np.int32)
        self._on_device = {}

    def consts_on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(self.consts).to(device)
        return self._on_device[key]


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def _flag(err: torch.Tensor, bad: torch.Tensor, bit: int) -> None:
    err.bitwise_or_(bad.any().to(torch.int32) * bit)


# The plain version works on views: a 2-D field as ``[X, T, 32]`` (its
# warp tiles with the column axis first), a per-instance value as
# ``[T, 32]``; "instance i" below is the pair (tile, lane).

def _col(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx[i], i] for every instance i."""
    return a.gather(0, idx[None]).squeeze(0)


def _put(a: torch.Tensor, idx: torch.Tensor, m: torch.Tensor, val) -> None:
    """a[idx[i], i] = val[i] where m[i]; other instances keep theirs."""
    old = _col(a, idx)
    new = torch.where(m, torch.as_tensor(val, dtype=a.dtype,
                                         device=a.device), old)
    a.scatter_(0, idx[None], new[None])


def _touch(reach, key: str, idx: torch.Tensor, m: torch.Tensor) -> None:
    """Mark ``st[key][idx[i], i]`` reached where ``m[i]`` (``reach`` is
    None unless the caller records what a chunk reads and writes)."""
    if reach is not None:
        ii = m.nonzero(as_tuple=True)
        reach[key][(idx[ii].long(),) + ii] = True


def _index(err, m, idx, width: int, bit: int) -> torch.Tensor:
    """Flag masked rows whose index lies outside [0, width); return the
    index clamped into range (the value at a flagged row is never used:
    the backend raises at the next poll)."""
    _flag(err, m & ((idx < 0) | (idx >= width)), bit)
    return idx.clamp(0, width - 1)


def _advance_plain(dims, st, adv, err, reach) -> None:
    """Epoch advance for the rows in ``adv``: limbo entries two epochs
    stale move to the free stacks in limbo order, and the limbo ring is
    permuted exactly as ``argsort(where(keep, 0, 1), stable=True)``."""
    lcap = dims.lcap
    min_e = st["epoch"]
    st["epoch"] = torch.where(adv, min_e + 1, min_e)
    nl = st["nlimbo"]
    _flag(err, adv & ((nl < 0) | (nl > lcap)), ERR_LIMBO)
    j = torch.arange(lcap, dtype=torch.int32,
                     device=nl.device)[:, None, None]
    inl = j < nl[None]
    fr = inl & (st["limbo_e"] + 2 <= min_e[None]) & adv[None]
    nfr = fr.sum(dim=0, dtype=torch.int32)
    # the kernel compacts by rotation, which needs the freed entries to be
    # a prefix (limbo epochs never decrease along the ring)
    _flag(err, adv & (fr != (j < nfr[None])).any(dim=0), ERR_LIMBO)
    if reach is not None:
        # the epochs are scanned; freed entries are read; a partial free
        # rotates the whole live ring
        live = inl & adv[None]
        rot = live & ((nfr > 0) & (nfr < nl))[None]
        reach["limbo_e"] |= live
        for key in ("limbo_a", "limbo_k"):
            reach[key] |= fr | rot
    is_p = st["limbo_k"] == 0
    for sel, key, nkey, slen in ((fr & is_p, "free_p", "nfree", dims.fcap),
                                 (fr & ~is_p, "vfree", "nvfree",
                                  dims.vfcap)):
        cnt = torch.cumsum(sel.to(torch.int32), dim=0, dtype=torch.int32)
        dest = st[nkey][None] + cnt - 1
        bad = sel & ((dest < 0) | (dest >= slen))
        _flag(err, bad, ERR_FREE)
        nz = (sel & ~bad).nonzero(as_tuple=True)        # (entry, instance)
        at = (dest[nz].long(),) + nz[1:]
        st[key][at] = st["limbo_a"][nz]
        if reach is not None:
            reach[key][at] = True
        st[nkey] = st[nkey] + cnt[-1]
    keep = inl & ~fr
    order = torch.argsort((~keep).to(torch.int32), dim=0, stable=True)
    for key in ("limbo_a", "limbo_e", "limbo_k"):
        st[key].copy_(st[key].gather(0, order))
    st["nlimbo"] = nl - nfr


def _apply_plain(spec: ProgSpec, dims, st, sel, oi: int, err,
                 reach) -> None:
    """One lowered op for every instance where ``active & sel``; the
    batched form of ``_op_prologue`` + ``_apply_opcode_one``."""
    cap = dims.cap
    m0 = st["active"] & sel
    head, length = st["head"], st["length"]
    # ---- tail record ----------------------------------------------------
    hl = head + (length - 1).clamp(min=0)
    _flag(err, m0 & (hl < 0), ERR_RING)
    tpos = hl.remainder(cap).long()
    has = length > 0
    tail_p = torch.where(has, _col(st["ring_p"], tpos), st["dummy_p"])
    tail_v = torch.where(has, _col(st["ring_v"], tpos), st["dummy_v"])
    _touch(reach, "ring_p", tpos, m0 & has)
    _touch(reach, "ring_v", tpos, m0 & has)
    # ---- bail detection -------------------------------------------------
    bail = torch.zeros_like(m0)
    if spec.code == KIND_DEQ:
        bail |= length == 0
    for s in spec.slot_guards:
        bail |= st["slots"][s] == NULL
    pers = st["persisted"]
    if spec.tail_guard:
        ln = _index(err, m0, tail_p.div(LINE_WORDS, rounding_mode="floor"),
                    pers.shape[0], ERR_PERSISTED)
        bail |= _col(pers, ln.long()) == 0
        _touch(reach, "persisted", ln, m0)
    if spec.allocs_p:
        bail |= (st["nfree"] == 0) & (st["cursor"] >= dims.area_cap)
    if spec.allocs_v:
        bail |= (st["nvfree"] == 0) & (st["vcursor"] >= dims.chunk_cap)
    newly = m0 & bail
    st["bail_at"] = torch.where(newly, oi, st["bail_at"])
    st["active"] = st["active"] & ~newly
    m = m0 & ~newly
    # ---- op_begin -------------------------------------------------------
    if spec.uses_ssmem:
        ctr = st["opsctr"] + 1
        adv = m & (ctr >= EPOCH_ADV_OPS)
        st["opsctr"] = torch.where(m, torch.where(adv, 0, ctr), st["opsctr"])
        if bool(adv.any()):
            _advance_plain(dims, st, adv, err, reach)
    # ---- env + allocations ----------------------------------------------
    env = {}
    if spec.code == KIND_ENQ:
        env[E_TAIL_P], env[E_TAIL_V] = tail_p, tail_v
    else:
        _flag(err, m & (head < 0), ERR_RING)
        hpos = head.remainder(cap).long()
        env[E_HEAD_P], env[E_HEAD_V] = st["dummy_p"], st["dummy_v"]
        env[E_NEXT_P] = _col(st["ring_p"], hpos)
        env[E_NEXT_V] = _col(st["ring_v"], hpos)
        _touch(reach, "ring_p", hpos, m)
        _touch(reach, "ring_v", hpos, m)
    if spec.prev_slot >= 0:
        env[E_PREV] = st["slots"][spec.prev_slot].clone()
    for on, stack, nkey, ckey, base, width in (
            (spec.allocs_p, "free_p", "nfree", "cursor", dims.area_base,
             LINE_WORDS),
            (spec.allocs_v, "vfree", "nvfree", "vcursor", dims.chunk_base,
             dims.node_words)):
        if not on:
            continue
        nf, cur = st[nkey], st[ckey]
        use = nf > 0
        top = _index(err, m & use, nf - 1, st[stack].shape[0], ERR_FREE)
        _touch(reach, stack, top, m & use)
        env[E_NEW_P if stack == "free_p" else E_NEW_V] = torch.where(
            use, _col(st[stack], top.long()), base + cur * width)
        st[nkey] = torch.where(m & use, nf - 1, nf)
        st[ckey] = torch.where(m & ~use, cur + 1, cur)
    # ---- opcode rows ----------------------------------------------------
    zeros = torch.zeros_like(head)
    epoch = st["epoch"]
    rows = spec.table.tolist()

    def row_step(kind, amode, aval, off, imm):
        if kind == OPC_NOP:
            return
        if not 0 <= kind < N_OPC or (amode == 1 and not 0 <= aval < N_SYM):
            _flag(err, m, ERR_OPCODE)
            return
        a = env.get(aval, zeros) + off if amode == 1 \
            else torch.full_like(zeros, aval)
        if kind == OPC_CLASS_V:
            w = _index(err, m, a, dims.nvw, ERR_VWORD).long()
            vt = _col(st["vtouched"], w)
            ev = torch.where(vt == 1, EV_HIT, EV_DRAM)
            st["counts"].scatter_add_(0, ev[None].long(),
                                      m[None].to(torch.int32))
            _put(st["vtouched"], w, m, 1)
            _touch(reach, "vtouched", w, m)
            return
        if kind in (OPC_PDISCARD, OPC_PADD):
            ln = _index(err, m, a.div(LINE_WORDS, rounding_mode="floor"),
                        pers.shape[0], ERR_PERSISTED).long()
            _put(pers, ln, m, 1 if kind == OPC_PADD else 0)
            _touch(reach, "persisted", ln, m)
            return
        if kind == OPC_LIMBO:
            pos = _index(err, m, st["nlimbo"], dims.lcap, ERR_LIMBO).long()
            _put(st["limbo_a"], pos, m, a)
            _put(st["limbo_e"], pos, m, epoch)
            _put(st["limbo_k"], pos, m, imm)
            for key in ("limbo_a", "limbo_e", "limbo_k"):
                _touch(reach, key, pos, m)
            st["nlimbo"] = torch.where(m, st["nlimbo"] + 1, st["nlimbo"])
            return
        if kind == OPC_SLOT:
            if not 0 <= imm < st["slots"].shape[0]:
                _flag(err, m, ERR_SLOT)
                return
            st["slots"][imm] = torch.where(m, a, st["slots"][imm])
            return
        ln = _index(err, m, a.div(LINE_WORDS, rounding_mode="floor"),
                    dims.nl, ERR_LINE).long()
        ca, fi = st["cached"], st["finval"]
        if kind == OPC_CLASS_P:
            ev = torch.where(
                _col(ca, ln) == 1, EV_HIT,
                torch.where(_col(fi, ln) == 1, EV_POSTFLUSH,
                            torch.where(_col(st["everfl"], ln) == 1,
                                        EV_COLD_NVM, EV_COLD_DRAM)))
            st["counts"].scatter_add_(0, ev[None].long(),
                                      m[None].to(torch.int32))
            # everfl is read only for a line neither cached nor flushed
            _touch(reach, "everfl", ln,
                   m & ((ev == EV_COLD_NVM) | (ev == EV_COLD_DRAM)))
        if kind != OPC_ST_EVERFL:
            _touch(reach, "cached", ln, m)
            _touch(reach, "finval", ln, m)
        if kind in (OPC_ST_INVAL, OPC_ST_EVERFL):
            _touch(reach, "everfl", ln, m)
        if kind in (OPC_CLASS_P, OPC_RECACHE):
            _put(ca, ln, m, 1)
            _put(fi, ln, m, 0)
        elif kind == OPC_ST_INVAL:
            _put(ca, ln, m, 0)
            _put(fi, ln, m, 1)
            _put(st["everfl"], ln, m, 1)
        else:                                   # OPC_ST_EVERFL
            _put(st["everfl"], ln, m, 1)

    for r in rows[:spec.n_micro]:
        row_step(*r)
    # ---- logical FIFO, between the micro rows and the aux rows ----------
    head, length = st["head"], st["length"]
    if spec.code == KIND_ENQ:
        s = head + length
        _flag(err, m & (s < 0), ERR_RING)
        pos = s.remainder(cap).long()
        _put(st["ring_p"], pos, m, env[E_NEW_P] if spec.allocs_p else 0)
        _put(st["ring_v"], pos, m, env[E_NEW_V] if spec.allocs_v else 0)
        _touch(reach, "ring_p", pos, m)
        _touch(reach, "ring_v", pos, m)
        st["length"] = torch.where(m, length + 1, length)
    else:
        st["dummy_p"] = torch.where(m, env[E_NEXT_P], st["dummy_p"])
        st["dummy_v"] = torch.where(m, env[E_NEXT_V], st["dummy_v"])
        st["head"] = torch.where(m, (head + 1).remainder(cap), head)
        st["length"] = torch.where(m, length - 1, length)
    for r in rows[spec.n_micro:]:
        row_step(*r)
    # ---- static counts --------------------------------------------------
    mi = m.to(torch.int32)
    for e, v in enumerate(spec.base_counts.tolist()):
        if v:
            st["counts"][e] += mi * v


def fleet_step_plain(st: dict, kinds: torch.Tensor, start: int,
                     progs: FleetStepPrograms, err: torch.Tensor,
                     reach: dict = None) -> None:
    """Advance ``st`` in place through ``kinds.shape[0]`` plan steps.
    ``kinds[c, i]`` is instance i's op at global index ``start + c``.

    Every 2-D state tensor is in warp tiles ``[T, X, 32]`` (see
    :mod:`repro_torch.fleet.torchexec`).  ``reach``, when given, maps each
    of ``_ARRAY_FIELDS`` to a bool tensor of that field's shape, and the
    call sets every position the chunk's ops read or write there: the
    state a byte bound must count."""
    n = kinds.shape[1]
    pad = n_tiles(n) * TILE - n
    w = {k: st[k].permute(1, 0, 2) for k in _ARRAY_FIELDS +
         ("counts", "slots")}
    for k in _SCALAR_FIELDS:        # padding instances: inactive, zero
        w[k] = torch.cat([st[k], st[k].new_zeros(pad)]).view(-1, TILE)
    wk = torch.cat([kinds, kinds.new_full((kinds.shape[0], pad), 255)],
                   dim=1).view(kinds.shape[0], -1, TILE)
    wr = None if reach is None else {k: v.permute(1, 0, 2)
                                     for k, v in reach.items()}
    for c in range(wk.shape[0]):
        for spec in progs.specs:
            _apply_plain(spec, progs.dims, w, wk[c] == spec.code, start + c,
                         err, wr)
    for k in _SCALAR_FIELDS:
        st[k].copy_(w[k].reshape(-1)[:n])


# --------------------------------------------------------------------------
# the CUDA kernel: build, binding, wrapper
# --------------------------------------------------------------------------

class _Prog(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in (
        "code", "uses_ssmem", "allocs_p", "allocs_v", "tail_guard",
        "n_slot_guards")] +
        [("slot_guard", ctypes.c_int * MAX_SLOT_GUARDS)] +
        [(f, ctypes.c_int) for f in (
            "prev_slot", "n_micro", "n_rows", "table_off", "base_off")])


class _Args(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in STATE_KEYS] +
                [(k, ctypes.c_void_p) for k in ("kinds", "consts", "err",
                                                "stream")] +
                [(f, ctypes.c_int) for f in (
                    "n", "n_ops", "start", "nl", "npers", "nvw", "cap",
                    "fcap", "vfcap", "lcap", "nslots", "area_base",
                    "area_cap", "chunk_base", "chunk_cap", "node_words",
                    "n_consts", "n_progs")] +
                [("prog", _Prog * 2)])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("fleet_step")
    lib.fleet_step_launch.argtypes = [ctypes.POINTER(_Args)]
    lib.fleet_step_launch.restype = ctypes.c_int
    return lib


def _check_state(st: dict, kinds: torch.Tensor, dims, err) -> None:
    n = kinds.shape[1]
    dev = kinds.device
    widths = {"cached": dims.nl, "finval": dims.nl, "everfl": dims.nl,
              "persisted": dims.nl if dims.needs_persisted else 1,
              "vtouched": dims.nvw, "ring_p": dims.cap, "ring_v": dims.cap,
              "free_p": dims.fcap, "vfree": dims.vfcap,
              "limbo_a": dims.lcap, "limbo_e": dims.lcap,
              "limbo_k": dims.lcap, "counts": N_EV,
              "slots": max(1, len(dims.slot_attrs))}
    for key in STATE_KEYS:
        t = st[key]
        want = _dtype(key)
        shape = (n_tiles(n), widths[key], TILE) if key in widths else (n,)
        if t.device != dev or t.dtype != want or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fleet_step: state[{key!r}] is {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()}); the "
                f"kernel takes contiguous {want} {shape} on {dev}")
    if kinds.dtype != torch.uint8 or not kinds.is_contiguous():
        raise ValueError("fleet_step: kinds must be contiguous uint8 [C, N]")
    if err.device != dev or err.dtype != torch.int32 or err.numel() != 1:
        raise ValueError("fleet_step: err must be one int32 on the device")


def _launch(st, kinds, start, progs: FleetStepPrograms, err) -> None:
    dims = progs.dims
    _check_state(st, kinds, dims, err)
    consts = progs.consts_on(kinds.device)
    a = _Args()
    for key in STATE_KEYS:
        setattr(a, key, st[key].data_ptr())
    a.kinds, a.consts, a.err = (kinds.data_ptr(), consts.data_ptr(),
                                err.data_ptr())
    a.stream = torch.cuda.current_stream(kinds.device).cuda_stream
    a.n, a.n_ops, a.start = kinds.shape[1], kinds.shape[0], start
    a.nl, a.npers, a.nvw = dims.nl, st["persisted"].shape[1], dims.nvw
    a.cap, a.fcap, a.vfcap, a.lcap = dims.cap, dims.fcap, dims.vfcap, \
        dims.lcap
    a.nslots = st["slots"].shape[1]
    a.area_base, a.area_cap = dims.area_base, dims.area_cap
    a.chunk_base, a.chunk_cap = dims.chunk_base, dims.chunk_cap
    a.node_words = dims.node_words
    a.n_consts, a.n_progs = progs.consts.size, len(progs.specs)
    for j, s in enumerate(progs.specs):
        p = a.prog[j]
        p.code, p.uses_ssmem = s.code, int(s.uses_ssmem)
        p.allocs_p, p.allocs_v = int(s.allocs_p), int(s.allocs_v)
        p.tail_guard, p.n_slot_guards = int(s.tail_guard), len(s.slot_guards)
        for g, col in enumerate(s.slot_guards):
            p.slot_guard[g] = col
        p.prev_slot, p.n_micro = s.prev_slot, s.n_micro
        p.n_rows = s.table.shape[0]
        p.table_off, p.base_off = progs.table_off[j], progs.base_off[j]
    check(_library().fleet_step_launch(ctypes.byref(a)), "fleet_step")


def fleet_step(st: dict, kinds: torch.Tensor, start: int,
               progs: FleetStepPrograms, err: torch.Tensor) -> None:
    """Advance ``st`` in place through one chunk: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors.  ``fleet_step.launches``
    counts kernel launches."""
    if kinds.device.type == "cpu":
        fleet_step_plain(st, kinds, start, progs, err)
    elif kinds.device.type == "cuda":
        _launch(st, kinds, start, progs, err)
        fleet_step.launches += 1
    else:
        raise ValueError(f"fleet_step: no implementation for "
                         f"{kinds.device}")


fleet_step.launches = 0
