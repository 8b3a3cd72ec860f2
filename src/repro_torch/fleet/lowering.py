"""Lower a :class:`repro.core.opsched.CompiledOp` to a Stats-only program.

The compiled effect program mutates two kinds of engine state: *values*
(``_vis``/``_pmem``/``_vval``/store logs) and *cost state* (per-line
cached/finval/everfl bits, per-word volatile touched bits, per-thread event
counters).  On the steady-state fast path, control flow never reads values
back -- environment addresses come from the executor's logical FIFO and the
allocators, CASes always succeed, and the bail guards consult only slots,
the persisted set and allocator cursors.  Per-instance ``Stats`` therefore
depend *only* on the cost state, which is all-integer and tiny: that is the
whole reason a million queue instances fit in a few arrays.

``lower_op`` keeps exactly the opcodes that can change a count or feed a
later address:

* ``K_CLASS_P`` / ``K_CLASS_V`` -- the dynamic classification points
  (hit / post-flush / cold-NVM / cold-DRAM, hit / DRAM);
* ``K_STATE`` (flush invalidation / retaining-flush / re-cache) and the
  line-state half of ``K_LINE`` (a full-line store caches its line);
* guards, allocators, FIFO bindings, retire->limbo, slot stores and the
  persisted-set bookkeeping (they steer *which* addresses later ops
  classify);

and drops every pure value store (``K_VVAL``/``K_LOGW``/``K_PMEMW``/
``K_PENDW``/``K_DRAIN``/``K_DRAINF``/``K_NT``/``K_NTAPPLY``) and the
contention-tracking stamps (``K_CASTAG``/``K_STAMP`` -- the fleet runs one
thread per instance, where contended counts are bit-identical to
uncontended ones; see ``tests/test_contention_property.py``).

Addresses are lowered for ``tid == 0`` (one simulated tenant per
instance).  Volatile addresses are stored as offsets from
``NVRAM._VOLATILE_BASE`` so every array stays comfortably in int32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from ..core.nvram import NVRAM
from ..core.opsched import (K_CASTAG, K_CLASS_P, K_CLASS_V, K_DRAIN, K_DRAINF,
                            K_LINE, K_LOGW, K_NT, K_NTAPPLY, K_PENDW, K_PMEMW,
                            K_STAMP, K_STATE, K_VVAL, _SYM_INDEX,
                            _VOLATILE_SYMS, CompiledOp, compile_schedule)

_VB = NVRAM._VOLATILE_BASE

# env slot indices, re-exported for the steppers
SYM = dict(_SYM_INDEX)
VOLATILE_SYM = frozenset(_SYM_INDEX[s] for s in _VOLATILE_SYMS)

KIND_ENQ, KIND_DEQ = 0, 1


class FleetLoweringError(ValueError):
    """A compiled op the fleet lowering cannot prove Stats-equivalent."""


@dataclass(frozen=True)
class Ref:
    """A lowered address: persistent line / volatile word, constant or
    env-relative.  ``const`` holds an absolute persistent address or a
    volatile offset (addr - _VOLATILE_BASE); ``sym`` indexes the op env.
    Mode ``"tid"`` (multi-thread lowering only, see ``pin_tid``) is a
    per-thread root: effective address ``const + tid * LINE_WORDS``."""
    space: str            # "p" | "v"
    mode: str             # "const" | "sym" | "tid"
    const: int = 0
    sym: int = -1
    off: int = 0


def _lower_addr(a, space: str, pin_tid: bool = True) -> Ref:
    """Compiler address descriptor -> Ref.

    ``pin_tid=True`` (the fleet default: one simulated tenant per
    instance) folds per-tid roots to their tid-0 constant; the burst
    executor lowers with ``pin_tid=False`` to keep them symbolic
    (mode ``"tid"``), resolved per grant against the granted thread."""
    mode = a[0]
    if mode == 0:
        addr = a[1]
        if addr >= _VB:
            if space == "p":
                raise FleetLoweringError(
                    f"volatile address {addr} in persistent context")
            return Ref("v", "const", const=addr - _VB)
        return Ref(space, "const", const=addr)
    if mode == 2:                       # per-tid root
        addr = a[1] + a[2]
        if addr >= _VB:
            if space == "p":
                raise FleetLoweringError(
                    f"volatile address {addr} in persistent context")
            addr -= _VB
        if pin_tid:
            return Ref(space, "const", const=addr)
        return Ref(space, "tid", const=addr)
    sym, off = a[1], a[2]
    sp = "v" if sym in VOLATILE_SYM else "p"
    if sp != space:
        raise FleetLoweringError(
            f"sym {_SYMS[sym]} is {sp}-space but used in {space} context")
    return Ref(sp, "sym", sym=sym, off=off)


def _lower_val_sym(val) -> int:
    """Aux value expressions the fleet tracks must be bare env symbols."""
    if not (isinstance(val, tuple) and val and val[0] == "sym"):
        raise FleetLoweringError(f"aux value {val!r} is not a bare symbol")
    return _SYM_INDEX[val[1]]


# opcodes the lowering drops outright: value stores and contention stamps
_DROPPED = {K_VVAL, K_LOGW, K_PMEMW, K_PENDW, K_DRAIN, K_DRAINF, K_NT,
            K_NTAPPLY, K_CASTAG, K_STAMP}


@dataclass
class FleetProgram:
    """One (queue, kind, model) op as Stats-only vector micro-ops.

    ``micro`` entries (applied in order):
      ("class_p", Ref)         dynamic persistent classification
      ("class_v", Ref)         dynamic volatile classification
      ("state", Ref, mode)     K_STATE: ST_INVAL / ST_EVERFL / ST_RECACHE
      ("line", Ref)            K_LINE line-state half: cached=1, finval=0

    ``aux`` entries (applied after the FIFO update, in order):
      ("limbo", sym, "p"|"v")  retire / retire_volatile -> limbo append
      ("slot", attr, sym)      q.attr[tid] = env[sym] (guard-relevant only)
      ("pdiscard", sym)        q._persisted.discard(env[sym])
      ("padd", (sym, ...))     q._persisted.add(env[sym]) each
    """
    kind: str
    code: int                                 # KIND_ENQ | KIND_DEQ
    base_counts: np.ndarray                   # (N_EV,) int64
    micro: Tuple[tuple, ...]
    aux: Tuple[tuple, ...]
    guards: Tuple[tuple, ...]                 # compiler guard_specs, verbatim
    uses_ssmem: bool = True
    allocs_p: bool = False
    allocs_v: bool = False
    n_class: int = 0
    slot_attrs: Tuple[str, ...] = field(default=())   # guard slot attrs


def lower_op(op: CompiledOp, guard_attrs: frozenset,
             pin_tid: bool = True) -> FleetProgram:
    """Lower one CompiledOp.  ``guard_attrs`` is the set of slot attributes
    any guard of this queue consults -- slot stores to other attrs carry no
    Stats information (their values feed dropped value stores only) and are
    elided; a tuple-valued store to a *guarded* slot is an error.
    ``pin_tid`` is forwarded to :func:`_lower_addr` (the burst executor
    lowers with ``pin_tid=False`` to keep per-tid roots symbolic)."""
    micro = []
    for ins in op.prog:
        code = ins[0]
        if code in _DROPPED:
            continue
        if code == K_CLASS_P:
            micro.append(("class_p", _lower_addr(ins[1], "p", pin_tid)))
        elif code == K_CLASS_V:
            micro.append(("class_v", _lower_addr(ins[1], "v", pin_tid)))
        elif code == K_STATE:
            micro.append(("state", _lower_addr(ins[1], "p", pin_tid), ins[2]))
        elif code == K_LINE:
            micro.append(("line", _lower_addr(ins[1], "p", pin_tid)))
        else:
            raise FleetLoweringError(f"unknown opcode {code} in {op.kind}")
    aux = []
    for spec in op.aux_specs:
        t0 = spec[0]
        if t0 == "retire":
            aux.append(("limbo", _lower_val_sym(spec[1]), "p"))
        elif t0 == "retire_v":
            aux.append(("limbo", _lower_val_sym(spec[1]), "v"))
        elif t0 == "slot":
            attr = spec[1]
            if attr not in guard_attrs:
                continue        # value-only slot (e.g. OptLinkedQ._last)
            aux.append(("slot", attr, _lower_val_sym(spec[2])))
        elif t0 == "pdiscard":
            aux.append(("pdiscard", _SYM_INDEX[spec[1]]))
        elif t0 == "padd":
            aux.append(("padd", tuple(_SYM_INDEX[s] for s in spec[1])))
        else:
            raise FleetLoweringError(f"unknown aux {t0!r} in {op.kind}")
    slot_attrs = tuple(g[1] for g in op.guard_specs if g[0] == "slot_nonnull")
    return FleetProgram(
        kind=op.kind,
        code=KIND_ENQ if op.kind == "enq" else KIND_DEQ,
        base_counts=op.base_counts.copy(),
        micro=tuple(micro),
        aux=tuple(aux),
        guards=tuple(op.guard_specs),
        uses_ssmem=op.uses_ssmem,
        allocs_p=op.allocs_p,
        allocs_v=op.allocs_v,
        n_class=op.n_class,
        slot_attrs=slot_attrs,
    )


@dataclass
class FleetPrograms:
    """Both op kinds of one queue x model, plus the layout facts the
    steppers need (shared by the numpy and jax backends)."""
    enq: FleetProgram
    deq: FleetProgram

    def __iter__(self):
        yield self.enq
        yield self.deq

    @property
    def guard_slot_attrs(self) -> Tuple[str, ...]:
        seen = []
        for p in self:
            for a in p.slot_attrs:
                if a not in seen:
                    seen.append(a)
        return tuple(seen)

    @property
    def needs_persisted(self) -> bool:
        return any(g[0] == "tail_persisted" for p in self for g in p.guards) \
            or any(ax[0] in ("pdiscard", "padd") for p in self for ax in p.aux)


def lower_queue(queue, model, pin_tid: bool = True) -> FleetPrograms:
    """Compile + lower both steady-state ops of one queue instance."""
    schedules = queue.op_schedule()
    if schedules is None:
        raise FleetLoweringError(
            f"{type(queue).__name__} declares no op_schedule()")
    ops = {k: compile_schedule(queue, schedules.of_kind(k), model)
           for k in ("enq", "deq")}
    guard_attrs = frozenset(
        g[1] for op in ops.values() for g in op.guard_specs
        if g[0] == "slot_nonnull")
    return FleetPrograms(enq=lower_op(ops["enq"], guard_attrs, pin_tid),
                         deq=lower_op(ops["deq"], guard_attrs, pin_tid))


# --------------------------------------------------------------------------
# Opcode-table encoding: FleetProgram micro/aux entries as fixed-width int32
# rows, so a stepper can interpret them with a data-driven loop instead of
# tracing one unrolled instruction sequence per program (the jit-trace size
# then no longer scales with schedule depth -- see repro.fleet.jaxexec).
# --------------------------------------------------------------------------

# row opcodes (column 0)
OPC_NOP = 0            # padding row: no effect
OPC_CLASS_P = 1        # dynamic persistent classification
OPC_CLASS_V = 2        # dynamic volatile classification
OPC_ST_INVAL = 3       # K_STATE ST_INVAL: cached=0, finval=1, everfl=1
OPC_ST_EVERFL = 4      # K_STATE ST_EVERFL: everfl=1
OPC_RECACHE = 5        # K_STATE ST_RECACHE and K_LINE: cached=1, finval=0
OPC_LIMBO = 6          # aux retire: limbo append (imm 0 = p, 1 = v)
OPC_SLOT = 7           # aux slot store: slots[imm] = addr (imm: slot index)
OPC_PDISCARD = 8       # aux persisted.discard(addr line)
OPC_PADD = 9           # aux persisted.add(addr line) -- one row per sym
N_OPC = 10

# columns: (kind, amode, a, off, imm).  amode 0 = const (a is an absolute
# persistent address / volatile offset), amode 1 = sym (a indexes the op
# env, off is added to the bound value), amode 2 = per-tid root (a is the
# tid-0 address; effective address a + tid * LINE_WORDS -- only emitted by
# the burst lowering's ``pin_tid=False`` tables, never by fleet programs).
# imm carries the per-kind immediate (limbo space, slot index); event
# charges are implied by kind (class_p consults cached/finval/everfl,
# class_v consults vtouched).
OPCODE_COLUMNS = 5

# kinds whose address operand lives in the volatile space
_OPC_VSPACE = frozenset((OPC_CLASS_V,))

_ST_TO_OPC = {0: OPC_ST_INVAL, 1: OPC_ST_EVERFL, 2: OPC_RECACHE}
_OPC_TO_ST = {v: k for k, v in _ST_TO_OPC.items()}


@dataclass(frozen=True)
class OpcodeProgram:
    """One FleetProgram's effect ops as a fixed-width int32 table.

    Rows ``[0, n_micro)`` encode ``micro`` (applied before the logical
    FIFO update), rows ``[n_micro, len(table))`` encode ``aux`` (applied
    after it).  ``table`` may be padded with trailing ``OPC_NOP`` rows --
    interpreters must treat them as no-ops."""
    table: np.ndarray            # (rows, OPCODE_COLUMNS) int32
    n_micro: int

    @property
    def n_rows(self) -> int:
        return int(self.table.shape[0])

    def padded(self, rows: int) -> "OpcodeProgram":
        """Same program with the table NOP-padded to ``rows`` rows."""
        if rows < self.n_rows:
            raise ValueError(f"cannot pad {self.n_rows} rows down to {rows}")
        out = np.zeros((rows, OPCODE_COLUMNS), dtype=np.int32)
        out[:self.n_rows] = self.table
        return OpcodeProgram(table=out, n_micro=self.n_micro)


def _encode_ref(kind: int, ref: Ref, imm: int = 0) -> tuple:
    if ref.mode == "const":
        return (kind, 0, ref.const, 0, imm)
    if ref.mode == "tid":
        return (kind, 2, ref.const, 0, imm)
    return (kind, 1, ref.sym, ref.off, imm)


def encode_program(prog: FleetProgram,
                   slot_attrs: Tuple[str, ...]) -> OpcodeProgram:
    """FleetProgram -> opcode table.  ``slot_attrs`` is the fleet-wide
    guard-slot layout (``FleetDims.slot_attrs``): aux slot stores encode
    the attribute as an index into it."""
    rows = []
    for ins in prog.micro:
        tag, ref = ins[0], ins[1]
        if tag == "class_p":
            rows.append(_encode_ref(OPC_CLASS_P, ref))
        elif tag == "class_v":
            rows.append(_encode_ref(OPC_CLASS_V, ref))
        elif tag == "state":
            rows.append(_encode_ref(_ST_TO_OPC[ins[2]], ref))
        elif tag == "line":
            rows.append(_encode_ref(OPC_RECACHE, ref))
        else:
            raise FleetLoweringError(f"unknown micro tag {tag!r}")
    n_micro = len(rows)
    for ax in prog.aux:
        t0 = ax[0]
        if t0 == "limbo":
            rows.append((OPC_LIMBO, 1, ax[1], 0, 0 if ax[2] == "p" else 1))
        elif t0 == "slot":
            if ax[1] not in slot_attrs:
                raise FleetLoweringError(
                    f"slot store to {ax[1]!r} outside the guard-slot "
                    f"layout {slot_attrs}")
            rows.append((OPC_SLOT, 1, ax[2], 0, slot_attrs.index(ax[1])))
        elif t0 == "pdiscard":
            rows.append((OPC_PDISCARD, 1, ax[1], 0, 0))
        elif t0 == "padd":
            for sym in ax[1]:
                rows.append((OPC_PADD, 1, sym, 0, 0))
        else:
            raise FleetLoweringError(f"unknown aux tag {t0!r}")
    table = np.asarray(rows, dtype=np.int32).reshape(-1, OPCODE_COLUMNS)
    opc = OpcodeProgram(table=table, n_micro=n_micro)
    validate_opcodes(prog, opc, slot_attrs)
    return opc


_SYM_NAMES = {v: k for k, v in _SYM_INDEX.items()}
_SYMS = _SYM_NAMES          # name used by _lower_addr's error message


def decode_opcodes(opc: OpcodeProgram,
                   slot_attrs: Tuple[str, ...]) -> Tuple[tuple, tuple]:
    """Opcode table -> (micro, aux) in FleetProgram's tuple form, with
    every ``padd`` group expanded to one entry per symbol (the encoding's
    normal form).  NOP padding rows are skipped."""
    micro, aux = [], []
    for r, row in enumerate(map(tuple, opc.table.tolist())):
        kind, amode, a, off, imm = row
        if kind == OPC_NOP:
            continue
        in_micro = r < opc.n_micro
        if kind in (OPC_CLASS_P, OPC_CLASS_V, OPC_ST_INVAL, OPC_ST_EVERFL,
                    OPC_RECACHE):
            space = "v" if kind in _OPC_VSPACE else "p"
            if amode == 0:
                ref = Ref(space, "const", const=a)
            elif amode == 2:
                ref = Ref(space, "tid", const=a)
            else:
                ref = Ref(space, "sym", sym=a, off=off)
            if not in_micro:
                raise FleetLoweringError(
                    f"row {r}: effect opcode {kind} in the aux region")
            if kind == OPC_CLASS_P:
                micro.append(("class_p", ref))
            elif kind == OPC_CLASS_V:
                micro.append(("class_v", ref))
            elif kind == OPC_RECACHE:
                micro.append(("state", ref, _OPC_TO_ST[OPC_RECACHE]))
            else:
                micro.append(("state", ref, _OPC_TO_ST[kind]))
        elif kind in (OPC_LIMBO, OPC_SLOT, OPC_PDISCARD, OPC_PADD):
            if in_micro:
                raise FleetLoweringError(
                    f"row {r}: aux opcode {kind} in the micro region")
            if kind == OPC_LIMBO:
                aux.append(("limbo", a, "p" if imm == 0 else "v"))
            elif kind == OPC_SLOT:
                aux.append(("slot", slot_attrs[imm], a))
            elif kind == OPC_PDISCARD:
                aux.append(("pdiscard", a))
            else:
                aux.append(("padd", (a,)))
        else:
            raise FleetLoweringError(f"row {r}: unknown opcode {kind}")
    return tuple(micro), tuple(aux)


def _normalize(prog: FleetProgram) -> Tuple[tuple, tuple]:
    """The program's micro/aux in the encoding's normal form: ``line``
    entries become ST_RECACHE state entries, ``padd`` groups expand."""
    micro = []
    for ins in prog.micro:
        if ins[0] == "line":
            micro.append(("state", ins[1], _OPC_TO_ST[OPC_RECACHE]))
        else:
            micro.append(ins)
    aux = []
    for ax in prog.aux:
        if ax[0] == "padd":
            aux.extend(("padd", (sym,)) for sym in ax[1])
        else:
            aux.append(ax)
    return tuple(micro), tuple(aux)


def validate_opcodes(prog: FleetProgram, opc: OpcodeProgram,
                     slot_attrs: Tuple[str, ...]) -> None:
    """Decode the table and require it to reproduce the source program's
    effect semantics exactly (up to the documented normal form).  Runs at
    every encode so a drifting encoder cannot silently ship wrong
    tables."""
    if opc.table.dtype != np.int32 or opc.table.ndim != 2 \
            or opc.table.shape[1] != OPCODE_COLUMNS:
        raise FleetLoweringError(
            f"opcode table must be (rows, {OPCODE_COLUMNS}) int32, got "
            f"{opc.table.dtype} {opc.table.shape}")
    got = decode_opcodes(opc, slot_attrs)
    want = _normalize(prog)
    if got != want:
        raise FleetLoweringError(
            f"opcode round-trip mismatch for {prog.kind}:\n"
            f"  decoded {got}\n  expected {want}")
