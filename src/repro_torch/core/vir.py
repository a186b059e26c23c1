"""VIR — the VOLT intermediate representation.

A typed, CFG-based IR modeled on LLVM-before-mem2reg: expression temporaries
are virtual registers (single assignment), while mutable kernel-language
variables live in stack *slots* accessed via ``slot_load``/``slot_store``.
This keeps the IR phi-free, which is what makes the paper's slot-dataflow
variant of annotation analysis (uniform stack slots) and the mask-stack
linearization in the JAX back-end tractable.

Divergence-management ops (``split``/``join``/``pred``/``tmc``) mirror the
Vortex ISA of paper Table 2 and are *inserted by passes*, never by
front-ends.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------

class Ty(enum.Enum):
    I32 = "i32"
    F32 = "f32"
    BOOL = "i1"
    PTR = "ptr"      # buffer handle (global/shared/const address space)
    TOKEN = "token"  # IPDOM-stack token produced by vx_split
    VOID = "void"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class AddrSpace(enum.Enum):
    GLOBAL = "global"
    SHARED = "shared"
    CONST = "const"


# --------------------------------------------------------------------------
# Values
# --------------------------------------------------------------------------

class Value:
    ty: Ty

    def short(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class Const(Value):
    value: Any
    ty: Ty = Ty.I32

    def short(self) -> str:
        return f"{self.ty} {self.value}"


_reg_counter = itertools.count()


class Reg(Value):
    """Virtual register: the single result of one instruction."""

    __slots__ = ("ty", "id", "name", "defining")

    def __init__(self, ty: Ty, name: str = "") -> None:
        self.ty = ty
        self.id = next(_reg_counter)
        self.name = name or f"v{self.id}"
        self.defining: Optional["Instr"] = None

    def short(self) -> str:
        return f"%{self.name}"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Reg(%{self.name}:{self.ty})"


@dataclass(eq=False)
class Slot:
    """A stack slot (mutable local scalar). Our phi-replacement."""

    name: str
    ty: Ty
    uniform_hint: bool = False  # "vortex.uniform" annotation on the variable

    def __repr__(self) -> str:  # pragma: no cover
        return f"Slot({self.name}:{self.ty})"


@dataclass(eq=False)
class Param(Value):
    """Kernel/function parameter."""

    name: str
    ty: Ty
    space: Optional[AddrSpace] = None      # for PTR params
    uniform: bool = False                  # "vortex.uniform" annotation
    readonly: bool = False                 # const/restrict pointer

    def short(self) -> str:
        return f"%{self.name}"


@dataclass(eq=False)
class GlobalVar(Value):
    """Module-level device variable (__constant__/__device__ symbol).

    Host initialization happens via runtime.memcpy_to_symbol (Case Study 2):
    data is buffered host-side and materialized just before kernel launch.
    """

    name: str
    elem_ty: Ty
    size: int
    space: AddrSpace = AddrSpace.CONST
    ty: Ty = Ty.PTR

    def short(self) -> str:
        return f"@{self.name}"


# --------------------------------------------------------------------------
# Opcodes
# --------------------------------------------------------------------------

class Op(enum.Enum):
    # arithmetic / logic (binary)
    ADD = "add"; SUB = "sub"; MUL = "mul"; DIV = "div"; MOD = "mod"
    AND = "and"; OR = "or"; XOR = "xor"; SHL = "shl"; SHR = "shr"
    MIN = "min"; MAX = "max"; POW = "pow"
    # comparisons
    EQ = "eq"; NE = "ne"; LT = "lt"; LE = "le"; GT = "gt"; GE = "ge"
    # unary
    NEG = "neg"; NOT = "not"; ABS = "abs"
    SQRT = "sqrt"; EXP = "exp"; LOG = "log"; SIN = "sin"; COS = "cos"
    ITOF = "itof"; FTOI = "ftoi"
    POPC = "vx_popc"; FFS = "vx_ffs"  # bit ops (ISA-extension built-ins)
    # data
    SELECT = "select"          # pre-lowering ternary (may be rewritten)
    CMOV = "vx_move"           # ZiCond/CMOV: predicated move (both sides eval)
    # memory
    LOAD = "load"              # load(ptr, index)
    STORE = "store"            # store(ptr, index, value)
    SLOT_LOAD = "slot_load"    # slot_load(slot)
    SLOT_STORE = "slot_store"  # slot_store(slot, value)
    ATOMIC = "atomic"          # atomic(op, ptr, index, value) -> old
    # SIMT intrinsics
    INTR = "intr"              # intr(name): thread ids, sizes, CSRs
    VOTE = "vx_vote"           # vote(mode, value) -> warp-uniform result
    SHFL = "vx_shfl"           # shfl(value, src_lane)
    BARRIER = "vx_barrier"     # barrier(scope)
    PRINT = "print"
    # calls
    CALL = "call"
    # terminators
    BR = "br"                  # br(target)
    CBR = "cbr"                # cbr(cond, then_bb, else_bb)
    RET = "ret"
    # divergence management (inserted by passes; paper Table 2)
    SPLIT = "vx_split"         # token = split(cond) [attr negate]
    JOIN = "vx_join"           # join(token)
    PRED = "vx_pred"           # pred(cond, tok, inside, outside): terminator;
                               # mask &= cond; any(mask) -> inside, else
                               # restore mask from tok -> outside (Fig 2b)
    TMC_SAVE = "tmc_save"      # token = save current thread mask (preheader)
    TMC_RESTORE = "tmc_restore"  # restore thread mask (loop exit / vx_tmc)


TERMINATORS = {Op.BR, Op.CBR, Op.RET, Op.PRED}
BINOPS = {Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MOD, Op.AND, Op.OR, Op.XOR,
          Op.SHL, Op.SHR, Op.MIN, Op.MAX, Op.POW,
          Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE}
UNOPS = {Op.NEG, Op.NOT, Op.ABS, Op.SQRT, Op.EXP, Op.LOG, Op.SIN, Op.COS,
         Op.ITOF, Op.FTOI, Op.POPC, Op.FFS}
CMPOPS = {Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE}

# Intrinsic names. Divergent-by-nature ones vs. CSR-backed always-uniform
# ones (paper §4.3.1: the divergence tracker seeds both sets).
DIVERGENT_INTRINSICS = {"global_id", "local_id", "lane_id", "global_id_y",
                        "local_id_y", "group_id"}
# group_id is uniform *within* a workgroup; it is listed above only for the
# per-warp view when a workgroup spans one warp it is uniform -> the TTI
# decides (see passes/uniformity.py). CSR-backed:
CSR_INTRINSICS = {"num_threads", "num_warps", "core_id", "warp_id",
                  "local_size", "num_groups", "global_size", "grid_dim"}
WG_UNIFORM_INTRINSICS = {"group_id", "local_size", "num_groups",
                         "global_size", "grid_dim"}


# --------------------------------------------------------------------------
# Instructions / blocks / functions
# --------------------------------------------------------------------------

class Instr:
    __slots__ = ("op", "operands", "result", "attrs", "parent")

    def __init__(self, op: Op, operands: Sequence[Any] = (),
                 result: Optional[Reg] = None,
                 attrs: Optional[Dict[str, Any]] = None) -> None:
        self.op = op
        self.operands: List[Any] = list(operands)
        self.result = result
        self.attrs: Dict[str, Any] = attrs or {}
        self.parent: Optional["Block"] = None
        if result is not None:
            result.defining = self

    # -- helpers -----------------------------------------------------------
    def value_operands(self) -> List[Value]:
        return [o for o in self.operands if isinstance(o, Value)]

    def is_terminator(self) -> bool:
        return self.op in TERMINATORS

    def successors(self) -> List["Block"]:
        if self.op is Op.BR:
            return [self.operands[0]]
        if self.op is Op.CBR:
            return [self.operands[1], self.operands[2]]
        if self.op is Op.PRED:
            return [self.operands[2], self.operands[3]]
        return []

    def replace_operand(self, old: Any, new: Any) -> None:
        self.operands = [new if o is old else o for o in self.operands]
        if self.parent is not None and self.parent.parent is not None:
            self.parent.parent.bump_version()

    def short(self) -> str:
        parts = []
        if self.result is not None:
            parts.append(f"{self.result.short()} =")
        parts.append(self.op.value)
        for o in self.operands:
            if isinstance(o, Block):
                parts.append(f"label %{o.label}")
            elif isinstance(o, Slot):
                parts.append(f"${o.name}")
            elif isinstance(o, Value):
                parts.append(o.short())
            else:
                parts.append(repr(o))
        if self.attrs:
            parts.append(str(self.attrs))
        return " ".join(parts)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{self.short()}>"


class Block:
    _counter = itertools.count()

    def __init__(self, name: str = "") -> None:
        self.id = next(Block._counter)
        self.name = name or f"bb{self.id}"
        self.instrs: List[Instr] = []
        self.parent: Optional["Function"] = None

    @property
    def label(self) -> str:
        return f"{self.name}.{self.id}"

    # -- structure ---------------------------------------------------------
    def append(self, instr: Instr) -> Instr:
        instr.parent = self
        self.instrs.append(instr)
        if self.parent is not None:
            self.parent.bump_version()
        return instr

    def insert(self, idx: int, instr: Instr) -> Instr:
        instr.parent = self
        self.instrs.insert(idx, instr)
        if self.parent is not None:
            self.parent.bump_version()
        return instr

    @property
    def terminator(self) -> Optional[Instr]:
        if self.instrs and self.instrs[-1].is_terminator():
            return self.instrs[-1]
        return None

    def successors(self) -> List["Block"]:
        t = self.terminator
        return t.successors() if t else []

    def __repr__(self) -> str:  # pragma: no cover
        return f"Block(%{self.name})"


class Function:
    def __init__(self, name: str, params: Sequence[Param],
                 ret_ty: Ty = Ty.VOID, internal: bool = False) -> None:
        self.name = name
        self.params = list(params)
        self.ret_ty = ret_ty
        self.internal = internal           # internal linkage (Algorithm 1)
        self.blocks: List[Block] = []
        self.slots: List[Slot] = []
        self.shared: List[GlobalVar] = []  # per-workgroup shared arrays
        self.attrs: Dict[str, Any] = {}
        # Set by func-arg analysis (Algorithm 1): proved-uniform returns.
        self.ret_uniform: bool = False
        # IR version counters (perf substrate). Monotonic; bumped on every
        # mutation. Consumers key caches on them:
        #   ir_version  — any change at all (interpreter decode cache);
        #   cfg_version — block/edge structure changes (CFG analyses);
        #   df_version  — dataflow-relevant changes (uniformity analysis).
        # Block.append/insert and the Function mutators below bump
        # automatically; passes doing direct list surgery (b.instrs = ...)
        # must call bump_version themselves, declaring what they
        # invalidated via the cfg/dataflow flags.
        self._ir_version: int = 0
        self._cfg_version: int = 0
        self._df_version: int = 0

    # -- versioning --------------------------------------------------------
    @property
    def ir_version(self) -> int:
        return self._ir_version

    @property
    def cfg_version(self) -> int:
        return self._cfg_version

    @property
    def df_version(self) -> int:
        return self._df_version

    def bump_version(self, *, cfg: bool = True, dataflow: bool = True) -> None:
        """Record a mutation. cfg=False: block structure/edges unchanged
        (CFG analyses stay valid). dataflow=False: neither values nor
        control conditions changed (uniformity stays valid) — e.g. an
        attrs-only tweak or instruction reordering."""
        self._ir_version += 1
        if cfg:
            self._cfg_version += 1
        if dataflow:
            self._df_version += 1

    # -- structure ---------------------------------------------------------
    @property
    def entry(self) -> Block:
        return self.blocks[0]

    def new_block(self, name: str = "") -> Block:
        b = Block(name)
        b.parent = self
        self.blocks.append(b)
        self.bump_version()
        return b

    def new_slot(self, name: str, ty: Ty, uniform_hint: bool = False) -> Slot:
        s = Slot(name, ty, uniform_hint)
        self.slots.append(s)
        return s

    def new_shared(self, name: str, elem_ty: Ty, size: int) -> GlobalVar:
        g = GlobalVar(name, elem_ty, size, AddrSpace.SHARED)
        self.shared.append(g)
        return g

    def instructions(self):
        for b in self.blocks:
            yield from b.instrs

    def drop_unreachable(self) -> int:
        """Remove blocks unreachable from entry. Returns count removed."""
        seen = set()
        work = [self.entry]
        while work:
            b = work.pop()
            if id(b) in seen:
                continue
            seen.add(id(b))
            work.extend(b.successors())
        removed = [b for b in self.blocks if id(b) not in seen]
        self.blocks = [b for b in self.blocks if id(b) in seen]
        if removed:
            self.bump_version()
        return len(removed)

    def __getstate__(self):
        # the decoded-program cache holds closures (unpicklable) and is
        # identity-keyed anyway: the persistent compile cache in
        # core/runtime.py pickles Functions without it and the first
        # launch of an unpickled kernel re-decodes.  The affine-fact and
        # decode-plan memos are id(instr)-keyed, and object ids do not
        # survive pickling — a recycled id in the new process could
        # silently match a stale entry, so they must be dropped too.
        d = dict(self.__dict__)
        d.pop("_decode_cache", None)
        d.pop("_mem_facts", None)
        d.pop("_decode_plan", None)
        return d

    def dump(self) -> str:
        lines = [f"func @{self.name}({', '.join(p.short() + ':' + str(p.ty) + (' uniform' if p.uniform else '') for p in self.params)}) -> {self.ret_ty}:"]
        for b in self.blocks:
            lines.append(f"  %{b.label}:")
            for i in b.instrs:
                lines.append(f"    {i.short()}")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Function(@{self.name}, {len(self.blocks)} blocks)"


class Module:
    def __init__(self, name: str = "module") -> None:
        self.name = name
        self.functions: Dict[str, Function] = {}
        self.globals: Dict[str, GlobalVar] = {}

    def add(self, fn: Function) -> Function:
        self.functions[fn.name] = fn
        return fn

    def new_global(self, name: str, elem_ty: Ty, size: int,
                   space: AddrSpace = AddrSpace.CONST) -> GlobalVar:
        g = GlobalVar(name, elem_ty, size, space)
        self.globals[name] = g
        return g

    def dump(self) -> str:
        parts = [f"module @{self.name}"]
        for g in self.globals.values():
            parts.append(f"  global @{g.name} [{g.size} x {g.elem_ty}] {g.space.value}")
        for f in self.functions.values():
            parts.append(f.dump())
        return "\n".join(parts)


# --------------------------------------------------------------------------
# IRBuilder
# --------------------------------------------------------------------------

class IRBuilder:
    """Convenience builder used by the front-ends and tests."""

    def __init__(self, fn: Function, block: Optional[Block] = None) -> None:
        self.fn = fn
        self.block = block or (fn.blocks[0] if fn.blocks else fn.new_block("entry"))

    def set_block(self, block: Block) -> None:
        self.block = block

    def emit(self, op: Op, operands: Sequence[Any] = (),
             ty: Optional[Ty] = None, attrs: Optional[Dict[str, Any]] = None,
             name: str = "") -> Optional[Reg]:
        res = Reg(ty, name) if ty is not None and ty is not Ty.VOID else None
        self.block.append(Instr(op, operands, res, attrs))
        return res

    # -- typed helpers -----------------------------------------------------
    def binop(self, op: Op, a: Value, b: Value) -> Reg:
        if op in CMPOPS:
            ty = Ty.BOOL
        else:
            ty = a.ty if isinstance(a, (Reg, Param)) or a.ty is not Ty.I32 else b.ty
        return self.emit(op, [a, b], ty)

    def unop(self, op: Op, a: Value) -> Reg:
        ty = {Op.ITOF: Ty.F32, Op.FTOI: Ty.I32, Op.NOT: a.ty}.get(op, a.ty)
        return self.emit(op, [a], ty)

    def intr(self, name: str, dim: int = 0) -> Reg:
        return self.emit(Op.INTR, [name, dim], Ty.I32, name=name)

    def load(self, ptr: Value, idx: Value, elem_ty: Ty = Ty.F32) -> Reg:
        return self.emit(Op.LOAD, [ptr, idx], elem_ty)

    def store(self, ptr: Value, idx: Value, val: Value) -> None:
        self.emit(Op.STORE, [ptr, idx, val])

    def slot_load(self, slot: Slot) -> Reg:
        return self.emit(Op.SLOT_LOAD, [slot], slot.ty)

    def slot_store(self, slot: Slot, val: Value) -> None:
        self.emit(Op.SLOT_STORE, [slot, val])

    def select(self, cond: Value, a: Value, b: Value) -> Reg:
        return self.emit(Op.SELECT, [cond, a, b], a.ty)

    def call(self, callee: "Function", args: Sequence[Value]) -> Optional[Reg]:
        ty = callee.ret_ty if callee.ret_ty is not Ty.VOID else None
        res = Reg(ty) if ty else None
        self.block.append(Instr(Op.CALL, [callee, *args], res))
        return res

    def atomic(self, kind: str, ptr: Value, idx: Value, val: Value) -> Reg:
        return self.emit(Op.ATOMIC, [kind, ptr, idx, val], val.ty)

    def vote(self, mode: str, val: Value) -> Reg:
        ty = Ty.I32 if mode == "ballot" else Ty.BOOL
        return self.emit(Op.VOTE, [mode, val], ty)

    def shfl(self, val: Value, lane: Value) -> Reg:
        return self.emit(Op.SHFL, [val, lane], val.ty)

    def barrier(self, scope: str = "local") -> None:
        self.emit(Op.BARRIER, [scope])

    def br(self, target: Block) -> None:
        self.emit(Op.BR, [target])

    def cbr(self, cond: Value, then_bb: Block, else_bb: Block) -> None:
        self.emit(Op.CBR, [cond, then_bb, else_bb])

    def ret(self, val: Optional[Value] = None) -> None:
        self.emit(Op.RET, [val] if val is not None else [])


# --------------------------------------------------------------------------
# Verifier
# --------------------------------------------------------------------------

class VerifyError(Exception):
    pass


def verify(fn: Function, *, require_terminators: bool = True) -> None:
    """Structural well-formedness: exactly one terminator per block (at the
    end), branch targets belong to the function, register defs unique."""
    block_ids = {id(b) for b in fn.blocks}
    seen_regs: set = set()
    for b in fn.blocks:
        if require_terminators and (not b.instrs or not b.instrs[-1].is_terminator()):
            raise VerifyError(f"block %{b.name} in @{fn.name} lacks terminator")
        for pos, i in enumerate(b.instrs):
            if i.is_terminator() and pos != len(b.instrs) - 1:
                raise VerifyError(f"terminator mid-block in %{b.name}")
            for t in i.successors():
                if id(t) not in block_ids:
                    raise VerifyError(
                        f"branch from %{b.name} to foreign block %{t.name}")
            if i.result is not None:
                if id(i.result) in seen_regs:
                    raise VerifyError(f"register {i.result.short()} redefined")
                seen_regs.add(id(i.result))


def verify_split_join(fn: Function) -> None:
    """MIR-safety-net invariant: along every path, vx_split/vx_join are
    properly nested and every token joins exactly once (paper §4.3, Fig 5)."""
    from .graph import rpo  # local import to avoid cycle
    # DFS over CFG paths with a token-stack, memoized by (block, depth-sig).
    entry = fn.entry
    seen: Dict[Tuple[int, Tuple[int, ...]], bool] = {}

    def walk(block: Block, stack: Tuple[int, ...]) -> None:
        key = (id(block), stack)
        if key in seen:
            return
        seen[key] = True
        st = list(stack)
        for i in block.instrs:
            if i.op is Op.SPLIT:
                st.append(id(i.result))
            elif i.op is Op.JOIN:
                tok = i.operands[0]
                if not st or st[-1] != id(tok):
                    raise VerifyError(
                        f"vx_join token mismatch in %{block.name} of @{fn.name}")
                st.pop()
            elif i.op is Op.RET and st:
                raise VerifyError(
                    f"return with open IPDOM stack in %{block.name}")
        for s in block.successors():
            walk(s, tuple(st))

    walk(entry, ())
