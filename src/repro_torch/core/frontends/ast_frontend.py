"""Python-AST kernel front-end -> VIR.

Both GPU dialects (OpenCL-like and CUDA-like) share this translator, the way
PoCL and CuPBoP both lower to LLVM IR in the paper (composability principle:
one AST->VIR builder, per-dialect intrinsic tables plugged in).

Exit legalization (front-end structurization)
---------------------------------------------
``return``/``break``/``continue`` in nested control flow are lowered to
*exit-predicate slots* plus guard branches that skip the remainder of each
enclosing syntactic block.  This is the linearization-predicate computation
the paper attributes to CFG structurization (§4.3.2); doing it where regions
are still syntactic guarantees the invariants the rest of the pipeline needs:

  * every loop exits through its header only (canonical Fig 2b shape:
    header predicate = ``cond && !brk && !ret``),
  * every branch's split/join region is well nested w.r.t. its IPDOM,
  * the CFG is reducible by construction (hand-built IR can still be
    irreducible; passes/structurize.py handles that case).

Supported kernel-language subset: scalar locals, pointer/shared-array
subscripts, if/elif/else, while, for-in-range, break/continue/return,
ternary, and/or/not (non-short-circuit, documented), math built-ins, dialect
intrinsics, calls to @device functions (feeds Algorithm 1).

Parameter annotations: ``"f32"``, ``"i32 uniform"``, ``"ptr_f32 const"`` ...
``uniform`` is *recorded* here and only *honored* when annotation analysis
is enabled (paper ablation Uni-Ann).
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..vir import (AddrSpace, Block, Const, Function, GlobalVar, IRBuilder,
                   Module, Op, Param, Reg, Slot, Ty, Value)


class CompileError(Exception):
    pass


# --------------------------------------------------------------------------
# Dialect plug-in interface
# --------------------------------------------------------------------------

@dataclass
class Dialect:
    """Per-language intrinsic tables."""

    name: str
    # name -> handler(tr: Translator, args: List[Value]) -> Optional[Value]
    call_handlers: Dict[str, Callable] = field(default_factory=dict)
    # base.attr -> handler(tr) -> Value   (e.g. threadIdx.x)
    attr_handlers: Dict[Tuple[str, str], Callable] = field(default_factory=dict)
    # names treated as shared-array declarators: x = __shared__(f32, 128)
    shared_decls: Tuple[str, ...] = ()


_TY_NAMES = {
    "f32": Ty.F32, "float": Ty.F32,
    "i32": Ty.I32, "int": Ty.I32,
    "bool": Ty.BOOL, "i1": Ty.BOOL,
}
_PTR_NAMES = {
    "ptr_f32": Ty.F32, "ptr_i32": Ty.I32,
    "ptr_float": Ty.F32, "ptr_int": Ty.I32,
}


def parse_param_annotation(name: str, ann: Any) -> Param:
    if ann is None:
        return Param(name, Ty.F32)
    if isinstance(ann, str):
        words = ann.replace(",", " ").split()
    else:
        raise CompileError(f"unsupported annotation on {name}: {ann!r}")
    uniform = "uniform" in words
    readonly = "const" in words or "restrict" in words
    base = [w for w in words if w not in ("uniform", "const", "restrict")]
    if not base:
        raise CompileError(f"no base type in annotation for {name}")
    b = base[0]
    if b in _PTR_NAMES:
        p = Param(name, Ty.PTR, space=AddrSpace.GLOBAL,
                  uniform=uniform, readonly=readonly)
        p.elem_ty = _PTR_NAMES[b]  # type: ignore[attr-defined]
        return p
    if b in _TY_NAMES:
        return Param(name, _TY_NAMES[b], uniform=uniform, readonly=readonly)
    raise CompileError(f"unknown type {b!r} for param {name}")


# --------------------------------------------------------------------------
# AST pre-scan: which exits occur in a loop body?
# --------------------------------------------------------------------------

def _scan_exits(body: Sequence[ast.stmt]) -> Tuple[bool, bool, bool]:
    """(has_break, has_continue, has_return) — break/continue only at this
    loop's level (not inside nested loops); return at any depth."""
    has_b = has_c = has_r = False

    def walk(stmts: Sequence[ast.stmt], loop_depth: int) -> None:
        nonlocal has_b, has_c, has_r
        for s in stmts:
            if isinstance(s, ast.Break) and loop_depth == 0:
                has_b = True
            elif isinstance(s, ast.Continue) and loop_depth == 0:
                has_c = True
            elif isinstance(s, ast.Return):
                has_r = True
            elif isinstance(s, (ast.For, ast.While)):
                walk(s.body, loop_depth + 1)
                walk(s.orelse, loop_depth)
            elif isinstance(s, ast.If):
                walk(s.body, loop_depth)
                walk(s.orelse, loop_depth)

    walk(body, 0)
    return has_b, has_c, has_r


class _LoopCtx:
    def __init__(self, brk: Optional[Slot], cnt: Optional[Slot],
                 checks_ret: bool) -> None:
        self.brk = brk
        self.cnt = cnt
        self.checks_ret = checks_ret


# --------------------------------------------------------------------------
# Translator
# --------------------------------------------------------------------------

class Translator:
    def __init__(self, module: Module, dialect: Dialect,
                 pyfunc: Callable, *, internal: bool = False,
                 func_name: Optional[str] = None) -> None:
        self.module = module
        self.dialect = dialect
        self.pyfunc = pyfunc
        self.globals_ns = getattr(pyfunc, "__globals__", {})
        src = textwrap.dedent(inspect.getsource(pyfunc))
        tree = ast.parse(src)
        fdefs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
        if not fdefs:
            raise CompileError("no function definition found")
        self.fdef = fdefs[0]
        name = func_name or self.fdef.name

        params: List[Param] = []
        for a in self.fdef.args.args:
            ann = None
            if a.annotation is not None:
                if isinstance(a.annotation, ast.Constant):
                    ann = a.annotation.value
                else:
                    ann = ast.unparse(a.annotation)
                    resolved = self.globals_ns.get(ann, ann)
                    ann = resolved if isinstance(resolved, str) else ann
            params.append(parse_param_annotation(a.arg, ann))

        ret_ty = Ty.VOID
        if self.fdef.returns is not None:
            r = (self.fdef.returns.value
                 if isinstance(self.fdef.returns, ast.Constant)
                 else ast.unparse(self.fdef.returns))
            rr = self.globals_ns.get(r, r) if isinstance(r, str) else r
            if isinstance(rr, str):
                words = rr.split()
                ret_ty = _TY_NAMES.get(words[0], Ty.F32)
                if "uniform" in words:
                    pass  # recorded below
        self.fn = Function(name, params, ret_ty, internal=internal)
        self.module.add(self.fn)
        entry = self.fn.new_block("entry")
        self.b = IRBuilder(self.fn, entry)
        self.env: Dict[str, Any] = {p.name: p for p in params}
        self.loop_stack: List[_LoopCtx] = []
        self.if_depth = 0
        self.dead = False          # rest of current syntactic block is dead
        self.ret_flag: Optional[Slot] = None
        self.ret_val: Optional[Slot] = None
        self.flags_live: set = set()   # Slots that may be set at this point
        if self.fdef.returns is not None:
            r = ast.unparse(self.fdef.returns)
            rv = self.globals_ns.get(r, r)
            if isinstance(rv, str) and "uniform" in rv:
                self.fn.attrs["ret_uniform_annotated"] = True

    # -- public ------------------------------------------------------------
    def run(self) -> Function:
        self._stmts(self.fdef.body)
        if self.b.block.terminator is None:
            if self.fn.ret_ty is Ty.VOID:
                self.b.ret()
            elif self.ret_val is not None:
                self.b.ret(self.b.slot_load(self.ret_val))
            else:
                self.b.ret(Const(0 if self.fn.ret_ty is Ty.I32 else 0.0,
                                 self.fn.ret_ty))
        return self.fn

    # -- flag helpers --------------------------------------------------------
    def _ensure_ret_slots(self) -> None:
        if self.ret_flag is None:
            self.ret_flag = self.fn.new_slot("__ret", Ty.BOOL)
            init = [(self.ret_flag, Const(False, Ty.BOOL))]
            if self.fn.ret_ty is not Ty.VOID:
                self.ret_val = self.fn.new_slot("__retval", self.fn.ret_ty)
                zero = Const(0 if self.fn.ret_ty is Ty.I32 else
                             (False if self.fn.ret_ty is Ty.BOOL else 0.0),
                             self.fn.ret_ty)
                init.append((self.ret_val, zero))
            from ..vir import Instr
            for pos, (slot, val) in enumerate(init):
                self.fn.entry.insert(pos, Instr(Op.SLOT_STORE, [slot, val]))

    def _relevant_flags(self) -> List[Slot]:
        out: List[Slot] = []
        if self.ret_flag is not None and self.ret_flag in self.flags_live:
            out.append(self.ret_flag)
        if self.loop_stack:
            ctx = self.loop_stack[-1]
            for sl in (ctx.brk, ctx.cnt):
                if sl is not None and sl in self.flags_live:
                    out.append(sl)
        return out

    # -- type helpers --------------------------------------------------------
    def _coerce(self, v: Value, ty: Ty) -> Value:
        if v.ty == ty:
            return v
        if v.ty is Ty.I32 and ty is Ty.F32:
            return self.b.unop(Op.ITOF, v)
        if v.ty is Ty.F32 and ty is Ty.I32:
            return self.b.unop(Op.FTOI, v)
        if v.ty is Ty.BOOL and ty is Ty.I32:
            return self.b.select(v, Const(1, Ty.I32), Const(0, Ty.I32))
        if v.ty is Ty.BOOL and ty is Ty.F32:
            return self.b.select(v, Const(1.0, Ty.F32), Const(0.0, Ty.F32))
        if v.ty is Ty.I32 and ty is Ty.BOOL:
            return self.b.binop(Op.NE, v, Const(0, Ty.I32))
        raise CompileError(f"cannot coerce {v.ty} -> {ty}")

    def _promote(self, a: Value, b: Value) -> Tuple[Value, Value, Ty]:
        if a.ty == b.ty:
            return a, b, a.ty
        if Ty.F32 in (a.ty, b.ty):
            return self._coerce(a, Ty.F32), self._coerce(b, Ty.F32), Ty.F32
        return self._coerce(a, Ty.I32), self._coerce(b, Ty.I32), Ty.I32

    def _as_bool(self, v: Value) -> Value:
        if v.ty is Ty.BOOL:
            return v
        if v.ty is Ty.I32:
            return self.b.binop(Op.NE, v, Const(0, Ty.I32))
        if v.ty is Ty.F32:
            return self.b.binop(Op.NE, v, Const(0.0, Ty.F32))
        raise CompileError(f"cannot use {v.ty} as condition")

    # -- statement sequence with guard insertion ------------------------------
    def _stmts(self, body: Sequence[ast.stmt]) -> None:
        """Translate a statement list, inserting exit-predicate guards.

        Guards are *flow-chained* (LLVM StructurizeCFG style): guard k's
        skip edge lands on guard k+1's check block, never on the final
        block end.  This keeps every guard diamond's IPDOM at the next
        check, so split/join regions nest perfectly — a skip edge straight
        to the sequence end would bypass inner splits (misaligned
        reconvergence, the exact hazard the IPDOM stack cannot absorb).
        """
        from ..vir import Instr
        land: Optional[Block] = None   # previous guard's landing block
        for idx, s in enumerate(body):
            if self.dead:
                break
            self._stmt(s)
            if self.dead:
                break
            flags = self._relevant_flags()
            if flags and idx < len(body) - 1:
                chk = self.fn.new_block("guard.chk")
                if self.b.block.terminator is None:
                    self.b.br(chk)
                if land is not None:
                    land.append(Instr(Op.BR, [chk]))
                self.b.set_block(chk)
                any_ = self.b.slot_load(flags[0])
                for sl in flags[1:]:
                    any_ = self.b.binop(Op.OR, any_, self.b.slot_load(sl))
                rest = self.fn.new_block("guard.rest")
                land = self.fn.new_block("guard.land")
                self.b.cbr(any_, land, rest)
                self.b.set_block(rest)
        if land is not None:
            end_bb = self.fn.new_block("blk.end")
            if self.b.block.terminator is None:
                self.b.br(end_bb)
            land.append(Instr(Op.BR, [end_bb]))
            self.b.set_block(end_bb)
        self.dead = False

    def _stmt(self, s: ast.stmt) -> None:
        m = getattr(self, f"_stmt_{type(s).__name__}", None)
        if m is None:
            raise CompileError(f"unsupported statement {type(s).__name__} "
                               f"at line {s.lineno}")
        m(s)

    def _stmt_Pass(self, s: ast.Pass) -> None:
        pass

    def _stmt_Expr(self, s: ast.Expr) -> None:
        if isinstance(s.value, ast.Constant):   # docstring
            return
        self._expr(s.value)

    def _stmt_Assign(self, s: ast.Assign) -> None:
        if len(s.targets) != 1:
            raise CompileError("multiple assignment targets unsupported")
        self._assign(s.targets[0], s.value)

    def _stmt_AnnAssign(self, s: ast.AnnAssign) -> None:
        if s.value is None:
            raise CompileError("annotated declaration needs a value")
        hint = False
        ann = ast.unparse(s.annotation)
        annv = self.globals_ns.get(ann, ann)
        if isinstance(s.annotation, ast.Constant):
            annv = s.annotation.value
        if isinstance(annv, str) and "uniform" in annv:
            hint = True
        self._assign(s.target, s.value, uniform_hint=hint)

    def _assign(self, target: ast.expr, value_node: ast.expr,
                uniform_hint: bool = False) -> None:
        if (isinstance(value_node, ast.Call)
                and isinstance(value_node.func, ast.Name)
                and value_node.func.id in self.dialect.shared_decls):
            if not isinstance(target, ast.Name):
                raise CompileError("shared decl target must be a name")
            args = value_node.args
            ety = Ty.F32
            if args and isinstance(args[0], ast.Name):
                ety = _TY_NAMES.get(args[0].id, Ty.F32)
            elif args and isinstance(args[0], ast.Constant):
                ety = _TY_NAMES.get(str(args[0].value), Ty.F32)
            size = self._const_int(args[1]) if len(args) > 1 else 0
            g = self.fn.new_shared(target.id, ety, size)
            self.env[target.id] = g
            return

        val = self._expr(value_node)
        if isinstance(target, ast.Name):
            name = target.id
            cur = self.env.get(name)
            if isinstance(cur, Slot):
                self.b.slot_store(cur, self._coerce(val, cur.ty))
            else:
                slot = self.fn.new_slot(name, val.ty, uniform_hint)
                self.env[name] = slot
                self.b.slot_store(slot, val)
        elif isinstance(target, ast.Subscript):
            ptr, idx, ety = self._subscript(target)
            self.b.store(ptr, idx, self._coerce(val, ety))
        else:
            raise CompileError(
                f"unsupported assignment target {type(target).__name__}")

    def _stmt_AugAssign(self, s: ast.AugAssign) -> None:
        opmap = {ast.Add: Op.ADD, ast.Sub: Op.SUB, ast.Mult: Op.MUL,
                 ast.Div: Op.DIV, ast.Mod: Op.MOD, ast.FloorDiv: Op.DIV,
                 ast.BitAnd: Op.AND, ast.BitOr: Op.OR, ast.BitXor: Op.XOR,
                 ast.LShift: Op.SHL, ast.RShift: Op.SHR}
        op = opmap.get(type(s.op))
        if op is None:
            raise CompileError(f"unsupported aug-op {type(s.op).__name__}")
        if isinstance(s.target, ast.Name):
            cur = self._expr(ast.Name(id=s.target.id, ctx=ast.Load()))
            rhs = self._expr(s.value)
            a, b2, _ = self._promote(cur, rhs)
            res = self.b.binop(op, a, b2)
            slot = self.env.get(s.target.id)
            if not isinstance(slot, Slot):
                raise CompileError(f"aug-assign to non-local {s.target.id}")
            self.b.slot_store(slot, self._coerce(res, slot.ty))
        elif isinstance(s.target, ast.Subscript):
            ptr, idx, ety = self._subscript(s.target)
            cur = self.b.load(ptr, idx, ety)
            rhs = self._expr(s.value)
            a, b2, _ = self._promote(cur, rhs)
            res = self.b.binop(op, a, b2)
            self.b.store(ptr, idx, self._coerce(res, ety))
        else:
            raise CompileError("unsupported aug-assign target")

    # -- control flow ----------------------------------------------------------
    def _stmt_If(self, s: ast.If) -> None:
        cond = self._as_bool(self._expr(s.test))
        then_bb = self.fn.new_block("then")
        else_bb = self.fn.new_block("else") if s.orelse else None
        merge_bb = self.fn.new_block("endif")
        self.b.cbr(cond, then_bb, else_bb or merge_bb)
        self.if_depth += 1
        self.b.set_block(then_bb)
        self._stmts(s.body)
        if self.b.block.terminator is None:
            self.b.br(merge_bb)
        if else_bb is not None:
            self.b.set_block(else_bb)
            self._stmts(s.orelse)
            if self.b.block.terminator is None:
                self.b.br(merge_bb)
        self.if_depth -= 1
        self.b.set_block(merge_bb)

    def _loop_prologue(self, body: Sequence[ast.stmt]) -> _LoopCtx:
        has_b, has_c, has_r = _scan_exits(body)
        brk = cnt = None
        if has_b:
            brk = self.fn.new_slot(f"__brk{len(self.fn.slots)}", Ty.BOOL)
            self.b.slot_store(brk, Const(False, Ty.BOOL))
        if has_c:
            cnt = self.fn.new_slot(f"__cnt{len(self.fn.slots)}", Ty.BOOL)
            self.b.slot_store(cnt, Const(False, Ty.BOOL))
        if has_r:
            self._ensure_ret_slots()
        return _LoopCtx(brk, cnt, has_r)

    def _augment_cond(self, cond: Value, ctx: _LoopCtx) -> Value:
        c = cond
        if ctx.brk is not None:
            nb = self.b.unop(Op.NOT, self.b.slot_load(ctx.brk))
            c = self.b.binop(Op.AND, c, nb)
        if ctx.checks_ret and self.ret_flag is not None:
            nr = self.b.unop(Op.NOT, self.b.slot_load(self.ret_flag))
            c = self.b.binop(Op.AND, c, nr)
        return c

    def _stmt_While(self, s: ast.While) -> None:
        ctx = self._loop_prologue(s.body)
        cond_bb = self.fn.new_block("while.cond")
        body_bb = self.fn.new_block("while.body")
        exit_bb = self.fn.new_block("while.end")
        self.b.br(cond_bb)
        self.b.set_block(cond_bb)
        cond = self._augment_cond(self._as_bool(self._expr(s.test)), ctx)
        self.b.cbr(cond, body_bb, exit_bb)
        self.loop_stack.append(ctx)
        self.b.set_block(body_bb)
        self._stmts(s.body)
        # latch: clear continue flag, back to header
        if self.b.block.terminator is None:
            if ctx.cnt is not None:
                self.b.slot_store(ctx.cnt, Const(False, Ty.BOOL))
            self.b.br(cond_bb)
        self.loop_stack.pop()
        for sl in (ctx.brk, ctx.cnt):
            if sl is not None:
                self.flags_live.discard(sl)
        self.b.set_block(exit_bb)

    def _stmt_For(self, s: ast.For) -> None:
        if not (isinstance(s.iter, ast.Call) and isinstance(s.iter.func, ast.Name)
                and s.iter.func.id == "range"):
            raise CompileError("only range() for-loops are supported")
        if not isinstance(s.target, ast.Name):
            raise CompileError("for target must be a name")
        args = [self._expr(a) for a in s.iter.args]
        if len(args) == 1:
            start, stop, step = Const(0, Ty.I32), args[0], Const(1, Ty.I32)
        elif len(args) == 2:
            start, stop, step = args[0], args[1], Const(1, Ty.I32)
        else:
            start, stop, step = args
        ivname = s.target.id
        slot = self.env.get(ivname)
        if not isinstance(slot, Slot):
            slot = self.fn.new_slot(ivname, Ty.I32)
            self.env[ivname] = slot
        # hoist loop bounds into slots so the header re-reads them
        stop_slot = self.fn.new_slot(f"__stop{len(self.fn.slots)}", Ty.I32)
        self.b.slot_store(stop_slot, self._coerce(stop, Ty.I32))
        step_slot = self.fn.new_slot(f"__step{len(self.fn.slots)}", Ty.I32)
        self.b.slot_store(step_slot, self._coerce(step, Ty.I32))
        ctx = self._loop_prologue(s.body)
        self.b.slot_store(slot, self._coerce(start, Ty.I32))
        cond_bb = self.fn.new_block("for.cond")
        body_bb = self.fn.new_block("for.body")
        latch_bb = self.fn.new_block("for.latch")
        exit_bb = self.fn.new_block("for.end")
        self.b.br(cond_bb)
        self.b.set_block(cond_bb)
        iv = self.b.slot_load(slot)
        base_cond = self.b.binop(Op.LT, iv, self.b.slot_load(stop_slot))
        cond = self._augment_cond(base_cond, ctx)
        self.b.cbr(cond, body_bb, exit_bb)
        self.loop_stack.append(ctx)
        self.b.set_block(body_bb)
        self._stmts(s.body)
        if self.b.block.terminator is None:
            self.b.br(latch_bb)
        self.b.set_block(latch_bb)
        if ctx.cnt is not None:
            self.b.slot_store(ctx.cnt, Const(False, Ty.BOOL))
        # Predicated increment: when break/return fired this iteration the
        # induction variable must not advance.  Emitted as a well-nested
        # diamond inside the latch (join at latch.end) — NOT as a branch to
        # the header, which would put a split/join across the back edge.
        skip = None
        if ctx.brk is not None:
            skip = self.b.slot_load(ctx.brk)
        if ctx.checks_ret and self.ret_flag is not None:
            r = self.b.slot_load(self.ret_flag)
            skip = r if skip is None else self.b.binop(Op.OR, skip, r)
        if skip is not None:
            inc_bb = self.fn.new_block("for.inc")
            latch_end = self.fn.new_block("for.latch.end")
            self.b.cbr(skip, latch_end, inc_bb)
            self.b.set_block(inc_bb)
            iv2 = self.b.slot_load(slot)
            nxt = self.b.binop(Op.ADD, iv2, self.b.slot_load(step_slot))
            self.b.slot_store(slot, nxt)
            self.b.br(latch_end)
            self.b.set_block(latch_end)
            self.b.br(cond_bb)
        else:
            iv2 = self.b.slot_load(slot)
            nxt = self.b.binop(Op.ADD, iv2, self.b.slot_load(step_slot))
            self.b.slot_store(slot, nxt)
            self.b.br(cond_bb)
        self.loop_stack.pop()
        for sl in (ctx.brk, ctx.cnt):
            if sl is not None:
                self.flags_live.discard(sl)
        self.b.set_block(exit_bb)

    def _stmt_Break(self, s: ast.Break) -> None:
        if not self.loop_stack:
            raise CompileError("break outside loop")
        ctx = self.loop_stack[-1]
        assert ctx.brk is not None
        self.b.slot_store(ctx.brk, Const(True, Ty.BOOL))
        self.flags_live.add(ctx.brk)
        self.dead = True

    def _stmt_Continue(self, s: ast.Continue) -> None:
        if not self.loop_stack:
            raise CompileError("continue outside loop")
        ctx = self.loop_stack[-1]
        assert ctx.cnt is not None
        self.b.slot_store(ctx.cnt, Const(True, Ty.BOOL))
        self.flags_live.add(ctx.cnt)
        self.dead = True

    def _stmt_Return(self, s: ast.Return) -> None:
        if not self.loop_stack and self.if_depth == 0:
            # top level: direct terminator
            if s.value is None:
                self.b.ret()
            else:
                v = self._expr(s.value)
                self.b.ret(self._coerce(v, self.fn.ret_ty))
            self.dead = True
            return
        self._ensure_ret_slots()
        if s.value is not None:
            v = self._expr(s.value)
            assert self.ret_val is not None
            self.b.slot_store(self.ret_val, self._coerce(v, self.fn.ret_ty))
        assert self.ret_flag is not None
        self.b.slot_store(self.ret_flag, Const(True, Ty.BOOL))
        self.flags_live.add(self.ret_flag)
        self.dead = True

    # -- expressions ---------------------------------------------------------
    def _expr(self, e: ast.expr) -> Value:
        m = getattr(self, f"_expr_{type(e).__name__}", None)
        if m is None:
            raise CompileError(f"unsupported expression {type(e).__name__} "
                               f"at line {getattr(e, 'lineno', '?')}")
        return m(e)

    def _expr_Constant(self, e: ast.Constant) -> Value:
        v = e.value
        if isinstance(v, bool):
            return Const(bool(v), Ty.BOOL)
        if isinstance(v, int):
            return Const(int(v), Ty.I32)
        if isinstance(v, float):
            return Const(float(v), Ty.F32)
        raise CompileError(f"unsupported literal {v!r}")

    def _expr_Name(self, e: ast.Name) -> Value:
        name = e.id
        v = self.env.get(name)
        if isinstance(v, Slot):
            return self.b.slot_load(v)
        if isinstance(v, (Param, GlobalVar)):
            return v
        if name in self.module.globals:
            return self.module.globals[name]
        if name in self.globals_ns:
            pv = self.globals_ns[name]
            if isinstance(pv, bool):
                return Const(pv, Ty.BOOL)
            if isinstance(pv, int):
                return Const(pv, Ty.I32)
            if isinstance(pv, float):
                return Const(pv, Ty.F32)
            if isinstance(pv, GlobalVar):
                return pv
        raise CompileError(f"unknown name {name!r}")

    def _expr_Attribute(self, e: ast.Attribute) -> Value:
        if isinstance(e.value, ast.Name):
            key = (e.value.id, e.attr)
            h = self.dialect.attr_handlers.get(key)
            if h is not None:
                return h(self)
        raise CompileError(f"unsupported attribute {ast.unparse(e)}")

    def _expr_BinOp(self, e: ast.BinOp) -> Value:
        opmap = {ast.Add: Op.ADD, ast.Sub: Op.SUB, ast.Mult: Op.MUL,
                 ast.Div: Op.DIV, ast.Mod: Op.MOD, ast.FloorDiv: Op.DIV,
                 ast.BitAnd: Op.AND, ast.BitOr: Op.OR, ast.BitXor: Op.XOR,
                 ast.LShift: Op.SHL, ast.RShift: Op.SHR, ast.Pow: Op.POW}
        op = opmap.get(type(e.op))
        if op is None:
            raise CompileError(f"unsupported binop {type(e.op).__name__}")
        a = self._expr(e.left)
        b = self._expr(e.right)
        if op is Op.DIV and isinstance(e.op, ast.Div):
            return self.b.binop(op, self._coerce(a, Ty.F32),
                                self._coerce(b, Ty.F32))
        a2, b2, _ = self._promote(a, b)
        return self.b.binop(op, a2, b2)

    def _expr_UnaryOp(self, e: ast.UnaryOp) -> Value:
        v = self._expr(e.operand)
        if isinstance(e.op, ast.USub):
            return self.b.unop(Op.NEG, v)
        if isinstance(e.op, ast.Not):
            return self.b.unop(Op.NOT, self._as_bool(v))
        if isinstance(e.op, ast.Invert):
            return self.b.unop(Op.NOT, v)
        if isinstance(e.op, ast.UAdd):
            return v
        raise CompileError("unsupported unary op")

    def _expr_Compare(self, e: ast.Compare) -> Value:
        if len(e.ops) != 1:
            raise CompileError("chained comparisons unsupported")
        opmap = {ast.Eq: Op.EQ, ast.NotEq: Op.NE, ast.Lt: Op.LT,
                 ast.LtE: Op.LE, ast.Gt: Op.GT, ast.GtE: Op.GE}
        op = opmap.get(type(e.ops[0]))
        if op is None:
            raise CompileError("unsupported comparison")
        a = self._expr(e.left)
        b = self._expr(e.comparators[0])
        a2, b2, _ = self._promote(a, b)
        return self.b.binop(op, a2, b2)

    def _expr_BoolOp(self, e: ast.BoolOp) -> Value:
        # NOTE: non-short-circuit lowering (documented deviation); kernel
        # conditions in the suite are side-effect-free.
        op = Op.AND if isinstance(e.op, ast.And) else Op.OR
        vals = [self._as_bool(self._expr(v)) for v in e.values]
        acc = vals[0]
        for v in vals[1:]:
            acc = self.b.binop(op, acc, v)
        return acc

    def _expr_IfExp(self, e: ast.IfExp) -> Value:
        cond = self._as_bool(self._expr(e.test))
        a = self._expr(e.body)
        b = self._expr(e.orelse)
        a2, b2, _ = self._promote(a, b)
        return self.b.select(cond, a2, b2)

    def _expr_Subscript(self, e: ast.Subscript) -> Value:
        ptr, idx, ety = self._subscript(e)
        return self.b.load(ptr, idx, ety)

    def _subscript(self, e: ast.Subscript) -> Tuple[Value, Value, Ty]:
        base = self._expr(e.value)
        if base.ty is not Ty.PTR:
            raise CompileError("subscript of non-pointer")
        idx = self._coerce(self._expr(e.slice), Ty.I32)
        ety = getattr(base, "elem_ty", Ty.F32)
        return base, idx, ety

    def _const_int(self, e: ast.expr) -> int:
        if isinstance(e, ast.Constant) and isinstance(e.value, int):
            return e.value
        if isinstance(e, ast.Name) and e.id in self.globals_ns:
            v = self.globals_ns[e.id]
            if isinstance(v, int):
                return v
        raise CompileError("expected compile-time integer constant")

    def _expr_Call(self, e: ast.Call) -> Value:
        if isinstance(e.func, ast.Name):
            name = e.func.id
            h = self.dialect.call_handlers.get(name)
            if h is not None:
                args = [self._expr(a) for a in e.args]
                r = h(self, args)
                return r if r is not None else Const(0, Ty.I32)
            mathmap = {"sqrt": Op.SQRT, "exp": Op.EXP, "log": Op.LOG,
                       "sin": Op.SIN, "cos": Op.COS, "abs": Op.ABS,
                       "fabs": Op.ABS}
            if name in mathmap:
                v = self._expr(e.args[0])
                if name == "abs" and v.ty is Ty.I32:
                    return self.b.unop(Op.ABS, v)
                return self.b.unop(mathmap[name], self._coerce(v, Ty.F32))
            if name in ("min", "max"):
                a = self._expr(e.args[0])
                b = self._expr(e.args[1])
                a2, b2, _ = self._promote(a, b)
                return self.b.binop(Op.MIN if name == "min" else Op.MAX,
                                    a2, b2)
            if name == "float":
                return self._coerce(self._expr(e.args[0]), Ty.F32)
            if name == "int":
                return self._coerce(self._expr(e.args[0]), Ty.I32)
            if name == "pow":
                a = self._coerce(self._expr(e.args[0]), Ty.F32)
                b = self._coerce(self._expr(e.args[1]), Ty.F32)
                return self.b.binop(Op.POW, a, b)
            if name in self.module.functions:
                callee = self.module.functions[name]
                args = [self._coerce(self._expr(a), p.ty)
                        for a, p in zip(e.args, callee.params)]
                r = self.b.call(callee, args)
                return r if r is not None else Const(0, Ty.I32)
            pv = self.globals_ns.get(name)
            vfn = getattr(pv, "_vir_function", None)
            if vfn is not None and vfn.name in self.module.functions:
                callee = self.module.functions[vfn.name]
                args = [self._coerce(self._expr(a), p.ty)
                        for a, p in zip(e.args, callee.params)]
                r = self.b.call(callee, args)
                return r if r is not None else Const(0, Ty.I32)
        raise CompileError(f"unknown call {ast.unparse(e)}")


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def compile_python_kernel(module: Module, dialect: Dialect, pyfunc: Callable,
                          *, internal: bool = False,
                          device_deps: Sequence[Callable] = ()) -> Function:
    """Translate ``pyfunc`` (and its @device dependencies, in order) to VIR
    inside ``module``. Returns the kernel Function."""
    for dep in device_deps:
        if getattr(dep, "_vir_function", None) is None or \
                dep._vir_function.name not in module.functions:
            f = Translator(module, dialect, dep, internal=True).run()
            dep._vir_function = f  # type: ignore[attr-defined]
    fn = Translator(module, dialect, pyfunc, internal=internal).run()
    return fn
