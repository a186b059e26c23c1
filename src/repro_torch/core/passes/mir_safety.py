"""The lightweight late safety net (paper §4.3, Fig 5).

VOLT plans divergence at the IR level; late machine-level passes can still
perturb it.  This pass runs *last* and repairs the three hazards:

  (a) **late branch inversion** — a pass swapped a cbr's targets and/or
      negated its condition after vx_split insertion: detect that the
      split's predicate and the branch predicate are logical negations (or
      the targets were swapped) and flip the split's *negate* flag so lane
      semantics align;
  (b) **predicate drift** — the branch predicate was reloaded into a new
      register (spill/reload) while vx_split still references the old one:
      unify the split operand with the machine branch predicate and move
      them back-to-back;
  (c) **late select expansion** — a divergent SELECT survived to this point
      (e.g. re-introduced by a late simplification): reify it as a diamond
      with {vx_split, vx_join} here.

Then it verifies: split/join pairing along all paths, token validity, PRED
token/mask-restore pairing.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..vir import (Block, Function, Instr, Op, Reg, Ty, VerifyError,
                   verify_split_join)
from .uniformity import UniformityInfo, VortexTTI
from .zicond import _reify_select


def _is_not_of(a, b) -> bool:
    """a == NOT(b)?"""
    if isinstance(a, Reg) and a.defining is not None \
            and a.defining.op is Op.NOT:
        return a.defining.operands[0] is b
    return False


def _same_slot_load(a, b) -> bool:
    return (isinstance(a, Reg) and isinstance(b, Reg)
            and a.defining is not None and b.defining is not None
            and a.defining.op is Op.SLOT_LOAD
            and b.defining.op is Op.SLOT_LOAD
            and a.defining.operands[0] is b.defining.operands[0])


def run_mir_safety(fn: Function, info: Optional[UniformityInfo] = None,
                   tti: Optional[VortexTTI] = None) -> Dict[str, int]:
    stats = {"negate_fixed": 0, "drift_unified": 0, "late_selects": 0,
             "moved_back_to_back": 0}

    # (c) late divergent selects -> diamond + split/join
    if info is not None and not (tti is not None and tti.has_zicond):
        changed = True
        while changed:
            changed = False
            for b in list(fn.blocks):
                for pos, i in enumerate(b.instrs):
                    if i.op is Op.SELECT and i.result is not None and \
                            not info.is_uniform(i.operands[0]):
                        _reify_select(fn, b, pos, i)
                        # fresh diamond needs split/join too
                        cbr = b.terminator
                        assert cbr is not None and cbr.op is Op.CBR
                        tok = Reg(Ty.TOKEN, "ipdom")
                        split = Instr(Op.SPLIT, [cbr.operands[0]], tok,
                                      attrs={"negate": False})
                        b.insert(len(b.instrs) - 1, split)
                        merge = cbr.operands[1].successors()[0]
                        merge.insert(0, Instr(Op.JOIN, [tok]))
                        stats["late_selects"] += 1
                        changed = True
                        break
                if changed:
                    break

    # (a)+(b): per-block split/branch predicate reconciliation
    for b in fn.blocks:
        t = b.terminator
        if t is None or t.op not in (Op.CBR, Op.PRED):
            continue
        split = None
        for i in b.instrs[:-1]:
            if i.op is Op.SPLIT:
                split = i
        if split is None:
            continue
        bc = t.operands[0]
        sc = split.operands[0]
        if sc is bc:
            pass
        elif _is_not_of(bc, sc) or _is_not_of(sc, bc):
            # paper-minimal repair: flip ONLY the negate flag so the split's
            # effective lane predicate (negate ? ~pred : pred) matches the
            # (possibly inverted) machine branch — the register is kept.
            split.attrs["negate"] = not split.attrs.get("negate", False)
            # attrs-only edit: analyses stay valid, interpreter re-decodes
            fn.bump_version(cfg=False, dataflow=False)
            stats["negate_fixed"] += 1
        elif _same_slot_load(sc, bc):
            # predicate drift: same slot reloaded into a fresh vreg
            split.operands[0] = bc
            fn.bump_version(cfg=False)
            stats["drift_unified"] += 1
        # move split back-to-back with the terminator
        if b.instrs[-2] is not split:
            b.instrs.remove(split)
            b.insert(len(b.instrs) - 1, split)
            stats["moved_back_to_back"] += 1

    # final structural verification
    verify_split_join(fn)
    _verify_pred_tokens(fn)
    return stats


def _verify_pred_tokens(fn: Function) -> None:
    saves = {id(i.result) for i in fn.instructions() if i.op is Op.TMC_SAVE}
    for i in fn.instructions():
        if i.op is Op.PRED:
            tok = i.operands[1]
            if id(tok) not in saves:
                raise VerifyError("vx_pred token without tmc_save")
        if i.op is Op.TMC_RESTORE:
            tok = i.operands[0]
            if id(tok) not in saves:
                raise VerifyError("tmc_restore token without tmc_save")
