"""SimX-inspired cycle model (paper §5 evaluation substrate).

The interpreter (interp.py) produces deterministic per-class dynamic
instruction counts plus coalesced memory-request counts; this model converts
them to cycles.  It is intentionally simple — the paper's claims we
reproduce are *relative* (speedup ratios across compiler configurations on
identical inputs), for which a linear issue+memory model with a coalescing
term captures the first-order behavior, including the ZiCond
memory-request-density regression on pathfinder/transpose (Fig 8) and the
shared-memory mapping trade-off (Fig 10).

Cost structure (per warp-issued instruction):
  * 1 cycle issue for ALU/control;
  * SFU ops (div/sqrt/exp/log/sin/cos/pow) take ``sfu_cost``;
  * each load/store instruction pays ``mem_issue``; each *coalesced line
    request* pays ``line_cost`` for the mapped memory (global HBM vs
    per-core local memory) — Case Study 2's shared-memory mapping choice is
    the ``shared_in_local`` flag;
  * divergence-management ops cost 1 (they execute on the SFU in Vortex).
"""
from __future__ import annotations

from dataclasses import dataclass

from .interp import ExecStats

_SFU = {"div", "pow", "sqrt", "exp", "log", "sin", "cos", "mod"}
_MEM = {"load", "store", "atomic"}


@dataclass
class CycleModel:
    alu_cost: float = 1.0
    sfu_cost: float = 4.0
    mem_issue: float = 2.0
    global_line_cost: float = 8.0     # HBM/L2 per coalesced line
    local_line_cost: float = 2.0      # per-core local memory (shared)
    barrier_cost: float = 2.0
    divmgmt_cost: float = 1.0         # vx_split/join/pred/tmc
    atomic_serial_cost: float = 4.0   # per-lane RMW serialization
    shared_in_local: bool = True      # Case Study 2 mapping choice

    def cycles(self, st: ExecStats) -> float:
        c = 0.0
        for op, n in st.by_op.items():
            if op in _MEM:
                c += self.mem_issue * n
            elif op in _SFU:
                c += self.sfu_cost * n
            elif op in ("vx_split", "vx_join", "vx_pred", "tmc_save",
                        "tmc_restore"):
                c += self.divmgmt_cost * n
            elif op == "vx_barrier":
                c += self.barrier_cost * n
            else:
                c += self.alu_cost * n
        c += self.global_line_cost * st.mem_requests
        c += self.atomic_serial_cost * st.atomic_serial
        shared_line = (self.local_line_cost if self.shared_in_local
                       else self.global_line_cost)
        c += shared_line * st.shared_requests
        return c
