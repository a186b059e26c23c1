"""Decode-time memory facts.

The port keeps only ``AffineFact`` from the reference's coalescing engine:
``passes.analysis.affine_mem_facts`` produces it, and the counting kernels
that consume it belong to the numpy executors, which are not ported.
"""
from __future__ import annotations


class AffineFact:
    """What the decoder proved about one memory access's index vector.

    ``kind``:
      * "uni"  — identical for every lane of a row (count = active rows);
      * "inc"  — affine in the lane id with stride > 0 (monotone
        nondecreasing keys per row);
      * "dec"  — stride < 0 (monotone nonincreasing).

    ``layout``   — the chain uses ``global_id(0)``/``local_id(0)``/
                   ``global_id(1)``/``local_id(1)``: only lane-affine /
                   row-uniform when ``local_size % warp_size == 0``
                   (checked per launch via ``_WarpCtx.affine_ok``).
    ``span_mul`` / ``span_add`` — |stride| and the summed |const addend|
                   of the chain; the monotone claim additionally needs
                   ``span_mul * launch_index_span + span_add`` to fit in
                   int32 (int32 wraparound would break monotonicity).
                   Chains containing runtime scalar params never get an
                   "inc"/"dec" fact (their addend is unbounded); they
                   may still be "uni" (a uniform wraps to a uniform).
    """
    __slots__ = ("kind", "layout", "span_mul", "span_add")

    def __init__(self, kind: str, layout: bool, span_mul: int = 0,
                 span_add: int = 0) -> None:
        self.kind = kind
        self.layout = layout
        self.span_mul = span_mul
        self.span_add = span_add

    def ok(self, ctx) -> bool:
        """Is the fact valid under this launch's thread layout?"""
        if self.layout and not ctx.affine_ok:
            return False
        if self.kind == "uni":
            return True
        return self.span_mul * ctx.affine_span + self.span_add < 2**31 - 1

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"AffineFact({self.kind!r}, layout={self.layout}, "
                f"mul={self.span_mul}, add={self.span_add})")
