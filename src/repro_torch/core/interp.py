"""Launch geometry of a VOLT kernel.

The port keeps only ``LaunchParams`` from the reference's interpreter
module: the numpy executors are not ported, so the tests that need an
oracle call the reference's ``interp.launch`` directly.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LaunchParams:
    grid: int = 1                 # workgroups (x)
    local_size: int = 32          # threads per workgroup (x)
    warp_size: int = 32
    grid_y: int = 1
    local_size_y: int = 1
    fuel: int = 20_000_000
    # GPU semantics: out-of-bounds LOADS read garbage without trapping
    # (which is what makes CMOV speculation legal on real hardware);
    # set strict_oob_loads for debugging kernels.
    strict_oob_loads: bool = False

    @property
    def wg_threads(self) -> int:
        return self.local_size * self.local_size_y

    @property
    def warps_per_wg(self) -> int:
        return max(1, (self.wg_threads + self.warp_size - 1) // self.warp_size)
