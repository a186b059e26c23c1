"""Quickstart on the PyTorch port: compile an OpenCL-style kernel with
VOLT, inspect the divergence-managed IR and the Vortex assembly, and run
it on the SIMT interpreter and on the torch backend (``compile_torch``),
on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import interp
from repro_torch.core.backends.asm import emit_asm
from repro_torch.core.backends.torch_backend import compile_torch
from repro_torch.core.frontends import opencl
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline
from repro_torch.device import resolve_device


@opencl.kernel
def smooth(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)  # noqa: F821
    if gid < n:
        acc = x[gid]
        w = 1.0
        if gid > 0:
            acc += x[gid - 1]
            w += 1.0
        if gid < n - 1:
            acc += x[gid + 1]
            w += 1.0
        y[gid] = acc / w


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. front-end + middle-end (uniformity, structurize, Algorithm 2)
    module = smooth.build(None)
    compiled = run_pipeline(module, "smooth",
                            PassConfig(uni_hw=True, uni_ann=True))
    print("=== divergence-managed VIR ===")
    print(compiled.fn.dump())
    print("\n=== Vortex-flavored assembly ===")
    print(emit_asm(compiled.fn))

    # 2. execute on the warp interpreter (SimX stand-in)
    rng = np.random.default_rng(0)
    n = 120
    x = rng.standard_normal(128).astype(np.float32)
    bufs = {"x": x.copy(), "y": np.zeros(128, np.float32)}
    params = interp.LaunchParams(grid=4, local_size=32)
    stats = interp.launch(compiled.fn, bufs, params, scalar_args={"n": n})
    print(f"\ninterpreter: {stats.instrs} warp-instructions, "
          f"{stats.mem_requests} memory line requests, "
          f"IPDOM depth {stats.max_ipdom_depth}")

    # 3. the same kernel lowered to masked lane-vector torch, on dev
    tk = compile_torch(compiled.fn, params, module, device=dev)
    out = tk.fn({"x": torch.from_numpy(x).to(dev),
                 "y": torch.zeros(128, dtype=torch.float32, device=dev)},
                {"n": np.int32(n)})
    assert np.allclose(out["y"].cpu().numpy(), bufs["y"], atol=1e-5)
    print(f"torch backend on {dev.type} matches the interpreter: OK")


if __name__ == "__main__":
    main()
