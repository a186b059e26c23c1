"""Paper-reproduction demo on the PyTorch port: the divergence-
optimization ablation on three benchmarks, printing the Fig 7/8-style
deltas, then saxpy through the port's simt_exec path
(``volt_torch_run``): the hand-written CUDA launch on the card, or its
plain torch version with ``--device cpu``.

    PYTHONPATH=src python examples/torch_volt_simt_demo.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import interp
from repro_torch.core.passes.pipeline import ABLATION_LADDER, run_pipeline
from repro_torch.core.simx import CycleModel
from repro_torch.device import resolve_device
from repro_torch.kernels.simt_exec.ops import volt_torch_run
from repro_torch.volt_bench import BENCHES


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    model = CycleModel()
    for name in ("srad_flag", "transpose", "pathfinder"):
        b = BENCHES[name]
        rng = np.random.default_rng(7)
        bufs0, scalars, params = b.make(rng)
        print(f"\n=== {name} ===")
        base = None
        for cfg in ABLATION_LADDER:
            mod = b.handle.build(None)
            ck = run_pipeline(mod, b.handle.name, cfg)
            bufs = {k: v.copy() for k, v in bufs0.items()}
            st = interp.launch(ck.fn, bufs, params, scalar_args=scalars)
            cyc = model.cycles(st)
            if base is None:
                base = (st.instrs, cyc)
            print(f"  {cfg.label:28s} instrs={st.instrs:6d} "
                  f"(x{base[0]/st.instrs:5.3f})  cycles={cyc:9.0f} "
                  f"(x{base[1]/cyc:5.3f})")

    # the simt_exec path: one grid program a workgroup, on dev
    sx = BENCHES["saxpy"]
    bufs0, scalars, params = sx.make(np.random.default_rng(3))
    out = volt_torch_run(sx.handle, bufs0, params,
                         {k: np.asarray(v) for k, v in scalars.items()},
                         device=dev)
    expect = sx.ref(bufs0, scalars)
    assert np.allclose(out["y"].cpu().numpy(), expect["y"], atol=1e-5)
    kind = "CUDA kernel" if dev.type == "cuda" else "plain torch version"
    print(f"\nsaxpy through simt_exec ({kind}, {dev.type}): OK")


if __name__ == "__main__":
    main()
