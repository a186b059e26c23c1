"""Patch existing dry-run records with the depth-extrapolated costs (port
of ``repro.launch.recost``): the 1- and 2-period variants of each cell
traced on fake tensors (``dryrun._depth_extrapolate``), in a fake world
of the cell's mesh, written into its ``extrapolated``. The port's full
trace counts every period, so this reproduces it; it stays as the
reference's tool for records made without it.

Usage:
  python -m repro_torch.launch.recost --artifacts DIR [--force] [--glob G]
"""
import argparse
import json
import sys
import time
from pathlib import Path

from ..configs import get_config
from ..configs.base import SHAPES
from .dryrun import _depth_extrapolate, apply_variant
from .mesh import end_world, fake_world, mesh_from_spec, mesh_size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun")
    ap.add_argument("--only-missing", action="store_true", default=True)
    ap.add_argument("--force", dest="only_missing", action="store_false")
    ap.add_argument("--glob", default="*.json")
    args = ap.parse_args(argv)
    art = Path(args.artifacts)
    for f in sorted(art.glob(args.glob)):
        rec = json.loads(f.read_text())
        if rec.get("status") != "ok":
            continue
        if args.only_missing and isinstance(rec.get("extrapolated"), dict) \
                and "flops" in rec["extrapolated"]:
            continue
        cfg = apply_variant(get_config(rec["arch"]), rec.get("variant", ""))
        kind = SHAPES[rec["shape"]].kind
        t0 = time.time()
        fake_world(mesh_size(rec["mesh"]))
        try:
            mesh = mesh_from_spec(rec["mesh"], "cpu")
            ex = _depth_extrapolate(cfg, rec["shape"], mesh, kind)
        except Exception as e:
            ex = {"error": f"{type(e).__name__}: {e}"}
        finally:
            end_world()
        rec["extrapolated"] = ex
        f.write_text(json.dumps(rec, indent=1))
        print(f"[recost] {f.name}: {time.time()-t0:.0f}s "
              f"flops={ex.get('flops', 0):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
