"""Compare baseline vs variant dry-run records for the hillclimb cells
and print markdown rows (terms in seconds, deltas); port of
``repro.launch.perf_table`` on the port's roofline. The reference's
variants whose knob the port does not read (``launch/dryrun.py:DROPPED``)
are left out of its cells.

Usage: python -m repro_torch.launch.perf_table [ARTIFACTS [MESH]]
"""
import json
import sys
from pathlib import Path

from ..configs import get_config
from .roofline import analyze

CELLS = [
    ("llama3-405b", "prefill_32k", [""]),
    ("xlstm-1.3b", "train_4k", ["", "xlstm_chunk64", "xlstm_chunk512"]),
    ("jamba-1.5-large-398b", "train_4k", ["", "seqpar", "seqpar+moe_cap1"]),
    ("llama3-405b", "train_4k", ["", "seqpar"]),
]


def main(art="artifacts/dryrun", mesh="pod"):
    art = Path(art)
    for arch, shape, variants in CELLS:
        print(f"\n#### {arch} x {shape} ({mesh})\n")
        print("| variant | compute s | memory s | collective s | dominant "
              "| vs baseline (dominant term) |")
        print("|---|---|---|---|---|---|")
        base_row = None
        for v in variants:
            name = f"{arch}__{shape}__{mesh}" + (f"__{v}" if v else "")
            f = art / f"{name}.json"
            if not f.exists():
                print(f"| {v or 'baseline'} | - | - | - | MISSING | - |")
                continue
            rec = json.loads(f.read_text())
            row = analyze(rec, get_config(arch))
            if row is None:
                print(f"| {v or 'baseline'} | - | - | - | "
                      f"{rec.get('status')} | - |")
                continue
            if base_row is None:
                base_row = row
                delta = "1.00x (baseline)"
            else:
                b = getattr(base_row, f"{base_row.dominant}_s")
                a = getattr(row, f"{base_row.dominant}_s")
                delta = f"{b / a:.2f}x better" if a < b else \
                    f"{a / b:.2f}x WORSE"
            print(f"| {v or 'baseline'} | {row.compute_s:.3e} | "
                  f"{row.memory_s:.3e} | {row.collective_s:.3e} | "
                  f"{row.dominant} | {delta} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
