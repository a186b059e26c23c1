"""A benchmark of small cells for the CPU tests: a copy of the benchmark's
folder in a temporary root, with small configurations and mixes from
``data/`` added as files, and a manifest of its own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"

#: limits of the small cells, set from their readings on the CPU (six
#: seeds of the program, three of the control: ``bench/control.py``'s
#: ``readings``), lower / fp8 control: dense prefill 0.0101 / 0.149
#: (mean row), 0.0096 / 0.136 (median row), 0.0135 / 0.185 (largest
#: batch upper quartile), 0.0109 / 0.264 (greedy gap); MoE prefill 0.056 / 0.220 (mean row), 0.0097 /
#: 0.173 (median row), its largest rows swing with routing flips and
#: have no upper reading; training 2.0e-4 / 2.4e-4, half the batch
#: 3.8e-3 (first loss), 3.3e-4 / 2.2e-3 (loss), 1.7e-3 / 6.2e-3 (first
#: gradient), 8.8e-4 / 3.1e-3 (change).
TINY_CHECKS = {
    "tiny-dense.prefill-tiny": {
        "logit_err_mean": {"limit": 0.04},
        "logit_err_median": {"limit": 0.04},
        "batch_err_q75_max": {"limit": 0.06},
        "greedy_gap_max": {"limit": 0.08}},
    "tiny-moe.prefill-tiny": {
        "logit_err_mean": {"limit": 0.12},
        "logit_err_median": {"limit": 0.06}},
    "tiny-dense.train-tiny": {
        "first_loss_gap": {"limit": 6e-4}, "loss_gap": {"limit": 1.2e-3},
        "grad_norm_gap": {"limit": 3.5e-3},
        "change_norm_gap": {"limit": 2e-3}},
}


def tiny_root(tmp: Path) -> Path:
    """A root holding the benchmark's folder and the small cells."""
    root = Path(tmp) / "root"
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for name in ("tiny-dense", "tiny-moe"):
        shutil.copy(DATA / f"{name}.json", root / "bench" / "configs")
    for name in ("prefill-tiny", "train-tiny"):
        shutil.copy(DATA / f"{name}.json", root / "bench" / "traffic")
    for cell, checks in TINY_CHECKS.items():
        (root / "bench" / "checks" / f"{cell}.json").write_text(
            json.dumps(checks))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] += [
        {"name": n, "source": "https://arxiv.org/abs/2409.02060",
         "file": f"bench/configs/{n}.json", "reduced": [], "why": "test"}
        for n in ("tiny-dense", "tiny-moe")]
    for cell in TINY_CHECKS:
        config, traffic = cell.split(".")
        manifest["workloads"].append({"name": cell, "config": config,
                                      "traffic": traffic, "chips": 1,
                                      "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            kind = "train" if m["name"].startswith("train") or \
                m["name"].endswith(".train") else "prefill"
            m["workloads"] += [c for c in TINY_CHECKS
                               if c.split(".")[1].startswith(kind)]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
