"""A cell, a mix and a metric added as new files are found by name,
without an edit of any file the benchmark had."""
from __future__ import annotations

import hashlib
import json
import sys

from bench import harness
from bench.tests.helpers import tiny_root


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()}


def test_throwaway_cell_needs_no_edit(tmp_path, monkeypatch):
    for m in harness.forbidden_modules():
        monkeypatch.delitem(sys.modules, m)
    root = tiny_root(tmp_path)
    before = _digests(root)
    b = root / "bench"
    mix = json.loads((b / "traffic" / "prefill-tiny.json").read_text())
    mix.update(seq_lens=[32, 64], shares=[0.5, 0.5], cycle=4,
               sample_batches=2, sample_of=4)
    (b / "traffic" / "prefill-two.json").write_text(json.dumps(mix))
    (b / "checks" / "tiny-dense.prefill-two.json").write_text(json.dumps(
        {"logit_err_mean": {"limit": 0.04},
         "batch_err_q75_max": {"limit": 0.06}}))
    (b / "metrics" / "batches_seen.prefill.py").write_text(
        "def read(run):\n    return run.record.get('attempted')\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny-dense.prefill-two",
                                  "config": "tiny-dense",
                                  "traffic": "prefill-two", "chips": 1,
                                  "why": "test"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and m["name"].startswith("prefill"):
            m["workloads"].append("tiny-dense.prefill-two")
    manifest["end_to_end"].append({
        "name": "batches_seen.prefill", "unit": "batches",
        "better": "higher", "bound": 0.25, "source": "host_clock",
        "workloads": ["tiny-dense.prefill-two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = harness.run_cell(root, "tiny-dense.prefill-two", 11, 0.1, False,
                           "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["batches_seen.prefill"]["value"] == \
        out["attempted"] >= 2
    assert {"prefill_tokens_per_s", "prefill_ms_p95", "setup_s"} <= \
        set(out["metrics"])
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_a_per_layer_metric_without_workloads_follows_what_it_moves():
    manifest = {
        "end_to_end": [{"name": "rate", "workloads": ["a"]},
                       {"name": "setup_s"}],
        "per_layer": [{"name": "share", "moves": "rate"},
                      {"name": "warm", "moves": "setup_s"},
                      {"name": "listed", "moves": "rate",
                       "workloads": ["b"]}]}
    names = lambda cell: [m["name"] for m in harness.cell_metrics(  # noqa
        manifest, cell, "per_layer")]
    assert names("a") == ["share", "warm"]
    assert names("b") == ["warm", "listed"]
