"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
from __future__ import annotations

import json
import re

import pytest

from bench import harness
from bench.tests.helpers import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|size|dim|"
                   r"rank|expansion|experts_per_tok|width)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_command_and_paths():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        assert any(w.startswith(p + "/") for p in MANIFEST["paths"])
    assert (ROOT / cmd[1]).exists()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_configs():
    assert 1 <= len(MANIFEST["configs"]) <= 24
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
            assert k in body["published"], k


def test_workloads_and_chips():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for w in cells:
        got = harness.cell_metrics(MANIFEST, w, "end_to_end")
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert harness.cell_metrics(MANIFEST, w, "per_layer")
        for m in harness.cell_metrics(MANIFEST, w, "per_layer"):
            assert m["moves"] in {x["name"] for x in got}
    # every cell that reports an mfu's end-to-end metric reports the mfu
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"]:
            assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                       for x in MANIFEST["per_layer"])


def test_run_seconds_fit_the_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_finds_its_files_by_name(cell, trace):
    files = harness.cell_files(ROOT, MANIFEST, cell, trace)
    assert files.traffic["driver"] in ("prefill", "train")
    for fn in ("setup", "window", "release", "judge"):
        assert callable(getattr(files.driver, fn))
    assert files.metrics and all(callable(m.read)
                                 for m in files.metrics.values())
    for name, c in files.checks.items():
        assert NAME.match(name) and float(c["limit"]) > 0


def test_file_names_under_paths():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
