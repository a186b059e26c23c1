"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and prints the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. Its
files, each found by name under the benchmark's folder:

  * ``configs/<config>.json``: the model as it is run (published keys, the
    keys changed from the source under ``reduced``, the port's config
    module under ``port``);
  * ``traffic/<traffic>.json``: the mix's parameters, and under ``driver``
    the loop that serves it, ``drivers/<driver>.py``;
  * ``checks/<workload>.json``: the limits of the numbers that decide
    ``correct``, each with the readings it was set from;
  * ``metrics/<metric>.py``: one reader a metric, ``read(run)`` -> a number
    or None (nothing to read), and the spans it needs under ``SPANS``.

A driver module has ``setup(run)``, ``window(run)``, ``release(run)`` and
``judge(run)``; the harness calls them in that order. ``release`` frees the
program's state once the window has closed and the peak memory has been
read, so that the plain reference runs in the memory it leaves. ``judge``
returns the readings of what the timed path produced against the plain
reference; those that the checks file names are compared with their
limits, and decide ``correct``; the others are printed as readings.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class HarnessError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, a module
    of the JAX package loaded); the run prints no result line."""


# --------------------------------------------------------------------------
# files found by name
# --------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise HarnessError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def find_cell(manifest: dict, workload: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == workload:
            return cell
    raise HarnessError(f"no workload {workload!r} in BENCHMARK.json")


def find_config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise HarnessError(f"no configuration {name!r} in BENCHMARK.json")


def bench_dir(root: Path, manifest: dict) -> Path:
    """The folder of the benchmark's own files: the first of ``paths``."""
    return Path(root) / manifest["paths"][0]


def load_module(path: Path, name: Optional[str] = None):
    """A module loaded from its file (a metric's file name holds dots)."""
    if not path.exists():
        raise HarnessError(f"missing {path}")
    name = name or "bench_file_" + "".join(
        ch if ch.isalnum() else "_" for ch in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports. An
    entry with ``workloads`` lists its cells; an end-to-end one without
    it is every cell's; a per-layer one without it is that of every cell
    that reports the end-to-end metric it ``moves``."""
    e2e = [m["name"] for m in cell_metrics(manifest, workload, "end_to_end")
           ] if kind == "per_layer" else None
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


@dataclass
class CellFiles:
    config: dict
    traffic: dict
    checks: dict
    driver: Any
    metrics: Dict[str, Any]          # name -> reader module
    units: Dict[str, str]


def cell_files(root: Path, manifest: dict, workload: str, trace: bool
               ) -> CellFiles:
    cell = find_cell(manifest, workload)
    bdir = bench_dir(root, manifest)
    entry = find_config(manifest, cell["config"])
    config = load_json(Path(root) / entry["file"])
    traffic = load_json(bdir / "traffic" / f"{cell['traffic']}.json")
    checks = load_json(bdir / "checks" / f"{workload}.json")
    driver = load_module(bdir / "drivers" / f"{traffic['driver']}.py")
    kind = "per_layer" if trace else "end_to_end"
    ms = cell_metrics(manifest, workload, kind)
    metrics = {m["name"]: load_module(bdir / "metrics" / f"{m['name']}.py")
               for m in ms}
    return CellFiles(config, traffic, checks, driver, metrics,
                     {m["name"]: m["unit"] for m in ms})


# --------------------------------------------------------------------------
# seeds and the configuration as the port takes it
# --------------------------------------------------------------------------

def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run (weights, tokens, the
    sample), the same for the same ``--seed``; any whole number."""
    words = [int(seed) & (2**64 - 1), int(seed) < 0, *tags]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) & (2**63 - 1)


#: the configuration file's keys -> the port's ``ModelConfig`` fields
PORT_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
             "vocab_size": "vocab", "rope_theta": "rope_theta",
             "tie_word_embeddings": "tie_embeddings",
             "num_experts": "moe_experts",
             "num_experts_per_tok": "moe_top_k",
             "capacity_factor": "moe_capacity"}


def port_config(config: dict):
    """The port's ``ModelConfig`` for the configuration file: the port's
    config module named under ``port``, with every size the file states."""
    import dataclasses
    mod = importlib.import_module(config["port"])
    fields = {PORT_KEYS[k]: v for k, v in config.items() if k in PORT_KEYS}
    if config.get("num_experts"):
        fields["moe_d_ff"] = config["intermediate_size"]
    fields["d_ff"] = config["intermediate_size"]
    fields["vocab_pad_multiple"] = config["assumed"]["vocab_pad_multiple"]
    return dataclasses.replace(mod.CONFIG, **fields)


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

@dataclass
class Run:
    """What the harness hands a driver and the metric readers."""

    root: Path
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    files: CellFiles
    t_start: float
    spans: Any = None                  # spans.Spans where tracing
    summary: Any = None                # trace.Summary, the spans phase
    device_summary: Any = None         # trace.Summary, the device phase
    state: Dict[str, Any] = field(default_factory=dict)
    record: Dict[str, Any] = field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.files.config

    @property
    def traffic(self) -> dict:
        return self.files.traffic

    def span(self, name: str):
        """A range of the benchmark's own around a call it makes (none
        where the run does not trace)."""
        return nullcontext() if self.spans is None else self.spans.range(name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def check(self, name: str, value: float) -> None:
        """One number that decides ``correct``, beside its limit from the
        cell's checks file: it passes where it is at most the limit. A
        number that is not finite reads as 1e30, past every limit."""
        limit = float(self.files.checks[name]["limit"])
        value = float(value)
        if value != value or value in (float("inf"), float("-inf")):
            value = 1e30
        self.checks[name] = {"value": value, "limit": limit}


def note(text: str) -> None:
    """A line of the run's own on standard error (the checks come last)."""
    print(f"bench: {text}", file=sys.stderr, flush=True)


def span_targets(files: CellFiles) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for mod in files.metrics.values():
        for span, targets in getattr(mod, "SPANS", {}).items():
            out.setdefault(span, [])
            out[span] += [t for t in targets if t not in out[span]]
    return out


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else None


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: Optional[float] = None
             ) -> dict:
    """One run of a cell -> its result line as a dict. ``device`` "cpu" is
    for the tests at a small size; a run of the benchmark takes the card."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest(root)
    cell = find_cell(manifest, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise HarnessError("no CUDA device: the benchmark runs on the "
                               "card and never falls back to the host")
        if torch.cuda.device_count() < cell["chips"]:
            raise HarnessError(f"{workload} needs {cell['chips']} cards; "
                               f"{torch.cuda.device_count()} found")
    files = cell_files(root, manifest, workload, trace)
    run = Run(Path(root), workload, int(seed), float(seconds), bool(trace),
              dev, files, t_start)
    if trace:
        from bench.spans import Spans
        run.spans = Spans()
        for span, targets in span_targets(files).items():
            for t in targets:
                run.spans.wrap(span, t)
    try:
        files.driver.setup(run)
        files.driver.window(run)
    finally:
        if run.spans is not None:
            run.spans.undo()
    run.sync()
    peak = (max(torch.cuda.max_memory_allocated(dev),
                run.record.get("peak_before_stretch", 0))
            if dev.type == "cuda" else 0)
    note(f"window_s {run.record.get('window_s')!r} attempted "
         f"{run.record.get('attempted')} memory_peak_bytes {peak}")
    files.driver.release(run)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = files.driver.judge(run)
    note(f"reference_s {time.perf_counter() - t_judge!r}")
    for name, value in numbers.items():
        if name not in files.checks:
            note(f"reading {name} {value!r} (not compared)")
    for name in files.checks:   # a number the driver did not read fails
        run.check(name, numbers.get(name, float("inf")))
    found = forbidden_modules()
    if found:
        raise HarnessError("modules of JAX or the JAX package were loaded: "
                           + ", ".join(found))
    metrics = {}
    for name, mod in files.metrics.items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": files.units[name]}
    correct = bool(run.checks) and all(
        c["value"] <= c["limit"] for c in run.checks.values())
    device_rec: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell["chips"] if dev.type == "cuda" else 0,
        "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_rec["power_limit"] = power_limit()
    out: Dict[str, Any] = {"correct": correct,
                           "attempted": int(run.record.get("attempted", 0)),
                           "failed": int(run.record.get("failed", 0)),
                           "metrics": metrics, "device": device_rec}
    if trace and run.summary is not None:
        note(f"trace: {run.summary.n_device_events} device events in the "
             f"spans stretch, {100 * run.summary.launches_found:.1f} % with "
             "their launch found")
    if trace and run.device_summary is not None:
        device_rec["busy_s"] = run.device_summary.busy_s
        device_rec["window_s"] = run.device_summary.window_s
        out["breakdown"] = {
            "device_ops": run.device_summary.breakdown()["device_ops"],
            "idle_gaps": (run.summary.breakdown()["idle_gaps"]
                          if run.summary is not None else [])}
    out["checks"] = run.checks
    return out


def print_result(out: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
