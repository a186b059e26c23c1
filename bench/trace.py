"""The traced stretch of a run and its reduction to per-layer numbers.

A traced run profiles two short steady stretches of the window, one
after the other, each over the same number of batches or steps:

  * ``Stretch(run, "device")``: CUDA activity alone, so that the
    profiler adds no host time: the device's busy time (the union of its
    events), the traced window's length on the host clock, and the
    operations that took most time. ``run.device_summary``;
  * ``Stretch(run, "spans")``: CPU and CUDA activity inside a range
    ``bench.window``, with the spans recording their calls: the device
    time in each span and the idle gaps by what the host was doing, which
    the profiler's host time lengthens. ``run.summary``.

On exit the Chrome trace goes to a temporary file, is read and deleted,
and reduced to a ``Summary``. In the spans stretch:

  * a device event (kernel, memcpy, memset) belongs to every ``bench.*``
    range open on the thread that launched it when it was launched (the
    launch found by the trace's correlation id);
  * ``busy_s`` is the union of the device events inside the window,
    ``window_s`` the window's length on the host;
  * the breakdown's idle gaps are the holes of that union, each named by
    what the window's thread was doing at the gap's start: its innermost
    ``bench.*`` range and its innermost operation.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PREFIX = "bench."
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: entries of each breakdown list
TOP = 10


@dataclass
class Summary:
    busy_s: float
    window_s: float
    #: span -> [(gpu start µs, gpu end µs, device µs)] an instance
    instances: Dict[str, List[Tuple[float, float, float]]]
    ops: Dict[str, float]                             # kernel name -> µs
    gaps: Dict[str, float]                            # label -> µs
    launches_found: float                             # share of events
    n_device_events: int = 0
    #: the union of the device events inside the window, µs
    busy: List[Tuple[float, float]] = field(default_factory=list)

    def device_s(self, span: str) -> float:
        """Device time of the events launched inside the span."""
        return sum(i[2] for i in self.instances.get(span, ())) / 1e6

    def busy_s_in(self, span: str) -> float:
        """The device's busy time between each instance's first and last
        event, summed: the whole of a step whose backward runs on
        autograd's thread, outside the main thread's range."""
        out = 0.0
        for s, e, _ in self.instances.get(span, ()):
            out += sum(max(0.0, min(e, b1) - max(s, b0))
                       for b0, b1 in self.busy if b1 > s and b0 < e)
        return out / 1e6

    def count(self, span: str) -> int:
        return len(self.instances.get(span, ()))

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v / 1e6] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.ops), "idle_gaps": top(self.gaps)}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _enclosing(points: List[Tuple[float, int]],
               ranges: List[Tuple[float, float, str]]
               ) -> Dict[int, List[Tuple[float, float, str]]]:
    """For each point (time, id) on one thread, the ranges (start, end,
    name) open at its time (a sweep: ranges sorted by start)."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    out: Dict[int, List[str]] = {}
    active: List[Tuple[float, float, str]] = []
    j = 0
    for t, ident in sorted(points):
        while j < len(ranges) and starts[j] <= t:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r[1] >= t]
        if active:
            out[ident] = list(active)
    return out


def _innermost(times: List[float], intervals: List[Tuple[float, float, str]]
               ) -> List[Optional[str]]:
    """For each time (sorted), the name of the innermost interval that
    holds it, of properly nested intervals on one thread."""
    intervals = sorted(intervals, key=lambda r: (r[0], -r[1]))
    out: List[Optional[str]] = []
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for t in times:
        while j < len(intervals) and intervals[j][0] <= t:
            iv = intervals[j]
            while stack and stack[-1][1] <= iv[0]:
                stack.pop()
            stack.append(iv)
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_device(events: List[dict], window_s: float) -> Summary:
    """A ``Summary`` of a trace of CUDA activity alone over a window of
    ``window_s`` seconds on the host: every device event lies inside."""
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in device])
    ops: Dict[str, float] = defaultdict(float)
    for e in device:
        ops[e["name"][:160]] += float(e["dur"])
    return Summary(sum(e - s for s, e in busy) / 1e6, window_s, {},
                   dict(ops), {}, 1.0, len(device), busy)


def reduce_events(events: List[dict]) -> Summary:
    """A ``Summary`` of a Chrome trace's events of CPU and CUDA activity
    (see the module's docstring)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no bench.window range")
    w = win[0]
    w0, w1, wtid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w["tid"]
    launches: Dict[int, Tuple[object, float]] = {}
    ranges: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    host_ops: List[Tuple[float, float, str]] = []
    device: List[dict] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], float(e["ts"]))
        elif cat == "user_annotation" and e["name"].startswith(PREFIX) \
                and e["name"] != WINDOW:
            ranges[e["tid"]].append((float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"]),
                                     e["name"][len(PREFIX):]))
        if e.get("tid") == wtid and e["name"] != WINDOW and cat in (
                "cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host_ops.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"]))
    inside = [e for e in device
              if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    # each device event -> the spans open at its launch
    by_tid: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    found = 0
    for i, e in enumerate(inside):
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            tid, ts = launches[corr]
            by_tid[tid].append((ts, i))
            found += 1
    spans_of: Dict[int, List[Tuple[float, float, str]]] = {}
    for tid, pts in by_tid.items():
        spans_of.update(_enclosing(pts, ranges.get(tid, [])))
    # per span instance: collect the events of each range instance
    inst: Dict[Tuple[str, int], List[float]] = {}
    for i, open_ranges in spans_of.items():
        e = inside[i]
        s, d = float(e["ts"]), float(e["dur"])
        latest: Dict[str, float] = {}
        for r0, _, name in open_ranges:
            latest[name] = max(latest.get(name, r0), r0)
        # an instance is the latest-started range of its name open at the
        # launch; the events of one call share it
        for key in latest.items():
            a = inst.setdefault(key, [s, s + d, 0.0])
            a[0], a[1], a[2] = min(a[0], s), max(a[1], s + d), a[2] + d
    instances: Dict[str, List[Tuple[float, float, float]]] = defaultdict(list)
    for (name, _), (s, e, d) in sorted(inst.items(), key=lambda kv: kv[1][0]):
        instances[name].append((s, e, d))
    busy = _union([(max(w0, float(e["ts"])),
                    min(w1, float(e["ts"]) + float(e["dur"])))
                   for e in inside])
    busy_us = sum(e - s for s, e in busy)
    ops: Dict[str, float] = defaultdict(float)
    for e in inside:
        ops[e["name"][:160]] += float(e["dur"])
    holes = []
    prev = w0
    for s, e in busy:
        if s > prev:
            holes.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        holes.append((prev, w1))
    times = [h[0] for h in holes]
    spans_host = [r for r in host_ops if r[2].startswith(PREFIX)]
    in_span = _innermost(times, spans_host)
    in_op = _innermost(times, host_ops)
    gaps: Dict[str, float] = defaultdict(float)
    for (s, e), sp, op in zip(holes, in_span, in_op):
        label = f"{sp or '-'}: {op or 'host'}"
        gaps[label[:160]] += e - s
    return Summary(busy_us / 1e6, (w1 - w0) / 1e6,
                   dict(instances), dict(ops), dict(gaps),
                   found / len(inside) if inside else 0.0, len(inside), busy)


class Stretch:
    """``with Stretch(run, phase):`` around a traced part of a window;
    ``phase`` "device" or "spans" (the module's docstring)."""

    def __init__(self, run, phase: str) -> None:
        if phase not in ("device", "spans"):
            raise ValueError(phase)
        self.run, self.phase = run, phase

    def __enter__(self):
        import time
        import torch
        from torch.profiler import ProfilerActivity, profile
        run = self.run
        run.sync()
        if run.device.type == "cuda":
            run.record.setdefault("peak_before_stretch",
                                  torch.cuda.max_memory_allocated(run.device))
            torch.cuda.reset_peak_memory_stats(run.device)
        acts = [ProfilerActivity.CUDA] if run.device.type == "cuda" else []
        if self.phase == "spans" or not acts:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.window = None
        if self.phase == "spans":
            self.window = torch.profiler.record_function(WINDOW)
            self.window.__enter__()
            if run.spans is not None:
                run.spans.recording = True
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        import torch
        run = self.run
        run.sync()
        window_s = time.perf_counter() - self.t0
        if self.window is not None:
            if run.spans is not None:
                run.spans.recording = False
            self.window.__exit__(*exc)
        self.prof.__exit__(*exc)
        if run.device.type == "cuda":
            run.record["stretch_peak_bytes"] = max(
                run.record.get("stretch_peak_bytes", 0),
                torch.cuda.max_memory_allocated(run.device))
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        if self.phase == "spans":
            run.summary = reduce_events(events)
        else:
            run.device_summary = reduce_device(events, window_s)
        return False


class Phases:
    """The two stretches of a traced window over units (batches or steps)
    [start, start + n) and [start + n, start + 2n)."""

    def __init__(self, run, start: int, n: int) -> None:
        self.run, self.start, self.n = run, start, n
        self.open = None
        self.units = {"device": [], "spans": []}

    @property
    def done(self) -> bool:
        return not self.run.trace or (self.open is None and
                                      bool(self.units["spans"]))

    def phase(self, i: int):
        k = i - self.start
        if not self.run.trace or k < 0 or k >= 2 * self.n:
            return None
        return "device" if k < self.n else "spans"

    def before(self, i: int) -> None:
        ph = self.phase(i)
        if ph is not None and (i - self.start) % self.n == 0:
            self.open = Stretch(self.run, ph).__enter__()

    def after(self, i: int, unit) -> None:
        ph = self.phase(i)
        if ph is None:
            return
        self.units[ph].append(unit)
        if (i - self.start) % self.n == self.n - 1:
            self.open.__exit__(None, None, None)
            self.open = None
