"""The program's own spans and counters in a traced run.

The port records ranges ``repro_torch.<span>`` and counters of its own
while its tracing is on (``repro_torch.tracing``). The readers of the
metrics that need them call ``install()``, which adds to the traced
stretches of ``bench/trace.py`` without changing what they measure:

  * the spans stretch turns the program's tracing on and resets its
    counters on entering (those of set-up, the kernel builds and loads
    among them, kept first under ``run.record["setup_counters"]``); on
    leaving it turns tracing off and keeps the counters under
    ``run.record["counters"]``. The device stretch leaves tracing off;
  * ``trace.reduce_events`` also gives ``summary.program``, a
    ``Program`` (``reduce_program``) of the events of the window, and
    names the innermost program range in each idle gap's label:
    ``<bench range> > <program range>: <op>``;
  * notes on standard error: each span's device time, its top
    operations, the shares of a step and a batch that its spans cover,
    the counters, and the builds and loads of set-up.

Where ``repro_torch.tracing`` cannot be imported (a program without
spans of its own) or the trace holds no program range, every field
``bench/trace.py`` computes is what it was and the readers find nothing.

A device event's launch (found by its correlation id) puts it down to
the spans of its instance, each in one of three ways:

  * **forward**: the ranges open at its launch on the thread that
    launched it, and, where that thread is not the one running the step
    or batch (the thread holding ``train.step`` or ``lm.prefill``:
    autograd's device thread while the step waits in the backward), the
    ranges open on that thread at the same time;
  * **recompute**: where the launching thread's ranges include an
    ``lm.period`` that lies inside a ``train.backward`` range, the
    rerun of a period by remat: its ranges take the event as recompute,
    not forward;
  * **backward**: an event launched inside an
    ``autograd::engine::evaluate_function`` range, not a recompute,
    belongs to the backward of every span whose forward instance ran
    the op of that function's sequence number (keyed with its forward
    thread).
"""
from __future__ import annotations

import importlib
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from bench import trace as T

PREFIX = "repro_torch."
#: spans that mark the thread running a training step or a prefill batch
MAIN = ("train.step", "lm.prefill")
#: the span that remat reruns, and the span inside which it does
RECOMPUTED, BACKWARD = "lm.period", "train.backward"
EVALUATE = "autograd::engine::evaluate_function: "
#: operations in each note
TOP = 3


@dataclass
class Program:
    """Device time by program span, in µs of device events."""

    forward: Dict[str, float]
    backward: Dict[str, float]
    recompute: Dict[str, float]
    #: span -> [(gpu start µs, gpu end µs, device µs)] a forward instance
    instances: Dict[str, List[Tuple[float, float, float]]]
    n_recompute: Dict[str, int]
    #: span -> "forward", "backward" or "recompute" -> operation -> µs
    ops: Dict[str, Dict[str, Dict[str, float]]]
    #: what the program's spans cover, (covered µs, whole µs)
    coverage: Dict[str, Tuple[float, float]]
    busy: List[Tuple[float, float]] = field(default_factory=list)

    def count(self, span: str) -> int:
        return len(self.instances.get(span, ()))

    def device_s(self, span: str) -> float:
        return self.forward.get(span, 0.0) / 1e6

    def recompute_s(self, span: str) -> float:
        return self.recompute.get(span, 0.0) / 1e6

    def busy_s_in(self, span: str) -> float:
        """The device's busy time between each forward instance's first
        and last event, summed."""
        out = 0.0
        for s, e, _ in self.instances.get(span, ()):
            out += sum(max(0.0, min(e, b1) - max(s, b0))
                       for b0, b1 in self.busy if b1 > s and b0 < e)
        return out / 1e6


def _window(events: List[dict]):
    for e in events:
        if e.get("name") == T.WINDOW and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]
    return None


def _span(r) -> Tuple[float, float, str]:
    return float(r["ts"]), float(r["ts"]) + float(r["dur"]), r["name"]


def _open(points: List[Tuple[float, int]], ranges: list) -> Dict[int, list]:
    return T._enclosing(points, ranges) if ranges and points else {}


def reduce_program(events: List[dict]) -> Optional[Program]:
    """The ``Program`` of a Chrome trace of the spans stretch; None where
    it holds no program range (the module's docstring)."""
    win = _window(events)
    if win is None:
        return None
    w0, w1, _ = win
    ranges: Dict[object, list] = defaultdict(list)     # tid -> program
    evals: Dict[object, list] = defaultdict(list)      # tid -> evaluate
    fwd_ops: Dict[object, list] = defaultdict(list)    # tid -> (ts, seq)
    launches: Dict[object, Tuple[object, float]] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args", {})
        if cat in T.DEVICE_CATS:
            s = float(e["ts"])
            if s < w1 and s + float(e["dur"]) > w0:
                device.append(e)
        elif cat in T.LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (e["tid"], float(e["ts"]))
        elif cat in ("user_annotation", "cpu_op") and name.startswith(PREFIX):
            s, t, n = _span(e)
            ranges[e["tid"]].append((s, t, n[len(PREFIX):]))
        elif cat == "cpu_op" and "Sequence number" in args:
            if name.startswith(EVALUATE):
                s, t, _ = _span(e)
                evals[e["tid"]].append((s, t, len(evals[e["tid"]]),
                                        args["Sequence number"],
                                        args.get("Fwd thread id")))
            elif not args.get("Fwd thread id"):
                fwd_ops[e["tid"]].append((float(e["ts"]),
                                          args["Sequence number"]))
    if not ranges:
        return None
    # remat's reruns: lm.period ranges inside a train.backward range
    backs = [r for rs in ranges.values() for r in rs if r[2] == BACKWARD]
    rerun = {tid: [r for r in rs if r[2] == RECOMPUTED and any(
        b[0] <= r[0] and r[1] <= b[1] for b in backs)]
        for tid, rs in ranges.items()}
    # the ranges of remat's reruns: each rerun and the ranges inside it
    rec_keys = {(tid,) + r for tid, rs in ranges.items() for r in rs
                if any(p[0] <= r[0] and r[1] <= p[1] for p in rerun[tid])}

    # each forward op's instances, by (thread, sequence number)
    of_seq: Dict[Tuple[object, int], Set[tuple]] = defaultdict(set)
    for tid, ops in fwd_ops.items():
        opened = _open([(ts, i) for i, (ts, _) in enumerate(ops)],
                       ranges.get(tid, []))
        for i, rs in opened.items():
            of_seq[(tid, ops[i][1])].update(
                k for k in ((tid,) + r for r in rs) if k not in rec_keys)
    # a backward function's forward thread (its own numbering) -> the
    # trace's thread holding most of its sequence numbers
    votes: Dict[Tuple[object, object], int] = defaultdict(int)
    for rs in evals.values():
        for _, _, _, seq, fid in rs:
            for tid in fwd_ops:
                if (tid, seq) in of_seq:
                    votes[(fid, tid)] += 1
    thread_of: Dict[object, object] = {}
    for (fid, tid), n in sorted(votes.items(), key=lambda kv: kv[1]):
        thread_of[fid] = tid
    mains = [tid for tid, rs in ranges.items()
             if any(r[2] in MAIN for r in rs)]
    # each event's launch -> open program ranges and evaluate function
    by_tid: Dict[object, list] = defaultdict(list)
    for i, e in enumerate(device):
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            by_tid[launches[corr][0]].append((launches[corr][1], i))
    own: Dict[int, list] = {}
    inherited: Dict[int, list] = defaultdict(list)
    in_eval: Dict[int, tuple] = {}
    for tid, pts in by_tid.items():
        for i, rs in _open(pts, ranges.get(tid, [])).items():
            own[i] = [(tid,) + r for r in rs]
        for i, rs in _open(pts, evals.get(tid, [])).items():
            in_eval[i] = max(rs)
        if tid in mains:
            continue
        for d in mains:
            for i, rs in _open(pts, ranges[d]).items():
                inherited[i] += [(d,) + r for r in rs]
    fwd: Dict[str, float] = defaultdict(float)
    bwd: Dict[str, float] = defaultdict(float)
    rec: Dict[str, float] = defaultdict(float)
    ops: Dict[str, Dict[str, Dict[str, float]]] = defaultdict(
        lambda: defaultdict(lambda: defaultdict(float)))
    inst: Dict[tuple, List[float]] = {}
    rec_inst: Dict[str, Set[tuple]] = defaultdict(set)
    cover: Dict[str, List[float]] = {k: [0.0, 0.0] for k in (
        "train.step", "train.backward", "lm.prefill")}
    for i, e in enumerate(device):
        s, d = float(e["ts"]), float(e["dur"])
        op = e["name"][:160]
        names_f: Set[str] = set()
        names_r: Set[str] = set()
        names_b: Set[str] = set()
        for key in own.get(i, []) + inherited.get(i, []):
            name = key[3]
            if key in rec_keys:
                names_r.add(name)
                rec_inst[name].add(key)
                continue
            names_f.add(name)
            a = inst.setdefault(key, [s, s + d, 0.0])
            a[0], a[1], a[2] = min(a[0], s), max(a[1], s + d), a[2] + d
        if i in in_eval and not names_r:
            _, _, _, seq, fid = in_eval[i]
            for key in of_seq.get((thread_of.get(fid), seq), ()):
                names_b.add(key[3])
        for kind, names, into in (("forward", names_f, fwd),
                                  ("recompute", names_r, rec),
                                  ("backward", names_b, bwd)):
            for name in names:
                into[name] += d
                ops[name][kind][op] += d
        below = {n for n in names_f | names_r | names_b
                 if not n.startswith("train.")}
        for whole, hit in (
                ("train.step", names_f & {"train.forward", "train.backward",
                                          "train.optimizer"}),
                ("train.backward", names_r | (names_b & below)),
                ("lm.prefill", (names_f & below) - {"lm.prefill"})):
            if whole in names_f:
                cover[whole][1] += d
                cover[whole][0] += d if hit else 0.0
    instances: Dict[str, list] = defaultdict(list)
    for key, (s, e, d) in sorted(inst.items(), key=lambda kv: kv[1][0]):
        instances[key[3]].append((s, e, d))
    busy = T._union([(max(w0, float(e["ts"])),
                      min(w1, float(e["ts"]) + float(e["dur"])))
                     for e in device])
    return Program(dict(fwd), dict(bwd), dict(rec), dict(instances),
                   {k: len(v) for k, v in rec_inst.items()},
                   {k: {kind: dict(o) for kind, o in v.items()}
                    for k, v in ops.items()},
                   {k: (v[0], v[1]) for k, v in cover.items() if v[1] > 0},
                   busy)


def program_gaps(events: List[dict], busy: List[Tuple[float, float]]
                 ) -> Dict[str, float]:
    """The idle gaps of ``trace.reduce_events``, each label also naming
    the innermost program range on the window's thread at the gap's
    start: ``<bench range> > <program range>: <op>`` (the bench range and
    the op as ``reduce_events`` finds them without the program's
    ranges)."""
    w0, w1, wtid = _window(events)
    host, prog = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("tid") != wtid or \
                e["name"] == T.WINDOW or e.get("cat") not in (
                    "cpu_op", "user_annotation", "cuda_runtime",
                    "cuda_driver"):
            continue
        (prog if e["name"].startswith(PREFIX) else host).append(_span(e))
    holes, prev = [], w0
    for s, e in busy:
        if s > prev:
            holes.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        holes.append((prev, w1))
    times = [h[0] for h in holes]
    in_span = T._innermost(times, [r for r in host
                                   if r[2].startswith(T.PREFIX)])
    in_prog = T._innermost(times, prog)
    in_op = T._innermost(times, host)
    gaps: Dict[str, float] = defaultdict(float)
    for (s, e), sp, pr, op in zip(holes, in_span, in_prog, in_op):
        where = (sp or "-") if pr is None else f"{sp or '-'} > {pr}"
        gaps[f"{where}: {op or 'host'}"[:160]] += e - s
    return dict(gaps)


def program(run) -> Optional[Program]:
    """The run's ``Program``, None where the trace had no program range."""
    return getattr(run.summary, "program", None)


def _tracing():
    try:
        return importlib.import_module("repro_torch.tracing")
    except ImportError:
        return None


def _reduce_events(events: List[dict]):
    summary = _REDUCE(events)
    summary.program = reduce_program(events)
    if summary.program is not None:
        summary.gaps = program_gaps(events, summary.busy)
    return summary


class _Stretch(T.Stretch):
    """``trace.Stretch`` with the program's tracing on in the spans
    stretch (the module's docstring)."""

    def __enter__(self):
        super().__enter__()
        self.tracing = _tracing() if self.phase == "spans" else None
        if self.tracing is not None:
            self.run.record.setdefault("setup_counters",
                                       self.tracing.counters())
            self.tracing.reset()
            self.tracing.enable(True)
        return self

    def __exit__(self, *exc):
        if self.tracing is not None:
            self.tracing.enable(False)
        out = super().__exit__(*exc)
        if self.tracing is not None and exc[0] is None:
            self.run.record["counters"] = self.tracing.counters()
            notes(self.run)
        return out


_REDUCE = T.reduce_events


def install() -> None:
    """Adds the program's spans and counters to ``bench/trace.py``'s
    stretches; once a process."""
    T.reduce_events = _reduce_events
    T.Stretch = _Stretch


def notes(run) -> None:
    """The program's spans, counters and set-up on standard error."""
    from bench.harness import note
    p = program(run)
    if p is not None:
        spans = sorted(set(p.forward) | set(p.recompute) | set(p.backward),
                       key=lambda k: -(p.forward.get(k, 0.0)
                                       + p.backward.get(k, 0.0)
                                       + p.recompute.get(k, 0.0)))
        for name in spans:
            n = max(1, p.count(name))
            merged: Dict[str, float] = defaultdict(float)
            for by_op in p.ops.get(name, {}).values():
                for op, us in by_op.items():
                    merged[op] += us
            top = sorted(merged.items(), key=lambda kv: -kv[1])
            note(f"program span {name}: {p.count(name)} instances, "
                 f"{p.n_recompute.get(name, 0)} recomputed; ms an instance "
                 f"forward {p.forward.get(name, 0.0) / 1e3 / n:.4f} "
                 f"backward {p.backward.get(name, 0.0) / 1e3 / n:.4f} "
                 f"recompute {p.recompute.get(name, 0.0) / 1e3 / n:.4f}; "
                 "top: " + ", ".join(f"{op} {us / 1e3:.3f} ms"
                                     for op, us in top[:TOP]))
        for whole, (hit, tot) in p.coverage.items():
            note(f"program spans cover {100 * hit / tot:.3f} % of "
                 f"{whole}'s device time ({hit / 1e3:.3f} of "
                 f"{tot / 1e3:.3f} ms)")
    note("program counters " + json.dumps(run.record.get("counters", {})))
    setup = run.record.get("setup_counters", {})
    note(f"program set-up: {setup.get('kernel.builds', 0)} kernel builds "
         f"in {setup.get('kernel.build_s', 0.0):.3f} s, "
         f"{setup.get('kernel.loads', 0)} libraries loaded from build/")
