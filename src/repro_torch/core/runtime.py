"""Host runtime (paper §4.2 host compilation flow + Case Study 2).

The front-end rewrites host-side API calls into operations against this
device runtime.  We expose both dialect flavors:

  OpenCL-ish:  create_buffer / enqueue_nd_range / read_buffer
  CUDA-ish:    cuda_malloc / cuda_memcpy / cuda_memcpy_to_symbol /
               cuda_launch_kernel

Case Study 2 — ``cudaMemcpyToSymbol``: CuPBoP maps CUDA constant memory to
Vortex global memory but lacks the host API, so constant initialization is
impossible.  VOLT buffers the host data and *materializes it just before
kernel launch*, after global addresses are resolved.  ``Runtime.launch``
below does exactly that (``_pending_symbols``).

Case Study 2 — shared-memory mapping: ``shared_in_local`` selects whether
__shared__ arrays map to per-core local memory or global memory; it flows
into the cycle model (simx.CycleModel) and reproduces the Fig 10 trade-off.

The grid computation in ``launch`` is the runtime half of ``vx_wspawn``:
a single control thread computes #warps/#cores from launch arguments, then
spawns the grid (here: schedules the torch rung on the device or the
interpreter's executors on the host).

This is a copy of the reference's module (``repro.core.runtime``).  What
differs: the top rung of the chain is the torch rung
(``core/backends/torchgen.py``), engaged by ``Runtime(torch=...)`` or
``VOLT_TORCH`` and run on ``Runtime(device=...)`` (``None``: the card);
its certification verdicts live in ``.vtc`` files; and every disk-cache
key carries the package's name and the default cache directory is
``~/.cache/volt_repro_torch``, so the port never reads an entry the
reference wrote (the two packages' compiler sources are byte-identical,
and a reference entry unpickles ``repro.*`` objects).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import re
import tempfile
import threading
from collections import Counter, deque
from dataclasses import dataclass, field
from pathlib import Path
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import faults as _faults
from . import governor as _gov
from . import interp as _interp
from . import parallel as _parallel
from .faults import DeadlineExceeded, EngineBusy, EngineFault, KernelFault
from .interp import ExecError, ExecStats, LaunchParams, \
    launch as interp_launch
from .passes.pipeline import CompiledKernel, PassConfig, run_pipeline
from .passes.uniformity import UniformityInfo
from .simx import CycleModel
from .vir import Function, Module, Op, Ty

_TY_DTYPE = {Ty.I32: np.int32, Ty.F32: np.float32, Ty.BOOL: np.bool_}


# --------------------------------------------------------------------------
# Compile cache: repeated launches of the same @kernel under the same
# PassConfig + warp configuration skip the front-end build AND the whole
# pass pipeline.  Two tiers:
#
#   * in-memory, keyed by (handle identity, PassConfig fields, warp size);
#     values keep a strong reference to the handle so its id() can never
#     be recycled;
#   * on disk, keyed by (CONTENT hash of the normalized pre-pipeline IR,
#     PassConfig fields, warp size, schema version) — a second process
#     compiling an identical kernel deserializes the compiled module
#     instead of re-running the pass pipeline.  Any change to the kernel
#     body changes the IR hash, so stale entries can never be returned;
#     unreadable/corrupt entries fall back to a fresh compile.
#
# Disk location: $VOLT_CACHE_DIR, else ~/.cache/volt_repro_torch.  Disable
# with VOLT_DISK_CACHE=0.  Every key carries _PACKAGE: a directory shared
# with the reference never serves one package's entry to the other.
# --------------------------------------------------------------------------

_COMPILE_CACHE: Dict[Tuple, Tuple[Any, CompiledKernel]] = {}

_DISK_CACHE_SCHEMA = 1
#: folded into every disk key: the port's compiler sources equal the
#: reference's byte for byte, so the fingerprints alone would collide
_PACKAGE = __name__.split(".")[0]
#: telemetry for benchmarks/tests: process-lifetime disk cache counters
#: (compile-cache hits/misses/errors + decode-plan-cache counterparts)
DISK_CACHE_STATS = {"hits": 0, "misses": 0, "errors": 0,
                    "decode_hits": 0, "decode_misses": 0,
                    "decode_errors": 0,
                    "cert_hits": 0, "cert_misses": 0, "cert_errors": 0}

_TOKEN_RE = re.compile(r"%[A-Za-z_][\w.]*")


def _normalize_ir(dump: str) -> str:
    """Rewrite process-dependent SSA/label tokens (%v123, %for.cond.17,
    %gid, ...) to dense first-appearance indices.  The renaming is
    INJECTIVE within one dump — distinct registers stay distinct — so
    operand swaps or retargeted branches still change the hash, while
    identical kernels built in fresh processes (different absolute id
    counters) normalize to the same text.  Float constants never follow
    a '%', so they survive untouched."""
    mapping: Dict[str, str] = {}

    def renum(m: "re.Match[str]") -> str:
        tok = m.group(0)
        new = mapping.get(tok)
        if new is None:
            new = f"%t{len(mapping)}"
            mapping[tok] = new
        return new

    return _TOKEN_RE.sub(renum, dump)


def _compiler_fingerprint() -> str:
    """Hash of the compiler's own source (passes + IR + front-ends):
    folded into every disk-cache key so editing the pipeline invalidates
    entries compiled by the old code."""
    global _COMPILER_FP
    if _COMPILER_FP is None:
        h = hashlib.sha256()
        root = Path(__file__).resolve().parent
        files = sorted((root / "passes").glob("*.py")) \
            + sorted((root / "frontends").glob("*.py")) \
            + [root / "vir.py", root / "graph.py"]
        for f in files:
            try:
                h.update(f.name.encode())
                h.update(f.read_bytes())
            except OSError:
                pass
        _COMPILER_FP = h.hexdigest()
    return _COMPILER_FP


_COMPILER_FP: Optional[str] = None


def disk_cache_dir() -> Optional[Path]:
    if os.environ.get("VOLT_DISK_CACHE", "1") == "0":
        return None
    d = os.environ.get("VOLT_CACHE_DIR")
    if d:
        return Path(d)
    return Path.home() / ".cache" / "volt_repro_torch"


def _disk_key(module: Module, kernel_name: str, config: PassConfig,
              warp_size: int) -> str:
    h = hashlib.sha256()
    h.update(repr((_DISK_CACHE_SCHEMA, _PACKAGE, _compiler_fingerprint(),
                   kernel_name, dataclasses.astuple(config),
                   warp_size)).encode())
    h.update(_normalize_ir(module.dump()).encode())
    return h.hexdigest()


def _freeze_info(module: Module, info: UniformityInfo) -> Tuple:
    """id()-keyed divergence sets -> object lists (ids do not survive
    pickling; the objects do, with referential integrity)."""
    id2obj: Dict[int, Any] = {}
    for fn in module.functions.values():
        for b in fn.blocks:
            id2obj[id(b)] = b
            for i in b.instrs:
                id2obj[id(i)] = i
                if i.result is not None:
                    id2obj[id(i.result)] = i.result
                for o in i.operands:
                    id2obj[id(o)] = o
        for s in fn.slots:
            id2obj[id(s)] = s
    return tuple([id2obj[x] for x in ids if x in id2obj] for ids in (
        info.divergent_values, info.divergent_slots,
        info.divergent_exec, info.divergent_branches))


def _thaw_info(frozen: Tuple) -> UniformityInfo:
    dv, ds, de, db = frozen
    return UniformityInfo({id(o) for o in dv}, {id(o) for o in ds},
                          {id(o) for o in de}, {id(o) for o in db})


def _atomic_write(path: Path, payload: bytes) -> None:
    """Crash-safe cache write, shared by the compile cache (.vck) and
    the decode-plan cache (.vdp): the payload lands in a same-directory
    tmp file, then ``os.replace`` commits it atomically — a crash (or
    an injected ``cache.commit`` fault) before the rename leaves only
    tmp debris, NEVER a truncated entry a concurrent reader could
    deserialize."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(payload)
    if _faults.ACTIVE:
        _faults.maybe_fault("cache.commit")
    os.replace(tmp, path)


def _disk_load(path: Path, kernel_name: str,
               config: PassConfig) -> Optional[CompiledKernel]:
    try:
        if _faults.ACTIVE:
            _faults.maybe_fault("cache.load")
        with open(path, "rb") as f:
            module, frozen, stats = pickle.load(f)
        return CompiledKernel(module, module.functions[kernel_name],
                              _thaw_info(frozen), config, stats)
    except Exception:
        DISK_CACHE_STATS["errors"] += 1
        try:
            path.unlink()
        except OSError:
            pass
        return None


def _disk_store(path: Path, ck: CompiledKernel) -> None:
    try:
        if _faults.ACTIVE:
            _faults.maybe_fault("cache.store")
        payload = pickle.dumps(
            (ck.module, _freeze_info(ck.module, ck.info), ck.stats))
        _atomic_write(path, payload)
    except Exception:              # cache write failure never fails a
        DISK_CACHE_STATS["errors"] += 1   # compile


def compile_kernel(kernel_handle, config: Optional[PassConfig] = None,
                   *, warp_size: int = 32, use_cache: bool = True,
                   use_disk_cache: Optional[bool] = None) -> CompiledKernel:
    """Build + run the pass pipeline for a front-end @kernel handle,
    memoized on (kernel, PassConfig, warp config) in memory and — keyed
    by IR content hash — on disk across processes."""
    config = config or PassConfig()
    key = (id(kernel_handle), kernel_handle.name,
           dataclasses.astuple(config), warp_size)
    if use_cache:
        hit = _COMPILE_CACHE.get(key)
        if hit is not None:
            return hit[1]
    module = kernel_handle.build(None)
    cache_dir = disk_cache_dir() if use_disk_cache in (None, True) else None
    if use_disk_cache is False:
        cache_dir = None
    path = None
    if cache_dir is not None:
        path = Path(cache_dir) / (_disk_key(module, kernel_handle.name,
                                            config, warp_size) + ".vck")
        if path.exists():
            ck = _disk_load(path, kernel_handle.name, config)
            if ck is not None:
                DISK_CACHE_STATS["hits"] += 1
                if use_cache:
                    _COMPILE_CACHE[key] = (kernel_handle, ck)
                return ck
        DISK_CACHE_STATS["misses"] += 1
    ck = run_pipeline(module, kernel_handle.name, config)
    if path is not None:
        _disk_store(path, ck)
    if use_cache:
        _COMPILE_CACHE[key] = (kernel_handle, ck)
    return ck


def clear_compile_cache(*, disk: bool = False) -> None:
    _COMPILE_CACHE.clear()
    if disk:
        d = disk_cache_dir()
        if d is not None and Path(d).exists():
            for p in list(Path(d).glob("*.vck")) \
                    + list(Path(d).glob("*.vdp")):
                try:
                    p.unlink()
                except OSError:
                    pass


# --------------------------------------------------------------------------
# Persistent decode-plan cache (the PR 3 follow-up): the interpreter's
# per-function decode ANALYSIS (affine index facts, store privacy,
# hazard/cyclic classification, callee purity — see interp._decode_plan)
# persists next to the compile cache, keyed by a content hash of the
# function plus its transitive callees and referenced globals.  The
# decoded handler tables themselves are closures and never persist —
# a second process still emits handlers, but skips every static scan.
# Stale entries are impossible (any IR edit changes the hash; the
# fingerprint below folds in the decoder's own source); corrupt entries
# are deleted and recomputed.  Shares $VOLT_CACHE_DIR / VOLT_DISK_CACHE
# with the compile cache; hit counts land in DISK_CACHE_STATS
# (decode_hits / decode_misses / decode_errors, reported by
# benchmarks/compile_time.py).
# --------------------------------------------------------------------------

_DECODE_PLAN_FP: Optional[str] = None


def _decode_plan_fingerprint() -> str:
    """Hash of the decoder's own source: editing the interpreter, the
    coalescing engine or the affine classifier invalidates plans
    computed by the old code."""
    global _DECODE_PLAN_FP
    if _DECODE_PLAN_FP is None:
        h = hashlib.sha256()
        root = Path(__file__).resolve().parent
        for f in (root / "interp.py", root / "interp_mem.py",
                  root / "vir.py", root / "passes" / "analysis.py"):
            try:
                h.update(f.name.encode())
                h.update(f.read_bytes())
            except OSError:
                pass
        _DECODE_PLAN_FP = h.hexdigest()
    return _DECODE_PLAN_FP


def _decode_plan_key(fn: Function) -> str:
    """Content hash of ``fn`` + transitive callees + referenced globals
    (name/space/size matter: __shared__-ness changes hazard rules)."""
    cached = getattr(fn, "_decode_plan_key", None)
    if cached is not None and cached[0] == fn.ir_version:
        return cached[1]
    h = hashlib.sha256()
    h.update(repr((_interp._DECODE_PLAN_SCHEMA, _PACKAGE,
                   _decode_plan_fingerprint())).encode())
    seen = set()
    work = [fn]
    gvars = []
    while work:
        f = work.pop(0)
        if id(f) in seen:
            continue
        seen.add(id(f))
        h.update(_normalize_ir(f.dump()).encode())
        for i in f.instructions():
            if i.op is Op.CALL:
                work.append(i.operands[0])
            for o in i.operands:
                if o.__class__.__name__ == "GlobalVar":
                    gvars.append((o.name, str(o.space), o.size,
                                  str(o.elem_ty)))
    h.update(repr(sorted(set(gvars))).encode())
    key = h.hexdigest()
    fn._decode_plan_key = (fn.ir_version, key)  # type: ignore
    return key


def _decode_plan_load(fn: Function) -> Optional[dict]:
    d = disk_cache_dir()
    if d is None:
        return None
    path = Path(d) / (_decode_plan_key(fn) + ".vdp")
    if not path.exists():
        DISK_CACHE_STATS["decode_misses"] += 1
        return None
    try:
        if _faults.ACTIVE:
            _faults.maybe_fault("plan.load")
        with open(path, "rb") as f:
            plan = pickle.load(f)
        if plan.get("schema") != _interp._DECODE_PLAN_SCHEMA:
            raise ValueError("decode plan schema mismatch")
        DISK_CACHE_STATS["decode_hits"] += 1
        return plan
    except Exception:
        DISK_CACHE_STATS["decode_errors"] += 1
        try:
            path.unlink()
        except OSError:
            pass
        return None


def _decode_plan_save(fn: Function, plan: dict) -> None:
    d = disk_cache_dir()
    if d is None:
        return
    try:
        if _faults.ACTIVE:
            _faults.maybe_fault("plan.store")
        path = Path(d) / (_decode_plan_key(fn) + ".vdp")
        _atomic_write(path, pickle.dumps(plan))
    except Exception:              # plan persistence is best-effort
        DISK_CACHE_STATS["decode_errors"] += 1


_interp.DECODE_PLAN_HOOKS = (_decode_plan_load, _decode_plan_save)

#: schema of the .vtc payload: {launch-shape-sig: (verdict, torch_ms,
#: grid_ms)}, verdict "pass" | "fail" (the torch rung has one tier)
_TORCH_CERT_SCHEMA = 1


def _torch_cert_load(fn: Function) -> Optional[dict]:
    """.vtc read: the torch rung's differential-certification verdicts,
    keyed by the same kernel content hash as the .vck/.vdp caches — an
    IR change invalidates every verdict with it."""
    d = disk_cache_dir()
    if d is None:
        return None
    path = Path(d) / (_decode_plan_key(fn) + ".vtc")
    if not path.exists():
        DISK_CACHE_STATS["cert_misses"] += 1
        return None
    try:
        with open(path, "rb") as f:
            rec = pickle.load(f)
        if rec.get("schema") != _TORCH_CERT_SCHEMA:
            raise ValueError("torch cert schema mismatch")
        certs = rec["certs"]
        if not isinstance(certs, dict):
            raise ValueError("torch cert payload is not a dict")
        DISK_CACHE_STATS["cert_hits"] += 1
        return certs
    except Exception:
        DISK_CACHE_STATS["cert_errors"] += 1
        try:
            path.unlink()
        except OSError:
            pass
        return None


def _torch_cert_save(fn: Function, certs: dict) -> None:
    d = disk_cache_dir()
    if d is None:
        return
    try:
        path = Path(d) / (_decode_plan_key(fn) + ".vtc")
        _atomic_write(path, pickle.dumps(
            {"schema": _TORCH_CERT_SCHEMA, "certs": certs}))
    except Exception:              # cert persistence is best-effort
        DISK_CACHE_STATS["cert_errors"] += 1


_interp.TORCH_CERT_HOOKS = (_torch_cert_load, _torch_cert_save)
_interp.ROUTED_SMALL_HOOK = lambda: _tel("routed_small")


@dataclass
class Buffer:
    name: str
    data: np.ndarray


# --------------------------------------------------------------------------
# Executor degradation chain (docs/robustness.md).
#
# The four executors form rungs of a ladder, fastest first; an
# ``EngineFault`` (internal fast-path failure — injected or real)
# demotes the launch to the rung BELOW the executor that actually ran,
# after rolling written buffers back to their pre-launch snapshot, so a
# demotion is semantically invisible: the surviving attempt produces
# bit-identical ExecStats and buffers to a launch that had taken the
# slower path from the start.  ``KernelFault``s (semantic errors)
# surface immediately — every rung would raise the same class.
# --------------------------------------------------------------------------

_RUNG_ORDER = ("torch", "grid", "wg", "decoded", "oracle")

#: interp.launch kwargs per rung.  "torch" is the top rung when the
#: Runtime enables it (on the card by default, torch=True / VOLT_TORCH=1
#: on the host): the torch codegen executor, auto-falling through to
#: grid selection when the licence or certification gate refuses.  The
#: chain asks for ``torch="route"`` — like True, plus the small-launch
#: dispatch router: certified pairs whose measured grid time beats the
#: torch rung's are served by the grid rung (docs/performance.md "Serve
#: side").  "grid" is the
#: production default (auto-selects grid / wg-batched / decoded by
#: eligibility); pinning grid=False / batched=False peels one fast
#: path per rung.
_RUNG_KWARGS: Dict[str, Dict[str, Any]] = {
    "torch":   dict(decoded=True, batched=True, torch="route"),
    "grid":    dict(decoded=True, batched=True),
    "wg":      dict(decoded=True, batched=True, grid=False),
    "decoded": dict(decoded=True, batched=False),
    "oracle":  dict(decoded=False, batched=False),
}


@dataclass
class LaunchAttempt:
    rung: str                      # rung configuration requested
    executor: Optional[str]        # executor interp actually selected
    outcome: str      # "ok" | "engine_fault" | "kernel_fault" | "deadline"
    reason: str = ""
    wall_ms: float = 0.0


@dataclass
class LaunchReport:
    """Per-launch degradation record (``Runtime.last_report``; the last
    ``REPORT_RING`` live in ``Runtime.last_reports()``)."""
    kernel: str
    attempts: List[LaunchAttempt] = field(default_factory=list)
    executor: Optional[str] = None     # executor that produced the result
    demotions: int = 0
    rolled_back: int = 0
    snapshot_bytes: int = 0
    wall_ms: float = 0.0
    # governor context (core/governor.py)
    breaker: Optional[str] = None      # breaker state when planned
    pinned_rung: Optional[str] = None  # open breaker: chain started here
    probe: bool = False                # half-open probe of the full chain
    deadline_ms: Optional[float] = None
    deadline_expired: bool = False
    snapshot_skipped: Optional[str] = None   # e.g. "mem-budget"

    def summary(self) -> str:
        steps = " -> ".join(
            f"{a.executor or a.rung}:{a.outcome}" for a in self.attempts)
        gov = ""
        if self.pinned_rung:
            gov += f", pinned @{self.pinned_rung}"
        if self.probe:
            gov += ", probe"
        if self.deadline_expired:
            gov += f", deadline {self.deadline_ms:.3g} ms expired"
        if self.snapshot_skipped:
            gov += f", snapshot skipped ({self.snapshot_skipped})"
        return (f"@{self.kernel}: {steps} ({self.demotions} demotion(s), "
                f"{self.rolled_back} rollback(s), "
                f"{self.wall_ms:.2f} ms{gov})")


#: ring depth of Runtime.last_reports() (post-mortem debugging)
REPORT_RING = 32


def _attach_report(e: BaseException, report: LaunchReport) -> None:
    """Attach the degradation history to a SURFACING exception:
    ``e.report`` for programmatic use, plus the one-line summary as an
    exception note (or an args suffix before 3.11) so a traceback shows
    which rungs were tried."""
    e.report = report                       # type: ignore[attr-defined]
    note = "launch report: " + report.summary()
    add = getattr(e, "add_note", None)
    if add is not None:
        add(note)
    elif e.args and isinstance(e.args[0], str):
        e.args = (f"{e.args[0]}\n  {note}",) + e.args[1:]
    else:
        e.args = e.args + (note,)


#: process-lifetime launch/degradation counters (GRID_TELEMETRY's
#: pattern: NOT part of ExecStats — stats stay bit-identical across
#: executors by contract).  Printed by ``benchmarks/run.py --profile``.
#: Mutate through ``_tel``/``_tel_ctr`` — the launch service drains
#: queues from concurrent submitter threads, and bare ``+=`` on a module
#: dict is a read-modify-write race.
LAUNCH_TELEMETRY: Dict[str, Any] = {}

_TEL_LOCK = threading.Lock()


def _tel(key: str, n: int = 1) -> None:
    with _TEL_LOCK:
        LAUNCH_TELEMETRY[key] += n


def _tel_ctr(key: str, sub: Any, n: int = 1) -> None:
    with _TEL_LOCK:
        LAUNCH_TELEMETRY[key][sub] += n


def reset_launch_telemetry() -> None:
    with _TEL_LOCK:
        LAUNCH_TELEMETRY.clear()
        LAUNCH_TELEMETRY.update(
            launches=0, demotions=0, rollbacks=0, engine_faults=0,
            kernel_faults=0, by_executor=Counter(),
            demotion_reasons=Counter(),
            # launch governor (core/governor.py)
            deadline_expired=0, snapshot_budget_skips=0,
            breaker_trips=0, breaker_pinned=0, breaker_probes=0,
            breaker_promotions=0,
            # launch service (continuous batching + small-launch router)
            coalesced_groups=0, coalesced_launches=0, coalesce_aborts=0,
            routed_small=0)


reset_launch_telemetry()


class Runtime:
    """A Vortex device-runtime stand-in with CUDA/OpenCL host APIs.

    ``degrade=True`` (default) arms the executor degradation chain: an
    ``EngineFault`` in a fast path rolls written buffers back to their
    pre-launch snapshot and retries one rung down (torch-codegen when
    enabled -> grid -> wg-batched -> decoded -> oracle), recording
    every attempt in
    ``self.last_report``.  ``transactional=False`` disables the
    write-root snapshots — and with them the chain, since retrying over
    partially-committed stores (or re-applied atomics) would be unsound;
    an EngineFault then surfaces to the caller.

    ``govern=True`` (default) arms the launch governor
    (core/governor.py, docs/robustness.md): per-launch wall-clock
    deadlines (``launch(..., deadline_ms=)``), a per-kernel circuit
    breaker that pins repeatedly-demoting kernels at their last-good
    rung, and the ``VOLT_MEM_BUDGET`` memory budget; ``governor=``
    overrides the knobs per Runtime.

    ``device`` is where the torch rung runs: ``None`` (default) means
    the card (``repro_torch.device.resolve_device``; no card raises),
    ``"cpu"`` the host.  ``torch`` engages the rung: ``None`` (default)
    reads ``VOLT_TORCH`` and, where that is unset, engages it on the card
    and not on the host, so ``Runtime(device="cpu")`` runs the
    reference's default numpy chain."""

    def __init__(self, *, warp_size: int = 32,
                 shared_in_local: bool = True,
                 batched: bool = True,
                 torch: Optional[bool] = None,
                 device: Optional[Any] = None,
                 degrade: bool = True,
                 transactional: bool = True,
                 govern: bool = True,
                 governor: Optional[_gov.GovernorConfig] = None,
                 workers: Optional[object] = None) -> None:
        self.warp_size = warp_size
        self.batched = batched     # workgroup-batched lockstep executor
        # host-parallel grid dispatch (core/parallel.py): resolved ONCE
        # here so a malformed VOLT_WORKERS fails at construction, not
        # mid-launch; 1 = today's exact sequential dispatch
        self.workers = _parallel.resolve_workers(workers)
        from ..device import resolve_device
        self.device = resolve_device(device)
        # torch codegen rung: on the card by default, off on the host
        # (the numpy chain stays the reference behaviour there);
        # torch= or VOLT_TORCH overrides
        if torch is None:
            env = os.environ.get("VOLT_TORCH")
            torch = (self.device.type == "cuda" if env is None
                     else env not in ("", "0"))
        self.torch = bool(torch)
        self.degrade = degrade
        self.transactional = transactional
        self.govern = govern
        self.gov_cfg = governor or _gov.GovernorConfig()
        mb = self.gov_cfg.mem_budget
        self.mem_budget = mb if mb is not None else _gov.env_mem_budget()
        self.breaker: Optional[_gov.CircuitBreaker] = \
            _gov.CircuitBreaker(self.gov_cfg.breaker_threshold,
                                self.gov_cfg.breaker_probe_every) \
            if govern else None
        pb = self.gov_cfg.pool_budget
        if pb is None:
            pb = _gov.env_pool_budget()
        #: pooled device allocator (interp.DevicePool): shared tiles,
        #: tile tables and the launch service's coalesced staging tables
        #: reuse backing arrays across launches instead of allocating —
        #: bounded by GovernorConfig.pool_budget / VOLT_POOL_BUDGET
        self.pool = _interp.DevicePool(
            capacity=pb if pb is not None else 64 << 20)
        self.buffers: Dict[str, np.ndarray] = {}
        self.globals_mem: Dict[str, np.ndarray] = {}
        self._pending_symbols: Dict[str, np.ndarray] = {}
        self.cycle_model = CycleModel(shared_in_local=shared_in_local)
        self.last_stats: Optional[ExecStats] = None
        self.last_report: Optional[LaunchReport] = None
        self._reports: deque = deque(maxlen=REPORT_RING)
        # the launch service drains tenant queues from submitter
        # threads; the ring and last_report are shared post-mortem state
        self._report_lock = threading.Lock()

    def last_reports(self) -> List[LaunchReport]:
        """The last ``REPORT_RING`` LaunchReports, oldest first — the
        post-mortem trail when a failure is noticed after the fact."""
        with self._report_lock:
            return list(self._reports)

    def _push_report(self, report: LaunchReport) -> None:
        with self._report_lock:
            self.last_report = report
            self._reports.append(report)

    # -- OpenCL-ish -----------------------------------------------------------
    def create_buffer(self, name: str, data: np.ndarray) -> Buffer:
        arr = np.array(data, copy=True)
        self.buffers[name] = arr
        return Buffer(name, arr)

    def read_buffer(self, name: str) -> np.ndarray:
        return self.buffers[name]

    def enqueue_nd_range(self, kernel_fn: Function, global_size: int,
                         local_size: int,
                         scalar_args: Optional[Dict[str, Any]] = None
                         ) -> ExecStats:
        grid = max(1, (global_size + local_size - 1) // local_size)
        return self.launch(kernel_fn, grid=grid, block=local_size,
                           scalar_args=scalar_args)

    # -- CUDA-ish ---------------------------------------------------------------
    def cuda_malloc(self, name: str, size: int,
                    dtype=np.float32) -> Buffer:
        arr = np.zeros(size, dtype=dtype)
        self.buffers[name] = arr
        return Buffer(name, arr)

    def cuda_memcpy(self, dst: str, src: np.ndarray) -> None:
        self.buffers[dst][:] = src

    def cuda_memcpy_from(self, src: str) -> np.ndarray:
        return self.buffers[src].copy()

    def cuda_memcpy_to_symbol(self, module: Module, symbol: str,
                              data: np.ndarray) -> None:
        """Deferred constant initialization (Case Study 2): stage host data;
        it is materialized into the symbol's global storage at launch."""
        if symbol not in module.globals:
            raise KeyError(f"no such device symbol {symbol!r}")
        g = module.globals[symbol]
        arr = np.asarray(data, dtype=_TY_DTYPE[g.elem_ty])
        if len(arr) > g.size:
            raise ValueError(f"symbol {symbol} overflow: {len(arr)} > {g.size}")
        self._pending_symbols[symbol] = arr

    # -- launch ------------------------------------------------------------------
    def _snapshot_write_roots(self, kernel_fn: Function,
                              report: LaunchReport,
                              budget: Optional[int] = None,
                              force: bool = False,
                              buffers: Optional[Dict[str, np.ndarray]]
                              = None,
                              globals_mem: Optional[Dict[str, np.ndarray]]
                              = None) -> Optional[Dict[Any, Any]]:
        """Transactional snapshot: copy the buffers this kernel may
        WRITE (interp.write_root_buffers; everything bound when the
        scan cannot resolve a store root).  Read-only buffers are never
        copied — that is what keeps the clean-path overhead inside the
        <5% bench_robust budget.  Also records the global names alive
        now, so a rollback can drop globals the launch lazily created.

        With a memory ``budget``, an over-budget snapshot is refused
        (returns None) and the caller degrades to oracle-first
        execution — the floor needs no retry snapshot — instead of
        OOMing mid-chain.  ``force`` overrides the budget: an armed
        deadline's rollback contract outranks the budget (the snapshot
        is the only thing that makes a timed-out launch bit-invisible)."""
        bufs = self.buffers if buffers is None else buffers
        gmem = self.globals_mem if globals_mem is None else globals_mem
        roots = _interp.write_root_buffers(kernel_fn)
        pairs: List[Tuple[Any, np.ndarray]] = []
        if roots is None:
            pairs.extend((("b", n), a) for n, a in bufs.items())
            pairs.extend((("g", n), a) for n, a in gmem.items())
        else:
            params_w, globals_w = roots
            for name in params_w:
                arr = bufs.get(name)
                if arr is not None:
                    pairs.append((("b", name), arr))
            for name in globals_w:
                arr = gmem.get(name)
                if arr is not None:
                    pairs.append((("g", name), arr))
        total = sum(a.nbytes for _, a in pairs)
        if budget is not None and total > budget and not force:
            report.snapshot_skipped = "mem-budget"
            _tel("snapshot_budget_skips")
            return None
        snap: Dict[Any, Any] = {k: a.copy() for k, a in pairs}
        snap["__globals_keys__"] = set(gmem)
        report.snapshot_bytes = total
        return snap

    def _rollback(self, snap: Dict[Any, Any],
                  buffers: Optional[Dict[str, np.ndarray]] = None,
                  globals_mem: Optional[Dict[str, np.ndarray]] = None
                  ) -> None:
        bufs = self.buffers if buffers is None else buffers
        gmem = self.globals_mem if globals_mem is None else globals_mem
        for key, arr in snap.items():
            if not isinstance(key, tuple):
                continue
            kind, name = key
            dst = bufs[name] if kind == "b" else gmem[name]
            dst[:] = arr
        # globals the failed attempt lazily zero-created: drop them so
        # the retry re-creates them identically
        for name in list(gmem):
            if name not in snap["__globals_keys__"]:
                del gmem[name]

    def launch(self, kernel_fn: Function, *, grid: int, block: int,
               scalar_args: Optional[Dict[str, Any]] = None,
               deadline_ms: Optional[float] = None,
               buffers: Optional[Dict[str, np.ndarray]] = None,
               globals_mem: Optional[Dict[str, np.ndarray]] = None,
               fuel: Optional[int] = None) -> ExecStats:
        """Run one kernel launch through the full degradation chain.
        ``buffers``/``globals_mem`` override the Runtime-owned dicts —
        the launch service runs each tenant's launch against the
        tenant's own buffer set while sharing this Runtime's breaker
        bank, governor, pool and report ring."""
        bufs = self.buffers if buffers is None else buffers
        gmem = self.globals_mem if globals_mem is None else globals_mem
        # materialize staged symbols now that "addresses are resolved"
        for sym, data in self._pending_symbols.items():
            buf = gmem.get(sym)
            if buf is None or len(buf) < len(data):
                buf = np.zeros(max(len(data), 1), dtype=data.dtype)
            buf[:len(data)] = data
            gmem[sym] = buf
        self._pending_symbols.clear()

        params = LaunchParams(grid=grid, local_size=block,
                              warp_size=self.warp_size)
        if fuel is not None:
            params = dataclasses.replace(params, fuel=fuel)
        chain = list(_RUNG_ORDER) if self.batched \
            else list(_RUNG_ORDER[_RUNG_ORDER.index("decoded"):])
        if not self.torch:
            chain = [r for r in chain if r != "torch"]
        if not (self.degrade and self.transactional):
            chain = chain[:1]      # single attempt, no retry
        report = LaunchReport(kernel=kernel_fn.name)
        self._push_report(report)
        _tel("launches")

        # ---- governor plan (core/governor.py) ------------------------
        if deadline_ms is None and self.govern:
            deadline_ms = self.gov_cfg.deadline_ms
        mem_budget = self.mem_budget if self.govern else None
        deadline_t: Optional[float] = None
        if deadline_ms is not None:
            report.deadline_ms = deadline_ms
            # one absolute deadline shared by every rung of the chain:
            # demotion retries do not refill the budget
            deadline_t = perf_counter() + deadline_ms * 1e-3
        bkey: Optional[str] = None
        probing = False
        if self.breaker is not None and len(chain) > 1:
            bkey = _decode_plan_key(kernel_fn)
            pin, probing = self.breaker.plan(bkey, kernel_fn.name)
            report.breaker = self.breaker.entry(
                bkey, kernel_fn.name).state
            report.probe = probing
            if probing:
                _tel("breaker_probes")
            if pin is not None:
                # open breaker: start at the last-good rung, skipping
                # the doomed fast path (and, when pinned at the oracle
                # floor with no deadline, the snapshot too)
                report.pinned_rung = pin
                _tel("breaker_pinned")
                kp = _RUNG_ORDER.index(pin)
                chain = [r for r in chain
                         if _RUNG_ORDER.index(r) >= kp] or [chain[-1]]

        txn: Optional[Dict[Any, Any]] = None
        t_launch = perf_counter()
        i = 0
        while True:
            rung = chain[i]
            # snapshot when further rungs could retry, or to honor the
            # deadline rollback contract (force= overrides the budget)
            if txn is None and self.transactional and \
                    (i + 1 < len(chain) or deadline_t is not None):
                txn = self._snapshot_write_roots(
                    kernel_fn, report, budget=mem_budget,
                    force=deadline_t is not None,
                    buffers=bufs, globals_mem=gmem)
                if txn is None and i + 1 < len(chain):
                    # over-budget snapshot: degrade straight to the
                    # oracle floor, which needs no retry snapshot
                    i = len(chain) - 1
                    rung = chain[i]
            t0 = perf_counter()
            try:
                stats = interp_launch(kernel_fn, bufs, params,
                                      scalar_args=scalar_args,
                                      globals_mem=gmem,
                                      deadline_t=deadline_t,
                                      deadline_ms=deadline_ms,
                                      mem_budget=mem_budget,
                                      pool=self.pool,
                                      workers=self.workers,
                                      device=self.device,
                                      **_RUNG_KWARGS[rung])
            except DeadlineExceeded as e:
                used = _interp.LAST_EXECUTOR[0] or rung
                report.attempts.append(LaunchAttempt(
                    rung, used, "deadline", str(e),
                    (perf_counter() - t0) * 1e3))
                report.deadline_expired = True
                _tel("deadline_expired")
                if txn is not None:
                    self._rollback(txn, buffers=bufs, globals_mem=gmem)
                    report.rolled_back += 1
                    _tel("rollbacks")
                report.wall_ms = (perf_counter() - t_launch) * 1e3
                if bkey is not None:
                    self.breaker.abort(bkey, kernel_fn.name,
                                       probing=probing)
                _attach_report(e, report)
                raise
            except EngineFault as e:
                used = getattr(e, "rung", None) \
                    or _interp.LAST_EXECUTOR[0] or rung
                report.attempts.append(LaunchAttempt(
                    rung, used, "engine_fault", str(e),
                    (perf_counter() - t0) * 1e3))
                _tel("engine_faults")
                # demote BELOW the executor that actually ran (a
                # gate-refused grid request already fell back before
                # the fault fired)
                k = _RUNG_ORDER.index(used) if used in _RUNG_ORDER \
                    else _RUNG_ORDER.index(rung)
                nxt = None
                for j in range(i + 1, len(chain)):
                    if _RUNG_ORDER.index(chain[j]) > k:
                        nxt = j
                        break
                if nxt is None or txn is None:
                    report.wall_ms = (perf_counter() - t_launch) * 1e3
                    if bkey is not None:
                        self.breaker.abort(bkey, kernel_fn.name,
                                           probing=probing)
                    _attach_report(e, report)
                    raise
                self._rollback(txn, buffers=bufs, globals_mem=gmem)
                report.rolled_back += 1
                report.demotions += 1
                _tel("rollbacks")
                _tel("demotions")
                _tel_ctr("demotion_reasons",
                         getattr(e, "site", None) or "exec")
                i = nxt
                continue
            except KernelFault as e:
                # semantic: deterministic, every rung agrees — surface
                report.attempts.append(LaunchAttempt(
                    rung, _interp.LAST_EXECUTOR[0], "kernel_fault",
                    str(e), (perf_counter() - t0) * 1e3))
                _tel("kernel_faults")
                report.wall_ms = (perf_counter() - t_launch) * 1e3
                if bkey is not None:
                    # never a breaker trip — but a probe that hit a
                    # semantic fault learned nothing: re-pin
                    self.breaker.abort(bkey, kernel_fn.name,
                                       probing=probing)
                e.report = report          # type: ignore[attr-defined]
                raise
            used = _interp.LAST_EXECUTOR[0] or rung
            report.attempts.append(LaunchAttempt(
                rung, used, "ok", "", (perf_counter() - t0) * 1e3))
            report.executor = used
            report.wall_ms = (perf_counter() - t_launch) * 1e3
            _tel_ctr("by_executor", used)
            if bkey is not None:
                demoted = report.demotions > 0
                changed = self.breaker.record(
                    bkey, kernel_fn.name, demoted=demoted,
                    final_rung=used, probing=probing)
                if changed:
                    _tel("breaker_trips" if demoted
                         else "breaker_promotions")
                report.breaker = self.breaker.entry(
                    bkey, kernel_fn.name).state
            self.last_stats = stats
            return stats

    def launch_kernel(self, kernel_handle, *, grid: int, block: int,
                      config: Optional[PassConfig] = None,
                      scalar_args: Optional[Dict[str, Any]] = None,
                      deadline_ms: Optional[float] = None
                      ) -> ExecStats:
        """Compile (memoized via the module compile cache) and launch a
        front-end @kernel handle in one call — the hot path for repeated
        launches of the same kernel."""
        ck = compile_kernel(kernel_handle, config,
                            warp_size=self.warp_size)
        return self.launch(ck.fn, grid=grid, block=block,
                           scalar_args=scalar_args,
                           deadline_ms=deadline_ms)

    def cycles(self, stats: Optional[ExecStats] = None) -> float:
        st = stats or self.last_stats
        if st is None:
            raise RuntimeError("no kernel has been launched")
        return self.cycle_model.cycles(st)


# --------------------------------------------------------------------------
# Launch service: continuous launch batching over the Runtime
# --------------------------------------------------------------------------


class LaunchHandle:
    """One launch submitted to a :class:`LaunchService`.  ``flush()``
    fills in exactly one of ``stats`` / ``error``; ``result()`` replays
    the solo-launch contract (return the ExecStats or raise the stored
    exception, with ``.report`` attached where the solo path attaches
    it)."""

    __slots__ = ("kernel", "tenant", "grid", "block", "stats", "error",
                 "report", "mode")

    def __init__(self, kernel: str, tenant: Any, grid: int,
                 block: int) -> None:
        self.kernel = kernel
        self.tenant = tenant
        self.grid = grid
        self.block = block
        self.stats: Optional[ExecStats] = None
        self.error: Optional[BaseException] = None
        self.report: Optional[LaunchReport] = None
        #: "coalesced" | "solo" | None (not flushed yet)
        self.mode: Optional[str] = None

    def done(self) -> bool:
        return self.stats is not None or self.error is not None

    def result(self) -> ExecStats:
        if self.error is not None:
            raise self.error
        if self.stats is None:
            raise RuntimeError(
                f"launch of @{self.kernel} not flushed yet "
                f"(call LaunchService.flush())")
        return self.stats

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        state = ("error" if self.error is not None
                 else "ok" if self.stats is not None else "pending")
        return (f"LaunchHandle(@{self.kernel}, tenant={self.tenant!r}, "
                f"grid={self.grid}, {state}, mode={self.mode})")


class LaunchService:
    """Async multi-tenant launch front-end over one :class:`Runtime`.

    Tenants ``submit()`` launches against their OWN buffer dicts into a
    bounded pending queue (overflow raises ``EngineBusy`` — the serve
    engine's backpressure contract); ``flush()`` drains it, coalescing
    compatible launches of the same compiled kernel — same decode-plan
    content hash, same block shape, same buffer signature, coalescing
    licence granted (``interp._coalesce_struct``) — into shared grid
    chunks via :func:`interp.launch_coalesced`.  Results are
    bit-identical to running each launch alone: stats are de-mixed per
    tenant by the striped accounting, buffers write back per tenant
    from the staging tables, and ANY group condition the coalesced
    driver cannot reproduce exactly (licence refusal at decode,
    desync, a kernel error, an injected fault, a deadline) aborts the
    group untouched and reruns every member through the normal
    ``Runtime.launch`` degradation chain — so faults, deadlines and
    breaker trips stay per-launch, never per-chunk.

    The runtime's governor context is shared: coalesced groups run
    against the same ``DevicePool`` and ``VOLT_MEM_BUDGET``, arm the
    tightest member deadline, are skipped while the kernel's circuit
    breaker is open (a demoting kernel must keep its per-launch chain),
    and pause after ``ABORT_STREAK`` consecutive aborts (re-probing
    every ``RETRY_EVERY`` flushes) so a persistently-refusing group
    stops paying the staging cost."""

    #: consecutive group aborts before a group key stops coalescing
    ABORT_STREAK = 3
    #: paused group keys re-probe coalescing every N-th flush
    RETRY_EVERY = 8

    def __init__(self, runtime: Runtime, *, max_pending: int = 256,
                 coalesce: bool = True,
                 pressure: Optional[float] = 0.5) -> None:
        self.rt = runtime
        self.max_pending = max_pending
        self.coalesce = coalesce
        #: latency-bounded flush: when the OLDEST queued launch has
        #: burned this fraction of its deadline budget just waiting in
        #: the queue, the next submit() drains everything — batching
        #: must never turn a deadline miss into a queueing artifact.
        #: None disables (explicit flush() only).
        self.pressure = pressure
        self._lock = threading.Lock()      # queue admission
        self._flush_lock = threading.Lock()  # serializes drains
        self._pending: List[Tuple[Any, ...]] = []
        self._aborts: Dict[Tuple[Any, ...], int] = {}
        self._cooldown: Dict[Tuple[Any, ...], int] = {}
        self.telemetry: Counter = Counter()
        self.last_abort: Optional[str] = None

    # -- admission ----------------------------------------------------------
    def submit(self, kernel_fn: Function, *, grid: int, block: int,
               buffers: Dict[str, np.ndarray],
               scalar_args: Optional[Dict[str, Any]] = None,
               deadline_ms: Optional[float] = None,
               tenant: Any = None) -> LaunchHandle:
        """Queue one launch of ``kernel_fn`` against ``buffers`` (the
        tenant's own dict — mutated in place exactly as
        ``Runtime.launch`` would).  Raises ``EngineBusy`` when the
        pending queue is full."""
        with self._lock:
            if len(self._pending) >= self.max_pending:
                self.telemetry["busy_rejections"] += 1
                raise EngineBusy(
                    f"launch queue full ({len(self._pending)}/"
                    f"{self.max_pending}); flush() or retry later")
            h = LaunchHandle(
                kernel_fn.name,
                tenant if tenant is not None else len(self._pending),
                grid, block)
            self._pending.append(
                (kernel_fn, grid, block, buffers, scalar_args,
                 deadline_ms, h, perf_counter()))
            urgent = self._deadline_pressure()
        if urgent:
            # drain OUTSIDE the admission lock (flush() takes it to
            # swap the queue; holding it here would deadlock)
            self.telemetry["pressure_flushes"] += 1
            self.flush()
        return h

    def _deadline_pressure(self) -> bool:
        """True when any queued launch (the oldest first — entries are
        in submission order) has burned more than ``self.pressure`` of
        its deadline budget waiting (caller holds ``self._lock``)."""
        if self.pressure is None or not self._pending:
            return False
        now = perf_counter()
        default_dl = self.rt.gov_cfg.deadline_ms if self.rt.govern \
            else None
        for entry in self._pending:
            dl = entry[5] if entry[5] is not None else default_dl
            if dl is None:
                continue
            if (now - entry[7]) * 1e3 >= self.pressure * dl:
                return True
        return False

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- drain --------------------------------------------------------------
    def flush(self) -> List[LaunchHandle]:
        """Drain the queue: group, coalesce where licensed, solo-run the
        rest.  Returns the drained handles in submission order; errors
        are STORED on their handle (``.result()`` re-raises), never
        raised from flush — one tenant's fault must not block the
        drain."""
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return []
        with self._flush_lock:
            groups: Dict[Tuple[Any, ...], List[Tuple[Any, ...]]] = {}
            for entry in batch:
                groups.setdefault(self._group_key(entry), []).append(entry)
            for key, entries in groups.items():
                self._run_group(key, entries)
        return [entry[6] for entry in batch]

    def _group_key(self, entry: Tuple[Any, ...]) -> Tuple[Any, ...]:
        fn, grid, block, buffers, _scal, _dl, _h, _t = entry
        sig = []
        for p in fn.params:
            if p.ty is not Ty.PTR:
                continue
            b = buffers.get(p.name)
            if isinstance(b, np.ndarray):
                sig.append((p.name, b.shape, b.dtype.str))
            else:
                sig.append((p.name, None, None))
        return (_decode_plan_key(fn), block, self.rt.warp_size,
                tuple(sig))

    def _run_group(self, key: Tuple[Any, ...],
                   entries: List[Tuple[Any, ...]]) -> None:
        fn = entries[0][0]
        if (self.coalesce and len(entries) >= 2
                and self._may_coalesce(key, fn)
                and self._run_coalesced(key, fn, entries)):
            return
        for (fn_, grid, block, bufs, scal, dl, h, _t) in entries:
            self._run_solo(fn_, grid, block, bufs, scal, dl, h)

    def _may_coalesce(self, key: Tuple[Any, ...], fn: Function) -> bool:
        if _interp._coalesce_struct(fn) is None:
            self.telemetry["no_licence"] += 1
            return False
        rt = self.rt
        if rt.breaker is not None:
            # read-only peek: an open/half-open breaker means this
            # kernel is demoting — its launches need the full
            # per-launch chain (and the probe accounting), which only
            # the solo path runs
            st = rt.breaker.entry(key[0], fn.name)
            if st.state != "closed":
                self.telemetry["breaker_solo"] += 1
                return False
        if self._aborts.get(key, 0) >= self.ABORT_STREAK:
            cd = self._cooldown.get(key, self.RETRY_EVERY) - 1
            if cd > 0:
                self._cooldown[key] = cd
                self.telemetry["abort_paused"] += 1
                return False
            self._cooldown[key] = self.RETRY_EVERY
        return True

    def _run_coalesced(self, key: Tuple[Any, ...], fn: Function,
                       entries: List[Tuple[Any, ...]]) -> bool:
        rt = self.rt
        # cross-tenant aliasing: two queued launches sharing a buffer
        # must run sequentially (the second reads the first's output);
        # staged write-back would make them last-wins instead
        arrs = [[a for a in bufs.values() if isinstance(a, np.ndarray)]
                for (_f, _g, _b, bufs, _s, _d, _h, _t) in entries]
        for i in range(len(arrs)):
            for j in range(i + 1, len(arrs)):
                for a in arrs[i]:
                    for b in arrs[j]:
                        if np.shares_memory(a, b):
                            self.telemetry["alias_solo"] += 1
                            return False
        triples = []
        deadlines = []
        for (_f, grid, block, bufs, scal, dl, _h, _t) in entries:
            triples.append((bufs, scal, LaunchParams(
                grid=grid, local_size=block,
                warp_size=rt.warp_size)))
            if dl is None and rt.govern:
                dl = rt.gov_cfg.deadline_ms
            if dl is not None:
                deadlines.append(dl)
        deadline_ms = min(deadlines) if deadlines else None
        mem_budget = rt.mem_budget if rt.govern else None
        armed = False
        t0 = perf_counter()
        try:
            if deadline_ms is not None:
                # tightest member deadline governs the group; a trip
                # aborts it untouched and the solo reruns re-arm each
                # tenant's own budget
                _gov.arm_deadline(perf_counter() + deadline_ms * 1e-3,
                                  deadline_ms)
                armed = True
            with _faults.rung("grid"):
                stats = _interp.launch_coalesced(
                    fn, triples, pool=rt.pool, mem_budget=mem_budget,
                    workers=rt.workers)
        except _interp._CoalesceAbort as e:
            self._aborts[key] = self._aborts.get(key, 0) + 1
            self._cooldown[key] = self.RETRY_EVERY
            self.telemetry["group_aborts"] += 1
            self.last_abort = str(e)
            _tel("coalesce_aborts")
            return False
        finally:
            if armed:
                _gov.disarm_deadline()
        self._aborts.pop(key, None)
        self._cooldown.pop(key, None)
        wall_ms = (perf_counter() - t0) * 1e3
        self.telemetry["groups"] += 1
        self.telemetry["coalesced_launches"] += len(entries)
        _tel("coalesced_groups")
        _tel("coalesced_launches", len(entries))
        for (_f, _g, _b, _bufs, _s, _d, h, _t), st in zip(entries, stats):
            report = LaunchReport(kernel=fn.name)
            report.executor = "grid"
            report.wall_ms = wall_ms    # group wall: shared chunks
            report.attempts.append(LaunchAttempt(
                "grid", "grid", "ok",
                f"coalesced x{len(entries)}", wall_ms))
            rt._push_report(report)
            h.stats = st
            h.report = report
            h.mode = "coalesced"
            rt.last_stats = st
            _tel("launches")
            _tel_ctr("by_executor", "grid")
        if rt.breaker is not None:
            rt.breaker.record(key[0], fn.name, demoted=False,
                              final_rung="grid", probing=False)
        return True

    def _run_solo(self, fn: Function, grid: int, block: int,
                  bufs: Dict[str, np.ndarray],
                  scal: Optional[Dict[str, Any]],
                  dl: Optional[float], h: LaunchHandle) -> None:
        self.telemetry["solo_launches"] += 1
        try:
            h.stats = self.rt.launch(
                fn, grid=grid, block=block, scalar_args=scal,
                deadline_ms=dl, buffers=bufs)
        except Exception as e:
            h.error = e
            h.report = getattr(e, "report", None)
        else:
            h.report = self.rt.last_report
        h.mode = "solo"
