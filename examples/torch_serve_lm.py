"""Batched serving on the PyTorch port: continuous batching over a slot
pool, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
    PYTHONPATH=src python examples/torch_serve_lm.py --storm
    PYTHONPATH=src python examples/torch_serve_lm.py --launch-storm

``--storm`` drives the same traffic through the admission-control path
(docs/robustness.md "Launch governor"): a bounded submit queue
(``EngineBusy`` backpressure), per-request deadlines, and a
probabilistic ``serve.prefill`` / ``serve.decode`` fault storm absorbed
by jittered retries. It asserts the soak invariants, every request
reaches a terminal state and the engine never dies, and exits non-zero
if either fails.

``--launch-storm`` is the kernel-side twin: multi-tenant small launches
through the port's ``LaunchService`` with coalescing and the pooled
allocator, under a probabilistic fault storm on the coalesced walk and
the grid executor. Invariants: every handle reaches a terminal state,
every tenant's buffers stay bit-identical to a fault-free solo run
(aborted groups rerun solo, faulted solo launches demote and roll
back), and backpressure (``EngineBusy``) sheds overflow instead of
wedging. Each ``Runtime`` runs on the chosen device: on the card its
torch rung is on.
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params
from repro_torch.serve.engine import EngineBusy, Request, ServeEngine


def _model(dev):
    cfg = get_config("granite-3-2b", smoke=True)
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0),
                         dev)
    return cfg, model, params


def main(dev) -> None:
    cfg, model, params = _model(dev)
    eng = ServeEngine(model, params, slots=4, max_seq=64)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        plen = int(rng.integers(3, 12))
        r = Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
                    max_new=8)
        reqs.append(r)
        eng.submit(r)
    steps = 0
    while any(not r.done for r in reqs):
        live = eng.step()
        steps += 1
        if steps % 5 == 0:
            done = sum(r.done for r in reqs)
            print(f"[serve] step {steps}: {live} live slots, "
                  f"{done}/{len(reqs)} done")
    for r in reqs[:3]:
        print(f"[serve] req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    print(f"[serve] drained in {steps} decode steps "
          f"(continuous batching over 4 slots, {dev.type})")


def storm(dev) -> None:
    from repro_torch.core import faults

    seed = int(os.environ.get("VOLT_SOAK_SEED", "1234"))
    cfg, model, params = _model(dev)
    eng = ServeEngine(model, params, slots=4, max_seq=64, max_queue=6,
                      deadline_ms=60_000.0, retries=4, backoff_ms=0.05,
                      seed=seed)
    rng = np.random.default_rng(seed)
    reqs = []
    try:
        faults.install_spec(f"serve.prefill:0.25:{seed % 1000}, "
                            f"serve.decode:0.15:{seed % 1000 + 1}")
        for i in range(16):
            plen = int(rng.integers(3, 12))
            r = Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, plen).astype(np.int32), max_new=8)
            reqs.append(r)
            while True:
                try:
                    eng.submit(r)
                    break
                except EngineBusy:
                    eng.step()      # backpressure: make room
        eng.run_until_drained(max_steps=5_000, fail_stragglers=True)
    finally:
        faults.clear()
    assert all(r.done for r in reqs), "soak: non-terminal request"
    failed = [r for r in reqs if r.error is not None]
    print(f"[storm] {len(reqs)} requests: {len(reqs) - len(failed)} ok, "
          f"{len(failed)} failed individually")
    print(f"[storm] telemetry: {dict(eng.telemetry)}")
    # the engine survived the storm: clean traffic still completes
    tail = Request(rid=999, prompt=np.array([3, 1, 4], np.int32),
                   max_new=4)
    eng.submit(tail)
    eng.run_until_drained()
    assert tail.done and tail.error is None, "soak: engine died"
    print("[storm] post-storm clean request ok: engine alive")


def launch_storm(dev) -> None:
    from repro_torch.core import faults, runtime
    from repro_torch.core.passes.pipeline import ABLATION_LADDER
    from repro_torch.volt_bench import BENCHES

    seed = int(os.environ.get("VOLT_SOAK_SEED", "1234"))
    tenants, rounds = 6, 12
    bench = BENCHES["vecadd"]
    ck = runtime.compile_kernel(bench.handle, ABLATION_LADDER[-1])

    def mk(j):
        return bench.make(np.random.default_rng(100 + j))

    # fault-free solo runs (each tenant's result to hold the storm to)
    ref = [mk(j) for j in range(tenants)]
    rt0 = runtime.Runtime(device=dev)
    for _ in range(rounds):
        for (bufs, scalars, params) in ref:
            rt0.launch(ck.fn, grid=params.grid, block=params.local_size,
                       scalar_args=scalars, buffers=bufs)

    rt = runtime.Runtime(device=dev)
    svc = runtime.LaunchService(rt, max_pending=tenants)
    live = [mk(j) for j in range(tenants)]
    handles = []
    busy = 0
    try:
        faults.install_spec(
            f"coalesce.exec:0.3:{seed % 1000}, "
            f"grid.exec:0.1:{seed % 1000 + 1}")
        for _ in range(rounds):
            for j, (bufs, scalars, params) in enumerate(live):
                while True:
                    try:
                        handles.append(svc.submit(
                            ck.fn, grid=params.grid,
                            block=params.local_size, buffers=bufs,
                            scalar_args=scalars, tenant=j))
                        break
                    except EngineBusy:
                        busy += 1
                        svc.flush()     # backpressure: drain, resubmit
            svc.flush()
    finally:
        faults.clear()
    assert all(h.done() for h in handles), "storm: non-terminal handle"
    failed = [h for h in handles if h.error is not None]
    assert not failed, f"storm: {len(failed)} launches failed " \
        f"(faults must abort-to-solo or demote, never surface): " \
        f"{failed[:3]}"
    for j, ((rb, _, _), (lb, _, _)) in enumerate(zip(ref, live)):
        for k in rb:
            np.testing.assert_array_equal(
                rb[k], lb[k], err_msg=f"storm: tenant {j} buffer {k} "
                f"diverged from the fault-free solo run")
    t = runtime.LAUNCH_TELEMETRY
    print(f"[launch-storm] {len(handles)} launches over {tenants} "
          f"tenants on {dev.type}: {svc.telemetry['groups']} coalesced "
          f"groups, {svc.telemetry['group_aborts']} group aborts -> solo, "
          f"{t['demotions']} solo demotions, {busy} busy rejections")
    print(f"[launch-storm] pool: {rt.pool.telemetry()}")
    print("[launch-storm] all tenants bit-identical to the fault-free "
          "runs: faults stayed per-launch, never per-chunk")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--storm", action="store_true",
                    help="fault-storm soak with backpressure + deadlines")
    ap.add_argument("--launch-storm", action="store_true",
                    help="kernel-launch storm through the LaunchService "
                         "with coalescing + pooled memory under faults")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ns = ap.parse_args()
    device = resolve_device(ns.device)
    if ns.launch_storm:
        launch_storm(device)
    elif ns.storm:
        storm(device)
    else:
        main(device)
