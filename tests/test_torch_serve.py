"""The port's serving engine: the contracts of ``tests/test_serve.py`` and
``tests/test_serve_soak.py`` (drain, greedy decode, request isolation,
backpressure, deadlines, retry of transient faults), on the port's LM.

The model is granite-3-2b's smoke variant on the CPU with the JAX
package's own ``init_params`` output carried over (olmoe-1b-7b's too,
for the comparison with the reference's engine). Decode is argmax, so
token lists are compared exactly, against the port's manual greedy
decode through ``LM.decode_step``, and the port's engine is held against
the JAX package's ``ServeEngine`` serving the same requests with the same
params: every ``decode_step`` call gets the same tokens and positions,
its logits agree at ``TOL`` (that of ``test_torch_lm.py``; measured
0.043), and wherever the reference's top-2 logit gap exceeds ``GAP``
(twice the measured error, rounded up) the two choose the same token.
Measured on the seed below: 32 calls, 28 token choices, three of them
near ties (gaps 0.016, 0.031, 0.031) where both still chose alike.

A hybrid model carries recurrent state, which every decode step advances
for every slot. jamba's smoke LM (one period, capacity factor 8 so that
no step drops an assignment) gives each request its solo tokens in the
port's engine, served in a batch or after another request in a reused
slot; the reference's engine does not (ROADMAP C9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models.blueprint import init_params as ref_init_params
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import faults
from repro_torch.models import get_model
from repro_torch.serve.engine import EngineBusy, Request, ServeEngine


TOL = 0.1
GAP = 0.1


def _both(arch, tie_router=False):
    """(reference LM, its params, config, port LM, the same params)."""
    ref = ref_get_model(ref_get_config(arch, smoke=True))
    ref_params = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    if tie_router:
        for layer in ref_params["stack"]:
            layer["moe"]["router"] = jnp.zeros_like(layer["moe"]["router"])
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params),
        "cpu", model.blueprint())
    return ref, ref_params, cfg, model, params


@pytest.fixture(scope="module")
def both_models():
    return _both("granite-3-2b")


@pytest.fixture(scope="module")
def small_model(both_models):
    return both_models[2:]


def _req(cfg, rng, rid, **kw):
    plen = int(rng.integers(2, 6))
    return Request(rid=rid, prompt=rng.integers(
        0, cfg.vocab, plen).astype(np.int32), max_new=3, **kw)


def _greedy(model, params, prompt, max_new, max_seq=32):
    """Batch-1 greedy decode through ``decode_step``, token by token."""
    cache = model.init_cache(1, max_seq, device="cpu")
    out, logits = [], None
    for t, tok in enumerate(list(prompt)):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[int(tok)]]), torch.tensor([t]))
    pos = len(prompt)
    for _ in range(max_new):
        cur = int(logits[0, 0].argmax())
        out.append(cur)
        if len(out) == max_new:
            break
        logits, cache = model.decode_step(params, cache,
                                          torch.tensor([[cur]]),
                                          torch.tensor([pos]))
        pos += 1
    return out


def test_engine_drains_all_requests(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=3, max_seq=32)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(7):
        r = Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=int(rng.integers(2, 6))).astype(np.int32),
            max_new=4)
        reqs.append(r)
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and r.error is None for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)
    # continuous batching changes nothing: each equals its own decode
    for r in reqs:
        assert r.out == _greedy(model, params, r.prompt, 4)


def _record(eng, to_numpy):
    """Wraps the engine's ``_decode`` and ``_admit``: every call's
    (tokens, positions, logits) in order, and for each step's decode the
    call's index and the live slots whose tokens its logits choose."""
    calls, choices, live = [], [], []
    decode, admit = eng._decode, eng._admit

    def _decode(*args):
        logits, cache = decode(*args)
        if live:
            choices.append((len(calls), live.pop()))
        calls.append(to_numpy(args[-2], args[-1], logits))
        return logits, cache

    def _admit():
        admit()
        live.append([s for s in range(eng.slots)
                     if eng.active[s] is not None])

    eng._decode, eng._admit = _decode, _admit
    return calls, choices


def test_engine_matches_reference_engine(both_models):
    _engine_matches_reference_engine(*both_models)


def test_olmoe_engine_matches_reference_engine():
    """olmoe-1b-7b's smoke LM, its router zeroed as in
    ``test_torch_moe.py`` (bf16 near-ties would route tokens apart): every
    step's tokens and positions equal, logits at TOL. The engine feeds
    token 0 to its idle slots, and at C = 1 those take expert capacity as
    in the reference (ROADMAP C8)."""
    _engine_matches_reference_engine(*_both("olmoe-1b-7b", tie_router=True))


def _engine_matches_reference_engine(ref, ref_params, cfg, model, params):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(2, 6))
                            ).astype(np.int32) for _ in range(7)]

    def serve(eng, request, to_numpy):
        calls, choices = _record(eng, to_numpy)
        reqs = [request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.out for r in reqs], calls, choices

    want, ref_calls, choices = serve(
        RefServeEngine(ref, ref_params, slots=3, max_seq=32), RefRequest,
        lambda t, p, l: (np.asarray(t), np.asarray(p),
                         np.asarray(l[:, 0, :cfg.vocab], np.float32)))
    got, calls, _ = serve(
        ServeEngine(model, params, slots=3, max_seq=32), Request,
        lambda t, p, l: (np.array(t), np.array(p),
                         l[:, 0, :cfg.vocab].float().numpy()))
    chosen = dict(choices)
    assert len(choices) > 0
    for i, ((rt, rp, rl), (t, p, l)) in enumerate(zip(ref_calls, calls)):
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_allclose(l, rl, atol=TOL, rtol=TOL)
        top2 = np.sort(rl, axis=1)[:, -2:]
        for s in chosen.get(i, []):
            if top2[s, 1] - top2[s, 0] > GAP:
                assert l[s].argmax() == rl[s].argmax(), (i, s)
            elif l[s].argmax() != rl[s].argmax():
                return    # a near tie chose apart: the runs part here
    assert len(calls) == len(ref_calls)
    assert got == want


def test_engine_matches_manual_decode(small_model):
    cfg, model, params = small_model
    prompt = np.array([5, 9, 2], np.int32)
    eng = ServeEngine(model, params, slots=2, max_seq=32)
    r = Request(rid=0, prompt=prompt, max_new=3)
    eng.submit(r)
    eng.run_until_drained()
    assert r.out == _greedy(model, params, prompt, 3)


def test_failing_request_fails_alone(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=32)
    good = [Request(rid=i, prompt=np.array([3, 1, 4], np.int32),
                    max_new=3) for i in range(3)]
    bad = Request(rid=99, prompt=np.array([], np.int32), max_new=3)
    for r in (good[0], bad, good[1], good[2]):
        eng.submit(r)
    eng.run_until_drained()
    assert bad.done and "empty prompt" in bad.error and bad.out == []
    for r in good:
        assert r.done and r.error is None and len(r.out) == 3
    assert good[0].out == good[1].out == good[2].out


def test_too_long_request_fails_alone(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=16)
    long = Request(rid=0, prompt=np.arange(14, dtype=np.int32), max_new=8)
    ok = Request(rid=1, prompt=np.array([2, 7], np.int32), max_new=4)
    eng.submit(long)
    eng.submit(ok)
    eng.run_until_drained()
    assert long.done and "exceeds max_seq" in long.error
    assert ok.done and ok.error is None and len(ok.out) == 4


def test_run_until_drained_raises_on_max_steps(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=64)
    r = Request(rid=7, prompt=np.array([1, 2], np.int32), max_new=32)
    eng.submit(r)
    with pytest.raises(RuntimeError, match=r"not drained after 3 steps"):
        eng.run_until_drained(max_steps=3)
    assert not r.done


def test_submit_queue_backpressure(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=32, max_queue=2)
    rng = np.random.default_rng(0)
    reqs = [_req(cfg, rng, i) for i in range(3)]
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    with pytest.raises(EngineBusy, match="queue full"):
        eng.submit(reqs[2])
    assert eng.telemetry["busy_rejections"] == 1
    eng.run_until_drained()
    eng.submit(reqs[2])
    eng.run_until_drained()
    assert all(r.done and r.error is None for r in reqs)


def test_expired_request_fails_alone(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=32)
    rng = np.random.default_rng(1)
    good = [_req(cfg, rng, i) for i in range(3)]
    dead = _req(cfg, rng, 98, deadline_ms=0.0)       # expires instantly
    queued_dead = _req(cfg, rng, 99, deadline_ms=0.0)
    for r in (good[0], dead, good[1], queued_dead, good[2]):
        eng.submit(r)
    eng.run_until_drained()
    for r in (dead, queued_dead):
        assert r.done and "DeadlineExceeded" in r.error and r.out == []
    assert all(r.done and r.error is None and len(r.out) == 3
               for r in good)
    assert eng.telemetry["deadline_failures"] == 2


def test_engine_default_deadline_inherited(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=32, deadline_ms=0.0)
    r = _req(cfg, np.random.default_rng(2), 0)
    eng.submit(r)
    assert r.deadline_ms == 0.0
    eng.run_until_drained()
    assert r.done and "DeadlineExceeded" in r.error


def test_transient_faults_are_retried_on_unchanged_state(small_model):
    """serve.* faults are absorbed by the retry, and a retried step runs
    on unchanged state: every request gets the tokens of a run with no
    fault at all."""
    cfg, model, params = small_model
    rng = np.random.default_rng(3)
    prompts = [_req(cfg, rng, i).prompt for i in range(4)]

    def serve(**kw):
        eng = ServeEngine(model, params, slots=2, max_seq=32, retries=6,
                          backoff_ms=0.05)
        reqs = [Request(rid=i, prompt=p, max_new=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return eng, reqs

    clean = [r.out for r in serve()[1]]
    with faults.inject("serve.prefill", prob=0.4, seed=5), \
            faults.inject("serve.decode", prob=0.3, seed=9) as dec:
        eng, reqs = serve()
    assert dec.fired > 0
    assert all(r.done and r.error is None for r in reqs)
    assert [r.out for r in reqs] == clean
    assert eng.telemetry["transient_retries"] > 0
    assert eng.telemetry["retry_exhausted"] == 0
    assert not faults.ACTIVE


def test_persistent_decode_failure_fails_batch_not_engine(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=32, retries=1,
                      backoff_ms=0.05)
    rng = np.random.default_rng(4)
    doomed = [_req(cfg, rng, i) for i in range(2)]
    for r in doomed:
        eng.submit(r)
    with faults.inject("serve.decode"):
        eng.run_until_drained()
    assert all(r.done and "InjectedFault" in r.error for r in doomed)
    assert eng.telemetry["retry_exhausted"] >= 1
    ok = _req(cfg, rng, 10)
    eng.submit(ok)
    eng.run_until_drained()
    assert ok.done and ok.error is None and len(ok.out) == 3


def test_persistent_prefill_failure_fails_request_alone(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=2, max_seq=32, retries=1,
                      backoff_ms=0.05)
    rng = np.random.default_rng(5)
    r = _req(cfg, rng, 0)
    eng.submit(r)
    with faults.inject("serve.prefill"):
        eng.run_until_drained()
    assert r.done and "InjectedFault" in r.error
    ok = _req(cfg, rng, 1)
    eng.submit(ok)
    eng.run_until_drained()
    assert ok.done and ok.error is None


def test_drain_mode_fails_stragglers_individually(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=1, max_seq=64)
    slow = Request(rid=0, prompt=np.array([1, 2], np.int32), max_new=40)
    queued = _req(cfg, np.random.default_rng(6), 1)
    eng.submit(slow)
    eng.submit(queued)
    eng.run_until_drained(max_steps=3, fail_stragglers=True)
    assert slow.done and "straggler" in slow.error
    assert queued.done and "straggler" in queued.error
    assert eng.telemetry["straggler_failures"] == 2


def test_unknown_fault_site_is_refused():
    with pytest.raises(ValueError, match="unknown fault site"):
        with faults.inject("serve.nope"):
            pass


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--requests", "3", "--slots", "2", "--max-new", "2",
                "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(l.startswith("[serve] req") for l in lines)


# --------------------------------------------------------------------------
# recurrent state: jamba's smoke LM, one period
# --------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"
#: one period; at capacity factor 8 an engine of 1 slot or of 4 or more
#: drops no assignment (C = 1 for one token's two experts, C = 8 >= T
#: for T = 4 tokens; at T = 2 the floor gives C = 1, ROADMAP C7)
NO_DROPS = dict(n_layers=8, moe_capacity=8.0)


@pytest.fixture(scope="module")
def jamba_models():
    """(reference LM, its params, port LM, the same params, prompts)."""
    ref = ref_get_model(dataclasses.replace(
        ref_get_config(JAMBA, smoke=True), **NO_DROPS))
    ref_params = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(JAMBA, smoke=True), **NO_DROPS)
    model = get_model(cfg)
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params),
        "cpu", model.blueprint())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 7))
                            ).astype(np.int32) for _ in range(3)]
    return ref, ref_params, model, params, prompts


def _arrangements(engine, request, model, params, prompts):
    """Each request's tokens: alone in a fresh 1-slot engine, one after
    another in a reused 1-slot engine, and together on 4 slots."""
    def serve(slots, groups):
        outs = []
        for group in groups:
            eng = engine(model, params, slots=slots, max_seq=32)
            reqs = [request(rid=i, prompt=prompts[i], max_new=4)
                    for i in group]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            outs += [r.out for r in reqs]
        return outs

    every = list(range(len(prompts)))
    return (serve(1, [[i] for i in every]), serve(1, [every]),
            serve(4, [every]))


def test_jamba_requests_get_their_solo_tokens(jamba_models):
    *_, model, params, prompts = jamba_models
    solo, reused, batch = _arrangements(ServeEngine, Request, model, params,
                                        prompts)
    assert reused == solo
    assert batch == solo


def test_reference_engine_leaks_recurrent_state(jamba_models):
    """ROADMAP C9, on the reference's engine as it is: a request after
    another in a reused slot inherits its recurrent state, and a prompt
    fed into one slot advances every other slot's."""
    ref, ref_params, *_, prompts = jamba_models
    solo, reused, batch = _arrangements(RefServeEngine, RefRequest, ref,
                                        ref_params, prompts)
    assert reused[0] == solo[0]
    assert reused[1:] != solo[1:]
    assert batch != solo


def test_prompt_feed_keeps_other_slots_states(jamba_models):
    """Admitting a request zeroes its slot's recurrent rows before the
    feed and leaves every other slot's rows as they were; an
    attention-only model has no recurrent leaves to copy."""
    *_, model, params, prompts = jamba_models
    eng = ServeEngine(model, params, slots=3, max_seq=32)
    assert len(eng._recurrent) == 2 * 7
    for t in eng._recurrent:
        t.normal_()
    before = [t.clone() for t in eng._recurrent]
    seen = []
    decode = eng._decode

    def spy(toks, pos):
        seen.append([t[:, 1].clone() for t in eng._recurrent])
        return decode(toks, pos)

    eng._decode = spy
    eng._prefill(1, Request(rid=0, prompt=prompts[0], max_new=2))
    assert len(seen) == len(prompts[0]) - 1
    assert all((t == 0).all() for t in seen[0])
    for t, b in zip(eng._recurrent, before):
        assert torch.equal(t[:, [0, 2]], b[:, [0, 2]])
        assert not torch.equal(t[:, 1], b[:, 1])
    granite = ServeEngine(*_both("granite-3-2b")[3:], slots=2, max_seq=16)
    assert granite._recurrent == []


def test_jamba_transient_faults_are_retried_on_clean_state(jamba_models):
    *_, model, params, prompts = jamba_models
    solo = _arrangements(ServeEngine, Request, model, params, prompts)[0]
    with faults.inject("serve.prefill", prob=0.5, seed=3) as pre, \
            faults.inject("serve.decode", prob=0.3, seed=4):
        eng = ServeEngine(model, params, slots=4, max_seq=32, retries=8,
                          backoff_ms=0.05)
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    assert pre.fired > 0
    assert [r.out for r in reqs] == solo
