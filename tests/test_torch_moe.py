"""The port's MoE layer and MoE LMs against the JAX package's, at smoke
size.

``moe_ff`` gets the same bf16 x and params on both sides (numpy, from a
seed). Router logits come out equal, so routing, capacity drops and the
dispatch table are equal too; the expert FF differs in rounding only:
the port keeps the hidden in float32 (as the Pallas kernel does), the
reference rounds it to bf16. Held at ``MOE_TOL`` = 3e-2 on outputs of
size up to ~2.4 (measured: 0.0156 at C = 40, 0.0078 at C = 1: one or
two bf16 ulps), the aux loss at rtol 1e-6 (the same float32 sums;
measured 9e-8).

The LMs (olmoe-1b-7b's smoke variant: 2 layers, d_model 128, 8 experts
of d_ff 64, top-2; kimi-k2's, which adds the shared MLP) get the JAX
package's ``init_params`` output through ``lm_params_from_numpy``. End to
end, bf16 near-ties in the router make the two sides route some tokens
apart: the port's attention keeps its scores in float32, the
reference's rounds them to bf16, so the MoE input differs by an ulp, and
bf16 router logits tie or sit an ulp apart often. On olmoe-smoke with
the reference's random router, 6-13 of 512 (token, layer) routings of a
4 x 64 prefill differed at seeds 0-5, each a top-k gap of at most 0.024
in the first layer, and the logits differed by up to 0.154 at prefill
and 0.33 at decode.
So the end-to-end checks zero the router: every logit ties, and
``lax.top_k``'s rule (the lower index first) routes every token to
experts 0 and 1, on both sides alike, with most assignments dropped by
capacity. There the logits meet at ``TOL`` = 0.1, as granite's do in
``test_torch_lm.py`` (measured 0.022-0.031). The random router is held
layer by layer instead: each MoE layer of the reference's own prefill,
fed the reference's input, gives the same routing and outputs at
``MOE_TOL`` on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models import moe as RM
from repro.models.blueprint import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
from repro_torch.models import get_model
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.models.blueprint import count_params, init_params

MOE_TOL = 3e-2
TOL = 0.1
B, S = 2, 64
MOE_ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def _moe_params(d, E, f, seed, router=None):
    """The same bf16 MoE params as a JAX dict and a torch dict."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "wi": rng.standard_normal((E, d, 2 * f)) / np.sqrt(d),
         "wo": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if router is not None:
        p["router"] = router
    pt = lm_params_from_numpy({k: v.astype(np.float32) for k, v in p.items()},
                              "cpu", PM.moe_bp(d, E, f))
    return {k: jnp.array(v.float().numpy(), jnp.bfloat16)
            for k, v in pt.items()}, pt


def _x(shape, seed):
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).bfloat16()
    return jnp.array(t.float().numpy(), jnp.bfloat16), t


@pytest.mark.parametrize("T,C", [(128, 40), (4, 1)])
def test_moe_ff_matches_reference(T, C):
    """C = 40 at the smoke LM's prefill (2 x 64 tokens), C = 1 at a
    decode-like T = 4. The router favours experts 0 and 1 (their columns
    scaled 4x), so both capacities drop assignments."""
    d, E, k, f = 128, 8, 2, 64
    assert PM.capacity(T, k, E, 1.25) == C
    router = np.random.default_rng(7).standard_normal((d, E)) / np.sqrt(d)
    router[:, :2] *= 4
    pj, pt = _moe_params(d, E, f, 0, router=router)
    xj, xt = _x((1, T, d), 1)
    want, want_aux = RM.moe_ff(pj, xj, n_experts=E, top_k=k)
    got, aux = PM.moe_ff(pt, xt, n_experts=E, top_k=k)
    assert got.dtype == torch.bfloat16 and got.shape == (1, T, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert PM.dropped_share(pt, xt, n_experts=E, top_k=k) > 0


def test_dropped_share_counts_assignments_past_capacity():
    d, E, k, f, T = 16, 4, 2, 8, 6
    pj, pt = _moe_params(d, E, f, 2)
    _, xt = _x((1, T, d), 3)
    _, _, idx = PM.route(pt, xt[0], k)
    per = np.bincount(idx.numpy().ravel(), minlength=E)
    C = PM.capacity(T, k, E, 1.25)
    assert C == 3
    assert PM.dropped_share(pt, xt, n_experts=E, top_k=k) == \
        np.maximum(per - C, 0).sum() / (T * k)


@pytest.mark.parametrize("T,E,k,cf", [(64, 8, 2, 1.25), (8, 384, 8, 1.25),
                                      (40, 4, 3, 0.5)])
def test_dispatch_fills_each_expert_from_slot_zero(T, E, k, cf):
    """Each expert's slots hold its first min(assigned, C) tokens, in
    token order, and every slot at or past that count holds the zero row
    T: the counts moe_ff hands the kernel are min(assigned, C)."""
    rng = np.random.default_rng(T + E)
    gate_idx = torch.from_numpy(np.stack(
        [rng.choice(E, k, replace=False) for _ in range(T)]))
    gate_vals = torch.from_numpy(rng.uniform(0.1, 1.0, (T, k))).float()
    C = PM.capacity(T, k, E, cf)
    table, wtable = PM.dispatch(gate_idx, gate_vals, T, E, C)
    slots = table.view(E, C)
    assigned = np.bincount(gate_idx.numpy().ravel(), minlength=E)
    counts = (slots != T).sum(1, dtype=torch.int32)
    np.testing.assert_array_equal(counts.numpy(), np.minimum(assigned, C))
    for e in range(E):
        n = int(counts[e])
        toks = np.nonzero((gate_idx.numpy() == e).any(1))[0][:n]
        np.testing.assert_array_equal(slots[e, :n].numpy(), toks)
        assert (slots[e, n:] == T).all()
        assert (wtable.view(E, C)[e, n:] == 0).all()
    assert (assigned > C).any() or cf > 1   # the cases drop


@pytest.mark.parametrize("T,C", [(128, 40), (4, 1)])
def test_moe_ff_with_counts_equals_moe_ff_without(T, C, monkeypatch):
    """The counts only skip what is zero anyway: at capacities that drop,
    moe_ff gives the same bits when the expert FF is called without
    them."""
    d, E, k, f = 128, 8, 2, 64
    router = np.random.default_rng(7).standard_normal((d, E)) / np.sqrt(d)
    router[:, :2] *= 4
    _, pt = _moe_params(d, E, f, 0, router=router)
    _, xt = _x((1, T, d), 1)
    assert PM.capacity(T, k, E, 1.25) == C
    assert PM.dropped_share(pt, xt, n_experts=E, top_k=k) > 0
    got, _ = PM.moe_ff(pt, xt, n_experts=E, top_k=k)
    monkeypatch.setattr(PM, "grouped_expert_ff",
                        lambda x, wi, wo, counts, **kw:
                        MD.grouped_expert_ff(x, wi, wo))
    want, _ = PM.moe_ff(pt, xt, n_experts=E, top_k=k)
    assert torch.equal(got, want)


def test_capacity_is_the_references_floor():
    assert PM.capacity(8192, 8, 64, 1.25) == 1280   # olmoe prefill 4 x 2048
    assert PM.capacity(8, 8, 64, 1.25) == 1         # the engine's 8 slots
    assert PM.capacity(64, 8, 64, 8.0) == 64
    assert PM.capacity(10, 3, 8, 1.25) == 3         # floor(3 * 1.25)


@pytest.mark.parametrize("case", ["zero", "duplicate_columns", "bf16_grid"])
def test_route_breaks_ties_as_lax_top_k(case):
    """Deliberate ties: a zero router (every logit ties), duplicated
    router columns (pairs of experts tie on every token), and logits on a
    coarse grid (many ties). Gate indices equal ``lax.top_k``'s on the
    same probabilities, gate values its renormalized values."""
    d, E, k, T = 32, 8, 3, 64
    rng = np.random.default_rng(4)
    if case == "zero":
        router = np.zeros((d, E))
    elif case == "duplicate_columns":
        router = rng.standard_normal((d, E)) / np.sqrt(d)
        router[:, 5], router[:, 6] = router[:, 1], router[:, 2]
    else:
        router = np.round(rng.standard_normal((d, E)) * 2) / 8
    pj, pt = _moe_params(d, E, 16, 5, router=router)
    xj, xt = _x((T, d), 6)
    if case == "bf16_grid":
        xt = torch.round(xt.float()).bfloat16()
        xj = jnp.array(xt.float().numpy(), jnp.bfloat16)
    logits = jnp.einsum("td,de->te", xj, pj["router"]).astype(jnp.float32)
    vals, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    _, gv, gi = PM.route(pt, xt, k)
    lt = np.asarray(logits)
    assert (np.sort(lt, 1)[:, 1:] == np.sort(lt, 1)[:, :-1]).any(), \
        "no ties"
    np.testing.assert_array_equal(gi.numpy(), np.asarray(idx))
    want = np.asarray(vals) / np.asarray(vals).sum(-1, keepdims=True)
    np.testing.assert_allclose(gv.numpy(), want, rtol=1e-6)


# --------------------------------------------------------------------------
# the LMs
# --------------------------------------------------------------------------

def _models(arch, seed=0, tie_router=False):
    cfg = ref_get_config(arch, smoke=True)
    ref = ref_get_model(cfg)
    ref_params = ref_init_params(ref.blueprint(), jax.random.PRNGKey(seed))
    if tie_router:
        for layer in ref_params["stack"]:
            if "moe" in layer:
                layer["moe"]["router"] = jnp.zeros_like(
                    layer["moe"]["router"])
    model = get_model(get_config(arch, smoke=True))
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params),
        "cpu", model.blueprint())
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return cfg, ref, ref_params, model, params, toks.astype(np.int32)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def tied(request):
    return _models(request.param, tie_router=True)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_blueprint_matches_reference(arch):
    """Same leaves, shapes, axes, init rules and dtypes, smoke and full
    (the full one is never allocated)."""
    for smoke in (True, False):
        ref_bp = _flat(ref_get_model(ref_get_config(arch, smoke)).blueprint())
        bp = _flat(get_model(get_config(arch, smoke)).blueprint())
        assert bp.keys() == ref_bp.keys()
        for k, l in bp.items():
            r = ref_bp[k]
            assert (l.shape, l.axes, l.init, l.scale_dim) == \
                (r.shape, r.axes, r.init, r.scale_dim), k
            assert str(l.dtype) == f"torch.{np.dtype(r.dtype).name}", k
    full = count_params(get_model(get_config("olmoe-1b-7b")).blueprint())
    assert 6.0e9 < full < 7.8e9          # tests/test_archs.py's bounds


def test_prefill_matches_reference(tied):
    cfg, ref, ref_params, model, params, toks = tied
    want = np.asarray(ref.prefill(ref_params, jnp.array(toks)))
    got = model.prefill(params, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_decode_steps_match_reference(tied):
    """B = 2 tokens a step: C = 1, so one of the two assignments to
    experts 0 and 1 is dropped at every step."""
    cfg, ref, ref_params, model, params, toks = tied
    ref_cache = ref.init_cache(B, 16)
    cache = model.init_cache(B, 16, device="cpu")
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        want, ref_cache = ref.decode_step(ref_params, ref_cache,
                                          jnp.array(toks[:, t:t + 1]),
                                          jnp.array(pos))
        got, cache = model.decode_step(
            params, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
            torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy()[..., :cfg.vocab],
                                   np.asarray(want)[..., :cfg.vocab],
                                   atol=TOL, rtol=TOL)


def test_moe_layers_of_the_reference_prefill_route_alike(monkeypatch):
    """olmoe-smoke with the reference's random router: every MoE layer of
    the reference's prefill, fed the reference's own input, routes alike
    on the port and gives the same output at MOE_TOL."""
    cfg, ref, ref_params, model, params, toks = _models("olmoe-1b-7b")
    seen = []
    ref_moe_ff = RM.moe_ff

    def record(p, x, **kw):
        out = ref_moe_ff(p, x, **kw)
        seen.append((x, p, out[0], kw))
        return out

    monkeypatch.setattr(RM, "moe_ff", record)
    with jax.disable_jit():
        ref.prefill(ref_params, jnp.array(toks))
    assert len(seen) == cfg.n_layers
    for i, (x, p, want, kw) in enumerate(seen):
        pt = {k: v[i] for k, v in params["stack"][0]["moe"].items()}
        xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
        logits = jnp.einsum("td,de->te", x.reshape(-1, cfg.d_model),
                            p["router"]).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               cfg.moe_top_k)
        _, _, gi = PM.route(pt, xt.reshape(-1, cfg.d_model), cfg.moe_top_k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(idx))
        got, _ = PM.moe_ff(pt, xt, **kw)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=MOE_TOL, rtol=MOE_TOL)


def test_decode_matches_prefill_without_drops():
    """The port's own check (tests/test_archs.py's tolerance): teacher-
    forced decode reproduces prefill's last logits where the capacity
    drops nothing on either path (capacity factor 8: C >= T)."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              moe_capacity=8.0)
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (1, 8)))
    full = model.prefill(params, toks)
    cache = model.init_cache(1, 16, device="cpu")
    for t in range(8):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          torch.full((1,), t))
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab].numpy(),
                               full[:, :cfg.vocab].numpy(), atol=0.55,
                               rtol=0.1)


def test_moe_layers_go_through_the_expert_ff_wrapper(monkeypatch):
    """One grouped expert FF per MoE layer per call, on (E, C, d)."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    shapes = []
    wrapped = MD.grouped_expert_ff

    def spy(x, wi, wo, counts, **kw):
        assert counts.dtype == torch.int32 and counts.shape == x.shape[:1]
        shapes.append(tuple(x.shape))
        return wrapped(x, wi, wo, counts, **kw)

    monkeypatch.setattr(PM, "grouped_expert_ff", spy)
    model.prefill(params, torch.zeros(B, S, dtype=torch.long))
    E, d = cfg.moe_experts, cfg.d_model
    assert shapes == [(E, 40, d)] * cfg.n_layers
    shapes.clear()
    model.decode_step(params, model.init_cache(B, 8, device="cpu"),
                      torch.zeros(B, 1, dtype=torch.long),
                      torch.zeros(B, dtype=torch.long))
    assert shapes == [(E, 1, d)] * cfg.n_layers
    assert PT.MOE is PM


# --------------------------------------------------------------------------
# kimi-k2 at its published head dim, 112 (the smoke config's is 32)
# --------------------------------------------------------------------------

def _kimi_112(ref_cfg_fn, cfg_fn, **kw):
    return dataclasses.replace(ref_cfg_fn("kimi-k2-1t-a32b", smoke=True),
                               head_dim=112, n_layers=1, **kw), \
        dataclasses.replace(cfg_fn("kimi-k2-1t-a32b", smoke=True),
                            head_dim=112, n_layers=1, **kw)


def test_kimi_head_dim_112_prefill_matches_reference():
    """kimi-k2's smoke config at head dim 112, one layer (the cut the card
    runs), router zeroed: the port's prefill against the reference's."""
    ref_cfg, cfg = _kimi_112(ref_get_config, get_config)
    ref = ref_get_model(ref_cfg)
    ref_params = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    ref_params["stack"][0]["moe"]["router"] = jnp.zeros_like(
        ref_params["stack"][0]["moe"]["router"])
    model = get_model(cfg)
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params),
        "cpu", model.blueprint())
    assert params["stack"][0]["attn"]["wq"].shape == (1, cfg.d_model,
                                                      cfg.n_heads, 112)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    want = np.asarray(ref.prefill(ref_params, jnp.array(toks)))
    got = model.prefill(params, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_kimi_head_dim_112_decode_matches_prefill():
    """The port's own check at head dim 112, one layer, with the random
    router, where the capacity drops nothing (capacity factor 8):
    teacher-forced decode reproduces prefill's last logits at
    tests/test_archs.py's tolerance."""
    _, cfg = _kimi_112(ref_get_config, get_config, moe_capacity=8.0)
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (1, 12)))
    full = model.prefill(params, toks)
    cache = model.init_cache(1, 16, device="cpu")
    for t in range(12):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          torch.full((1,), t))
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab].numpy(),
                               full[:, :cfg.vocab].numpy(), atol=0.55,
                               rtol=0.1)
