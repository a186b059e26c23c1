"""The MoE layer's gradient in the port against the JAX package's, on the
CPU: the expert FF's backward (``kernels/moe_dispatch/moe_dispatch_bwd.py``)
and the fixed-order gather combine (``kernels/moe_dispatch/
moe_combine.py``, ``models/moe.py``).

Inputs come from a numpy seed at small sizes (E 4 experts with ragged
``counts``, capacity C 8, d 64, f 32) and go through both packages.
Tolerances, each with its reason:

  * ``BWD_TOL``, the largest |got - want| over the largest |want| of each
    output: float32 1e-4 (float32 products of up to 64 terms summed in
    another order than XLA's); bf16 1e-2 (both sides round one float32
    result to bf16, at most one ulp, 2^-7 of the largest value).
  * ``GRAD_TOL`` = 2e-2, relative L2 a leaf (``tests/test_torch_train.py``'s):
    ``moe_ff``'s gradients against ``jax.grad`` of the reference's, in
    float32 (measured about 1e-6: float32 sums in another order; the
    router's top-k sees the same float32 logits on both sides).
  * the kernels' CUDA sources run on the host (g++ and the stand-in
    runtime in ``tests/cuda_host``, float32) against the plain versions:
    1e-6 relative (the same float32 operations; ``expf`` against torch's
    ``sigmoid``).
  * the tensor-core route's bf16 kernels run on the host (g++ with
    ``tests/cuda_host/sm90``'s wgmma emulation) against the plain
    versions: ``BWD_TOL``'s bf16 1e-2 (float32 sums of bf16 products,
    the saved pre-activation, dgu and h rounded to bf16 once each, as the
    card's route rounds them); the forward's saved pre-activation against
    the float32 up product: its largest error at most 2^-8 of its largest
    value (half a bf16 ulp: one rounding of float32 sums).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch.ref import grouped_expert_ff_ref
from repro.models import moe as RM
from repro.models.blueprint import init_params as ref_init_params
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.moe_dispatch import moe_combine as MC
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
from repro_torch.kernels.moe_dispatch import moe_dispatch_bwd as MB
from repro_torch.kernels.rmsnorm.rmsnorm import VEC16
from repro_torch.models import moe as PM
from moe_combine_before import CombineBefore, moe_ff_and_grads

HOST_CUDA = Path(__file__).parent / "cuda_host"
HOST_SM90 = HOST_CUDA / "sm90"
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
GRAD_TOL = 2e-2
HOST_TOL = 1e-6
E, C, D, F_ = 4, 8, 64, 32
COUNTS = [8, 3, 0, 5]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ff_inputs(seed, dtype=torch.float32, E=E, C=C, d=D, f=F_):
    """x, wi, wo, dy as the layer sees them: unit-RMS rows, weights over
    the square root of the fan-in."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((E, C, d)),
            rng.standard_normal((E, d, 2 * f)) / np.sqrt(d),
            rng.standard_normal((E, f, d)) / np.sqrt(f),
            rng.standard_normal((E, C, d))]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]


def _live(counts, E, C):
    return (np.arange(C)[None, :] < np.asarray(counts)[:, None])[..., None]


# --------------------------------------------------------------------------
# the expert FF's backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_counts", [False, True])
def test_bwd_plain_matches_jax_vjp(dtype, with_counts):
    """(dx, dwi, dwo) against jax.vjp of the reference's oracle, x's rows
    at or past ``counts`` zeroed on the reference's side (the forward
    takes them as zero rows), so they get a zero dx."""
    x, wi, wo, dy = _ff_inputs(0, dtype)
    counts = torch.tensor(COUNTS, dtype=torch.int32) if with_counts else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj, wij, woj, dyj = (jnp.asarray(t.float().numpy(), jdt)
                         for t in (x, wi, wo, dy))
    mask = (jnp.asarray(_live(COUNTS, E, C), jdt) if with_counts
            else jnp.ones((E, C, 1), jdt))
    _, vjp = jax.vjp(lambda a, b, c: grouped_expert_ff_ref(a * mask, b, c),
                     xj, wij, woj)
    want = vjp(dyj)
    got = MB.grouped_expert_ff_bwd_plain(x, wi, wo, dy, counts)
    for name, g, w in zip(("dx", "dwi", "dwo"), got, want):
        assert g.dtype == dtype
        assert _rel(g.float().numpy(), w) <= BWD_TOL[dtype], name
    if with_counts:
        assert not got[0][2].any() and not got[0][1, 3:].any()


@pytest.mark.parametrize("with_counts", [False, True])
def test_bwd_plain_matches_autograd_of_the_plain_forward(with_counts):
    x, wi, wo, dy = _ff_inputs(1)
    counts = torch.tensor(COUNTS, dtype=torch.int32) if with_counts else None
    leaves = [t.clone().requires_grad_() for t in (x, wi, wo)]
    MD.grouped_expert_ff_plain(*leaves, counts).backward(dy)
    got = MB.grouped_expert_ff_bwd_plain(x, wi, wo, dy, counts)
    for g, leaf in zip(got, leaves):
        assert _rel(g, leaf.grad) <= BWD_TOL[torch.float32]


def test_swiglu_bwd_plain_matches_autograd():
    """dgu and h of the SwiGLU pass against torch autograd of silu(g) * u,
    with the rows past counts zero."""
    rng = np.random.default_rng(3)
    gu = torch.from_numpy(rng.standard_normal((E, C, 2 * F_))
                          .astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((E, C, F_)).astype(np.float32))
    counts = torch.tensor(COUNTS, dtype=torch.int32)
    leaf = gu.clone().requires_grad_()
    h = torch.nn.functional.silu(leaf[..., :F_]) * leaf[..., F_:]
    live = torch.from_numpy(_live(COUNTS, E, C))
    (h * live).backward(dh)
    dgu, h_got = MB.swiglu_bwd_plain(gu, dh, counts)
    assert _rel(dgu, leaf.grad) <= 1e-6
    assert _rel(h_got, h.detach() * live) <= 1e-6


def test_function_on_cpu_takes_the_plain_versions():
    """The Function's gradient on CPU tensors is ``grouped_expert_ff_bwd``'s
    plain one, bit for bit."""
    x, wi, wo, dy = _ff_inputs(4)
    counts = torch.tensor(COUNTS, dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (x, wi, wo)]
    y = MB.GroupedExpertFF.apply(*leaves, counts, True)
    assert torch.equal(y, MD.grouped_expert_ff_plain(x, wi, wo, counts))
    y.backward(dy)
    for g, leaf in zip(MB.grouped_expert_ff_bwd_plain(x, wi, wo, dy, counts),
                       leaves):
        assert torch.equal(leaf.grad, g)


# --------------------------------------------------------------------------
# the layer: dispatch, the gather combine, moe_ff's gradients
# --------------------------------------------------------------------------

def _layer(seed, T=24, d=32, n_exp=4, f=16, k=2):
    rng = np.random.default_rng(seed)
    ref_p = ref_init_params(RM.moe_bp(d, n_exp, f), jax.random.PRNGKey(seed))
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), ref_p)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu",
                             PM.moe_bp(d, n_exp, f))
    p = {key: v.float() for key, v in p.items()}
    x = rng.standard_normal((2, T // 2, d)).astype(np.float32)
    return ref_p, p, x, dict(n_experts=n_exp, top_k=k)


@pytest.mark.parametrize("T,k,cf", [(24, 2, 1.25), (40, 3, 1.0),
                                    (16, 2, 8.0)])
def test_dispatch_slots_invert_the_table(T, k, cf):
    """Each kept (token, gate rank) names the slot whose table entry is
    its token; every filled slot is named once; a dropped one names E*C."""
    ref_p, p, x, kw = _layer(5, T=T, k=k)
    xt = torch.from_numpy(x).reshape(T, -1)
    _, gv, gi = PM.route(p, xt, k)
    n_exp = kw["n_experts"]
    Cap = PM.capacity(T, k, n_exp, cf)
    table, wtable, slots = PM.dispatch(gi, gv, T, n_exp, Cap)
    assert slots.dtype == torch.int32 and slots.shape == (T, k)
    kept = slots < n_exp * Cap
    tok = torch.arange(T)[:, None].expand(T, k)
    assert torch.equal(table[slots[kept].long()], tok[kept])
    assert torch.equal(wtable[slots[kept].long()], gv[kept])
    assert sorted(slots[kept].tolist()) == \
        torch.nonzero(table != T)[:, 0].tolist()
    assert torch.equal(slots[~kept], torch.full_like(slots[~kept],
                                                     n_exp * Cap))


def test_gather_combine_equals_the_scatter_add():
    """The gather sums the same terms as the reference's scatter-add
    (``index_add_`` over the table), in gate-rank order: equal within
    float32 rounding; ``dropped_share`` is the share of the slots' inverse
    that names no slot."""
    ref_p, p, x, kw = _layer(6, T=40, k=3)
    xt = torch.from_numpy(x).reshape(40, -1)
    _, gv, gi = PM.route(p, xt, 3)
    Cap = PM.capacity(40, 3, 4, 1.0)
    table, wtable, slots = PM.dispatch(gi, gv, 40, 4, Cap)
    yw = torch.randn(4 * Cap, xt.shape[1]) * wtable[:, None]
    want = torch.zeros(41, xt.shape[1]).index_add_(0, table, yw)[:40]
    got = MC.gather_sum(yw, slots)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    dropped = float((slots == 4 * Cap).float().mean())
    assert dropped > 0
    assert PM.dropped_share(p, torch.from_numpy(x), capacity_factor=1.0,
                            **kw) == pytest.approx(dropped)


@pytest.mark.parametrize("seed,cf", [(7, 1.25), (8, 1.0), (9, 8.0)])
def test_moe_ff_grads_match_jax_grad(seed, cf):
    """Every leaf's gradient and x's through ``moe_ff`` (the Functions of
    the dispatch, expert FF and combine, their plain versions on the CPU)
    against jax.grad of the reference's ``moe_ff``, in float32, with
    capacity drops (cf 1.0, 1.25) and without (8.0); the loss weighs the
    output and the aux loss."""
    ref_p, p, x, kw = _layer(seed)
    w = np.random.default_rng(seed + 50).standard_normal(x.shape).astype(
        np.float32)

    def ref_loss(q, a):
        out, aux = RM.moe_ff(q, a, capacity_factor=cf, **kw)
        return (out * w).sum() + 0.5 * aux

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref_p,
                                                        jnp.asarray(x))
    ps = {key: v.detach().requires_grad_() for key, v in p.items()}
    xs = torch.from_numpy(x).requires_grad_()
    out, aux = PM.moe_ff(ps, xs, capacity_factor=cf, **kw)
    want_out, want_aux = RM.moe_ff(ref_p, jnp.asarray(x), capacity_factor=cf,
                                   **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    ((out * torch.from_numpy(w)).sum() + 0.5 * aux).backward()
    got = {key: v.grad for key, v in ps.items()}
    got["x"], want_p["x"] = xs.grad, want_x
    for key, want in want_p.items():
        want = np.asarray(want, np.float32)
        err = (np.linalg.norm(got[key].numpy() - want)
               / np.linalg.norm(want))
        assert err <= GRAD_TOL, (key, err)


def test_moe_ff_routes_its_gradient_through_the_functions(monkeypatch):
    """The layer calls GroupedExpertFF, whose forward is the forward
    wrapper, with or without grad; under grad gather_sum runs twice (the
    combine forward, the dispatch's backward), without it once."""
    _, p, x, kw = _layer(10)
    calls = []
    for mod, name in ((PM, "gather_sum"), (MD, "grouped_expert_ff")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name:
                            calls.append(_n) or _o(*a))
    apply = MB.GroupedExpertFF.apply
    monkeypatch.setattr(MB.GroupedExpertFF, "apply",
                        lambda *a: calls.append("Function") or apply(*a))
    with torch.no_grad():
        PM.moe_ff(p, torch.from_numpy(x), **kw)
    assert calls == ["Function", "grouped_expert_ff", "gather_sum"]
    calls.clear()
    ps = {key: v.detach().requires_grad_() for key, v in p.items()}
    out, _ = PM.moe_ff(ps, torch.from_numpy(x).requires_grad_(), **kw)
    out.sum().backward()
    assert calls == ["Function", "grouped_expert_ff", "gather_sum",
                     "gather_sum"]


@pytest.mark.parametrize("cf", [1.0, 8.0])      # with drops; without
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_combine_equals_the_composition_it_replaces(monkeypatch, dtype, cf):
    """``moe_ff``'s output and the gradients of x, of every leaf and of
    the gate weights, with the weights and the casts inside the gather,
    are bit for bit those of the product, float32 gather and cast it
    replaces."""
    _, p, x, kw = _layer(11, T=40, k=3)
    got = moe_ff_and_grads(p, x, dtype, cf, kw)
    # the gate weights' gradient: the Function alone at this layer's table
    xt = torch.from_numpy(x).reshape(40, -1)
    _, gv, gi = PM.route(p, xt, 3)
    Cap = PM.capacity(40, 3, 4, cf)
    table, wtable, slots = PM.dispatch(gi, gv, 40, 4, Cap)
    assert (cf == 1.0) == bool((slots == 4 * Cap).any())
    y = torch.randn(4 * Cap, xt.shape[1]).to(dtype)
    dout = torch.randn(40, xt.shape[1]).to(dtype)

    def combine(fn):
        yl, wl = y.clone().requires_grad_(), wtable.clone().requires_grad_()
        out = fn(yl, wl, table, slots, dtype)
        out.backward(dout)
        return out.detach(), yl.grad, wl.grad

    c_got = combine(PM._Combine.apply)
    monkeypatch.setattr(PM, "_Combine", CombineBefore)
    want = moe_ff_and_grads(p, x, dtype, cf, kw)
    c_want = combine(CombineBefore.apply)
    assert got[0].dtype == dtype and torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for key, g in got[2].items():
        assert g is not None and torch.equal(g, want[2][key]), key
    for name, g, w in zip(("out", "dy", "dw"), c_got, c_want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_gather_sum_plain_weights_and_out_dtype(out_dtype):
    """bf16 src with weights: the float32 products summed in gate-rank
    order, stored in float32 or cast once to bf16, are the bits of the
    product over every slot, the float32 gather and the cast."""
    g = torch.Generator().manual_seed(4)
    M, T, k, d = 30, 11, 4, 24
    src = torch.randn(M, d, generator=g).bfloat16()
    w = torch.rand(M, generator=g)
    slots = torch.randint(0, M + 6, (T, k), generator=g, dtype=torch.int32)
    got = MC.gather_sum_plain(src, slots, w, out_dtype)
    want = MC.gather_sum_plain(src.float() * w[:, None], slots)
    assert got.dtype == (out_dtype or torch.bfloat16)
    assert torch.equal(got, want.to(got.dtype))
    assert torch.equal(MC.gather_sum(src, slots, w, out_dtype), got)
    with pytest.raises(TypeError):
        MC.gather_sum_plain(src, slots, w, torch.float16)
    with pytest.raises(ValueError):
        MC.gather_sum_plain(src, slots, w[:-1])


# --------------------------------------------------------------------------
# the CUDA sources, run on the host: g++ with the stand-in runtime in
# tests/cuda_host (one std::thread per CUDA thread), float32 only
# --------------------------------------------------------------------------

def _host_build(tmp_path_factory, src: Path, name: str, tc: bool = False):
    """``src`` built with g++ against the stand-in runtime; ``tc``: with
    ``-D__CUDACC__`` and the emulated ``sm90.cuh`` (the bf16 and
    tensor-core code)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    so = tmp_path_factory.mktemp(name) / f"{name}.so"
    flags = ["-D__CUDACC__", f"-I{HOST_SM90}"] if tc else []
    p = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *flags,
         f"-I{HOST_CUDA}", f"-I{VEC16.parent}", "-x", "c++", "-o", str(so),
         str(src)], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def swiglu_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, MB.KERNEL.cu, "moe_dispatch_bwd")
    lib.swiglu_bwd_f32.argtypes = MB.KERNEL.argtypes["swiglu_bwd_f32"]
    return lib


@pytest.fixture(scope="module")
def bwd_tc_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, MB.KERNEL.cu, "moe_bwd_tc", tc=True)
    lib.moe_ff_bwd_bf16_tc.argtypes = MB.KERNEL.argtypes["moe_ff_bwd_bf16_tc"]
    return lib


@pytest.fixture(scope="module")
def fwd_tc_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, MD.KERNEL.cu, "moe_fwd_tc", tc=True)
    lib.moe_ff_bf16_tc.argtypes = MD.KERNEL.argtypes["moe_ff_bf16_tc"]
    return lib


@pytest.fixture(scope="module")
def combine_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, MC.KERNEL.cu, "moe_combine")
    for name in ("gather_sum_f32", "gather_sum_w_f32"):
        getattr(lib, name).argtypes = MC.KERNEL.argtypes[name]
    return lib


@pytest.fixture(scope="module")
def combine_tc_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, MC.KERNEL.cu, "moe_combine_tc",
                      tc=True)
    for name in ("gather_sum_bf16", "gather_sum_w_bf16",
                 "gather_sum_w_bf16_f32"):
        getattr(lib, name).argtypes = MC.KERNEL.argtypes[name]
    return lib


@pytest.mark.parametrize("f", [32, 300, 7])    # vectors; past a CTA; scalar
@pytest.mark.parametrize("with_counts", [False, True])
def test_swiglu_source_matches_plain_on_host(f, with_counts, swiglu_lib):
    rng = np.random.default_rng(f)
    gu = torch.from_numpy(rng.standard_normal((E, C, 2 * f))
                          .astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((E, C, f)).astype(np.float32))
    counts = torch.tensor(COUNTS, dtype=torch.int32) if with_counts else None
    dgu = torch.full_like(gu, float("nan"))
    h = torch.full_like(dh, float("nan"))
    assert swiglu_lib.swiglu_bwd_f32(
        gu.data_ptr(), dh.data_ptr(),
        None if counts is None else counts.data_ptr(), dgu.data_ptr(),
        h.data_ptr(), E, C, f, None) == 0
    want = MB.swiglu_bwd_plain(gu, dh, counts)
    assert _rel(dgu, want[0]) <= HOST_TOL and _rel(h, want[1]) <= HOST_TOL


# --------------------------------------------------------------------------
# the tensor-core route run on the host: the forward's saved
# pre-activation and the three backward kernels (moe_dh_tc, moe_dx_tc,
# moe_dw_tc), built with g++ against tests/cuda_host/sm90, whose wgmma
# reads its operands through the descriptors and the 128-byte swizzle
# --------------------------------------------------------------------------

#: (shape (E, C, d, f), counts): C past one 128-row block and not a
#: multiple of it, f and 2f not multiples of the 256-column tile; counts
#: none, all empty, a mix (empty, one past the first block, partial), all
#: full; a second shape with d past one tile of 256 and 128 rows
TC_CASES = [((3, 130, 64, 136), None), ((3, 130, 64, 136), [0, 0, 0]),
            ((3, 130, 64, 136), [0, 129, 57]),
            ((3, 130, 64, 136), [130, 130, 130]),
            ((2, 40, 264, 72), [17, 40])]


def _tc_inputs(shape, counts, seed):
    x, wi, wo, dy = _ff_inputs(seed, torch.bfloat16, *shape)
    c = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    return x, wi, wo, dy, c


def _host_fwd_gu(lib, x, wi, wo, counts):
    """The forward tensor-core entry on the host with a gu output filled
    with NaN first: (y, gu)."""
    E, C, d = x.shape
    f = wo.shape[1]
    scratch = MD.tc_scratch(E, C, d, f, "cpu")
    gu = torch.full((E, C, 2 * f), float("nan"), dtype=torch.bfloat16)
    y = torch.empty_like(x)
    assert lib.moe_ff_bf16_tc(
        x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
        None if counts is None else counts.data_ptr(),
        *(t.data_ptr() for t in scratch), gu.data_ptr(), y.data_ptr(),
        E, C, d, f, None) == 0
    return y, gu


def _host_bwd_tc(lib, x, wi, wo, dy, counts, gu):
    """(dx, dwi, dwo) of the backward tensor-core entry on the host, the
    outputs and the scratch filled with NaN first."""
    E, C, d = x.shape
    f = wo.shape[1]
    nan = float("nan")
    dgu = torch.full((E, C, 2 * f), nan, dtype=torch.bfloat16)
    h = torch.full((E, C, f), nan, dtype=torch.bfloat16)
    outs = [torch.full_like(t, nan) for t in (x, wi, wo)]
    assert lib.moe_ff_bwd_bf16_tc(
        dy.data_ptr(), x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
        gu.data_ptr(), None if counts is None else counts.data_ptr(),
        dgu.data_ptr(), h.data_ptr(), *(t.data_ptr() for t in outs),
        E, C, d, f, None) == 0
    return outs


@pytest.mark.parametrize("shape,counts", TC_CASES)
def test_forward_keeps_the_preactivation_on_host(shape, counts, fwd_tc_lib):
    """moe_up_tc's gu output: the gate and up products of the filled rows
    in bf16, the float32 x @ wi rounded once (2^-8 of the largest value);
    the rows past the count not written (still NaN); y as without gu (the
    same bits)."""
    x, wi, wo, _, c = _tc_inputs(shape, counts, 40)
    y, gu = _host_fwd_gu(fwd_tc_lib, x, wi, wo, c)
    E, C = shape[:2]
    filled = torch.ones(E, C, dtype=torch.bool) if c is None else \
        torch.from_numpy(_live(counts, E, C)[..., 0])
    want = torch.bmm(x.float(), wi.float())
    got = gu.float()
    assert torch.isnan(got[~filled]).all()
    if filled.any():
        assert _rel(got[filled], want[filled]) <= 2.0**-8
    scratch = MD.tc_scratch(E, C, shape[2], shape[3], "cpu")
    y0 = torch.empty_like(x)
    assert fwd_tc_lib.moe_ff_bf16_tc(
        x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
        None if c is None else c.data_ptr(),
        *(t.data_ptr() for t in scratch), None, y0.data_ptr(),
        E, C, shape[2], shape[3], None) == 0
    assert torch.equal(y, y0)


@pytest.mark.parametrize("shape,counts", TC_CASES)
def test_tensor_core_bwd_source_matches_plain_on_host(shape, counts,
                                                      bwd_tc_lib):
    """dx, dwi and dwo of the three wgmma kernels from the saved
    pre-activation (the plain up product in bf16), against the plain
    closed form, x's rows past the count not zero here: dx is exactly
    zero there, and an expert with count 0 gets exactly zero weight
    gradients; every output element written."""
    x, wi, wo, dy, c = _tc_inputs(shape, counts, 41)
    gu = MD.up_product_plain(x, wi, c)
    got = _host_bwd_tc(bwd_tc_lib, x, wi, wo, dy, c, gu)
    want = MB.grouped_expert_ff_bwd_plain(x, wi, wo, dy, c)
    for name, g, w in zip(("dx", "dwi", "dwo"), got, want):
        assert not torch.isnan(g.float()).any(), name
        assert _rel(g.float(), w.float()) <= BWD_TOL[torch.bfloat16], name
    if c is not None:
        E, C = shape[:2]
        live = torch.from_numpy(_live(counts, E, C)[..., 0])
        assert (got[0][~live] == 0).all()
        for e in range(E):
            if counts[e] == 0:
                assert not got[1][e].any() and not got[2][e].any()


def test_tensor_core_bwd_refuses_shapes_it_does_not_take(bwd_tc_lib):
    """C = 1 and f not a multiple of 8: the entry returns an error and
    launches nothing (route() sends those to the CUDA cores)."""
    for shape in ((2, 1, 64, 32), (2, 8, 64, 12)):
        x, wi, wo, dy, _ = _tc_inputs(shape, None, 42)
        E, C, d, f = shape
        gu = torch.zeros(E, C, 2 * f, dtype=torch.bfloat16)
        scratch = [torch.zeros(E, C, 2 * f, dtype=torch.bfloat16),
                   torch.zeros(E, C, f, dtype=torch.bfloat16),
                   torch.zeros_like(x), torch.zeros_like(wi),
                   torch.zeros_like(wo)]
        assert bwd_tc_lib.moe_ff_bwd_bf16_tc(
            dy.data_ptr(), x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
            gu.data_ptr(), None, *(t.data_ptr() for t in scratch), E, C, d,
            f, None) != 0
        assert not scratch[2].any()


def test_function_with_kept_preactivation_matches_the_recompute():
    """The Function's route logic on the CPU: the plain forward with a gu
    output fills it with the plain up product (rows past the count
    zero), and ``route`` sends bf16 at C > 1 with d and f multiples of 8
    to the tensor cores, everything else to the CUDA cores."""
    x, wi, wo, _, c = _tc_inputs((3, 130, 64, 136), [0, 129, 57], 43)
    gu = torch.full((3, 130, 272), float("nan"), dtype=torch.bfloat16)
    y = MD.grouped_expert_ff(x, wi, wo, c, gu)
    assert torch.equal(y, MD.grouped_expert_ff_plain(x, wi, wo, c))
    assert torch.equal(gu, MD.up_product_plain(x, wi, c))
    assert not gu[0].any() and not gu[2, 57:].any()
    assert MB.route(torch.bfloat16, 1280, 2048, 1024) == "tensor_cores"
    assert MB.route(torch.bfloat16, 1, 2048, 1024) == "cuda_cores"
    assert MB.route(torch.bfloat16, 8, 64, 12) == "cuda_cores"
    assert MB.route(torch.float32, 1280, 2048, 1024) == "cuda_cores"


@pytest.mark.parametrize("d", [64, 600, 13])   # vectors; past a CTA; scalar
def test_combine_source_matches_plain_on_host(d, combine_lib):
    """Slots past M (dropped) and repeated ones among them, k = 3."""
    rng = np.random.default_rng(d)
    M, T, k = 20, 9, 3
    src = torch.from_numpy(rng.standard_normal((M, d)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, M + 3, (T, k))
                             .astype(np.int32))
    out = torch.full((T, d), float("nan"))
    assert combine_lib.gather_sum_f32(src.data_ptr(), slots.data_ptr(),
                                      out.data_ptr(), T, k, M, d, None) == 0
    assert torch.equal(out, MC.gather_sum_plain(src, slots))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("d", [64, 13])        # vectors; scalar
def test_combine_weighted_source_matches_plain_on_host(d, weighted,
                                                       combine_lib):
    """The weighted entry, k = 10 (two chunks of slot loads), slots past
    M and repeated ones among them: bit for bit the plain version with
    the weights; without them (a null pointer), the unweighted sums."""
    rng = np.random.default_rng(d + 1)
    M, T, k = 20, 9, 10
    src = torch.from_numpy(rng.standard_normal((M, d)).astype(np.float32))
    w = torch.from_numpy(rng.random(M).astype(np.float32))
    slots = torch.from_numpy(rng.integers(-2, M + 3, (T, k))
                             .astype(np.int32))
    out = torch.full((T, d), float("nan"))
    assert combine_lib.gather_sum_w_f32(
        src.data_ptr(), slots.data_ptr(), w.data_ptr() if weighted else None,
        out.data_ptr(), T, k, M, d, None) == 0
    want = MC.gather_sum_plain(src, slots, w if weighted else None)
    assert torch.equal(out, want)


@pytest.mark.parametrize("entry", ["gather_sum_w_bf16",
                                   "gather_sum_w_bf16_f32",
                                   "gather_sum_bf16"])
@pytest.mark.parametrize("d", [2048, 100])      # vectors; scalar
def test_combine_bf16_source_matches_plain_on_host(d, entry, combine_tc_lib):
    """The bf16 entries (``-D__CUDACC__``, the emulated bf16 type), k = 8
    with dropped and negative slots: bit for bit the plain version, the
    weighted ones also the float32 product, gather and cast they
    replace."""
    g = torch.Generator().manual_seed(d)
    M, T, k = 40, 5, 8
    src = torch.randn(M, d, generator=g).bfloat16()
    w = torch.rand(M, generator=g)
    slots = torch.randint(-3, M + 8, (T, k), generator=g, dtype=torch.int32)
    od = torch.float32 if entry.endswith("_f32") else torch.bfloat16
    out = torch.full((T, d), float("nan"), dtype=od)
    fn = getattr(combine_tc_lib, entry)
    if entry == "gather_sum_bf16":
        assert fn(src.data_ptr(), slots.data_ptr(), out.data_ptr(), T, k, M,
                  d, None) == 0
        assert torch.equal(out, MC.gather_sum_plain(src, slots))
        return
    assert fn(src.data_ptr(), slots.data_ptr(), w.data_ptr(), out.data_ptr(),
              T, k, M, d, None) == 0
    assert torch.equal(out, MC.gather_sum_plain(src, slots, w, od))
    assert torch.equal(out, MC.gather_sum_plain(src.float() * w[:, None],
                                                slots).to(od))


def test_combine_source_refuses_k_past_its_limit(combine_lib):
    src = torch.zeros(4, 8)
    slots = torch.zeros(2, MC.MAX_K + 1, dtype=torch.int32)
    out = torch.zeros(2, 8)
    assert combine_lib.gather_sum_f32(src.data_ptr(), slots.data_ptr(),
                                      out.data_ptr(), 2, MC.MAX_K + 1, 4, 8,
                                      None) != 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_global_norm_is_the_whole_leaf_sum(dtype):
    """ROADMAP C18: the optimizer's global norm, a norm of the leaves'
    float32 norms (no float32 copy of a bf16 leaf on the card: olmoe's
    stacked expert weights are 4.3 B elements), is the sum of every
    leaf's squares whole and the reference's ``global_norm`` within
    float32 rounding."""
    from repro.train.optimizer import global_norm as ref_global_norm
    from repro_torch.train import optimizer as O
    rng = np.random.default_rng(11)
    arrays = {"a": rng.standard_normal((23,)).astype(np.float32),
              "b": 3 * rng.standard_normal((3, 4, 5)).astype(np.float32)}
    tree = {k: torch.from_numpy(v).to(dtype) for k, v in arrays.items()}
    want = float(torch.sqrt(sum(torch.sum(torch.square(t.float()))
                                for t in tree.values())))
    got = O.global_norm(tree)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-6)
    ref = ref_global_norm({k: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for k, t in tree.items()})
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
