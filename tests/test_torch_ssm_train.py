"""The selective scan's gradient in the port against the JAX package's, on
the CPU: ``kernels/selective_scan/selective_scan_bwd.py`` and the mamba
block's chunked scan under autograd (``models/ssm.py``).

Inputs come from a numpy seed at small sizes (B 2, S 40 cut into chunks
of 16 with a ragged last chunk of 8, d 16, n 8 and 16) and go through
both packages. Tolerances, each with its reason:

  * ``BWD_TOL``, the largest |got - want| over the largest |want| of each
    output: float32 1e-4 (the same float32 recurrence as XLA's scan; dCm
    summed over the channels in another order).
  * ``GRAD_TOL`` = 2e-2, relative L2 a leaf (``tests/test_torch_train.py``'s):
    the mamba block's gradients against ``jax.grad`` of the reference's,
    in float32 (the point is the algorithm; the whole hybrid LM in bf16 is
    ROADMAP C15).
  * the CUDA sources run on the host (g++ and the stand-in runtime in
    ``tests/cuda_host``) against the plain version: 1e-6 relative (the
    same float32 recurrence, each segment recomputed from the forward's
    saved state; dCm summed by a warp butterfly and over the CTAs); the
    forward's saved states bit for bit (the same float32 operations in
    the same order).
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import selective_scan_ref
from repro.models import ssm as RS
from repro.models.blueprint import init_params as ref_init_params
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.selective_scan import selective_scan as SS
from repro_torch.kernels.selective_scan import selective_scan_bwd as SB
from repro_torch.models import ssm as PS

HOST_CUDA = Path(__file__).parent / "cuda_host"
BWD_TOL = 1e-4
GRAD_TOL = 2e-2
HOST_TOL = 1e-6
CHUNKS = ((0, 16), (16, 32), (32, 40))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(shape, seed):
    """dA in (0.5, 0.99), dBx and Cm at scale 0.1 (tests/test_kernels.py's
    draws), dy and the states' gradients standard normal."""
    B, S, d, n = shape
    rng = np.random.default_rng(seed)
    arrs = {"dA": rng.uniform(0.5, 0.99, (B, S, d, n)),
            "dBx": 0.1 * rng.standard_normal((B, S, d, n)),
            "Cm": 0.1 * rng.standard_normal((B, S, n)),
            "h0": rng.standard_normal((B, d, n)),
            "dy": rng.standard_normal((B, S, d)),
            "dh": rng.standard_normal((B, d, n))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in
            arrs.items()}


def _jax_scan(dA, dBx, Cm, h0):
    """The reference oracle's recurrence from a first state h0, returning
    (y, the last state): ``selective_scan_ref`` with h0 in place of its
    zeros."""
    def step(h, args):
        a, bx, c = args
        h = a * h + bx
        return h, jnp.einsum("dn,bn->bd", h, c[None])[0]

    def per_batch(a, bx, c, h):
        return jax.lax.scan(step, h, (a, bx, c))

    h_last, ys = jax.vmap(per_batch)(dA, dBx, Cm, h0)
    return ys, h_last


@pytest.mark.parametrize("n", [8, 16])
def test_bwd_plain_matches_jax_vjp(n):
    """From a zero state, no last-state gradient: jax.vjp of the
    reference's own oracle."""
    t = _inputs((2, 40, 16, n), n)
    _, vjp = jax.vjp(selective_scan_ref, *(jnp.asarray(t[k].numpy())
                                           for k in ("dA", "dBx", "Cm")))
    want = vjp(jnp.asarray(t["dy"].numpy()))
    got = SB.selective_scan_bwd_plain(t["dA"], t["dBx"], t["Cm"], None,
                                      t["dy"])
    for name, g, w in zip(("d(dA)", "d(dBx)", "dCm"), got, want):
        assert _rel(g, w) <= BWD_TOL, name
    assert got[3].shape == (2, 16, n) and got[3].dtype == torch.float32


@pytest.mark.parametrize("n", [8, 16])
def test_bwd_plain_with_states_matches_jax_vjp(n):
    """From a given first state, with a gradient on the last state: dh0
    and every input's gradient against jax.vjp of the oracle's recurrence
    carried from h0."""
    t = _inputs((2, 40, 16, n), 10 + n)
    args = [jnp.asarray(t[k].numpy()) for k in ("dA", "dBx", "Cm", "h0")]
    _, vjp = jax.vjp(_jax_scan, *args)
    want = vjp((jnp.asarray(t["dy"].numpy()), jnp.asarray(t["dh"].numpy())))
    got = SB.selective_scan_bwd_plain(t["dA"], t["dBx"], t["Cm"], t["h0"],
                                      t["dy"], t["dh"])
    for name, g, w in zip(("d(dA)", "d(dBx)", "dCm", "dh0"), got, want):
        assert _rel(g, w) <= BWD_TOL, name


@pytest.mark.parametrize("n", [8, 16])
def test_chained_chunks_match_jax_vjp_of_one_scan(n):
    """The Function chained through its state over chunks of 16, 16 and a
    ragged 8 (dh0 of one chunk is dh_last of the one before): the
    gradients of the whole sequence, against jax.vjp of the reference's
    oracle over all 40 steps at once; the caller's state is never
    written."""
    t = _inputs((2, 40, 16, n), 20 + n)
    _, vjp = jax.vjp(selective_scan_ref, *(jnp.asarray(t[k].numpy())
                                           for k in ("dA", "dBx", "Cm")))
    want = vjp(jnp.asarray(t["dy"].numpy()))
    leaves = {k: t[k].clone().requires_grad_() for k in ("dA", "dBx", "Cm")}
    h = torch.zeros(2, 16, n)
    first, ys = h, []
    for a, b in CHUNKS:
        y, h = SB.SelectiveScan.apply(*(leaves[k][:, a:b] for k in
                                        ("dA", "dBx", "Cm")), h)
        ys.append(y)
    assert not first.any()
    torch.cat(ys, 1).backward(t["dy"])
    for k, w in zip(("dA", "dBx", "Cm"), want):
        assert _rel(leaves[k].grad, w) <= BWD_TOL, k


def test_function_leaves_the_callers_state_alone():
    t = _inputs((1, 8, 16, 8), 3)
    h0 = t["h0"].clone()
    y, h_last = SB.SelectiveScan.apply(t["dA"], t["dBx"], t["Cm"], h0)
    assert torch.equal(h0, t["h0"])
    want_h = t["h0"].clone()
    assert torch.equal(y, SS.selective_scan_plain(t["dA"], t["dBx"], t["Cm"],
                                                  want_h))
    assert torch.equal(h_last, want_h)


# --------------------------------------------------------------------------
# the mamba block under autograd
# --------------------------------------------------------------------------

D, D_INNER, N, CHUNK = 64, 128, 16, 16


@pytest.fixture(scope="module")
def block():
    ref_p = ref_init_params(RS.mamba_bp(D, D_INNER, N, 4),
                            jax.random.PRNGKey(2))
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), ref_p)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu",
                             PS.mamba_bp(D, D_INNER, N, 4))
    return ref_p, {k: v.float() for k, v in p.items()}


@pytest.mark.parametrize("S", [16, 48])
def test_mamba_scan_grads_match_jax_grad(block, S):
    """S a multiple of the chunk (the reference's chunking is right there,
    ROADMAP C10): every leaf's gradient and x's through the port's
    checkpointed chunks against jax.grad of the reference's, float32."""
    ref_p, p = block
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    w = rng.standard_normal((2, S, D)).astype(np.float32)
    want_p, want_x = jax.grad(
        lambda q, a: (RS.mamba_scan_chunked(q, a, d_state=N, chunk=CHUNK)
                      * w).sum(), argnums=(0, 1))(ref_p, jnp.asarray(x))
    ps = {k: v.detach().requires_grad_() for k, v in p.items()}
    xs = torch.from_numpy(x).requires_grad_()
    (PS.mamba_scan_chunked(ps, xs, d_state=N, chunk=CHUNK)
     * torch.from_numpy(w)).sum().backward()
    got = {k: v.grad for k, v in ps.items()}
    got["x"], want_p["x"] = xs.grad, want_x
    for k, want in want_p.items():
        want = np.asarray(want, np.float32)
        err = (np.linalg.norm(got[k].numpy() - want)
               / np.linalg.norm(want))
        assert err <= GRAD_TOL, (k, err)


def test_mamba_scan_recomputes_each_chunk_in_the_backward(block,
                                                          monkeypatch):
    """Under grad each chunk is a checkpoint region: the forward scans the
    three chunks of S = 40 once each through the Function, the backward
    scans each again (its dA and dBx made anew) and runs its reverse scan
    once; the output is the no-grad path's, bit for bit."""
    _, p = block
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 40, D)).astype(np.float32))
    calls = []
    fwd, bwd = SS.selective_scan, SB.selective_scan_bwd
    monkeypatch.setattr(SS, "selective_scan", lambda dA, *a: calls.append(
        ("fwd", dA.shape[1])) or fwd(dA, *a))
    monkeypatch.setattr(SB, "selective_scan_bwd", lambda dA, *a: calls.append(
        ("bwd", dA.shape[1])) or bwd(dA, *a))
    with torch.no_grad():
        want = PS.mamba_scan_chunked(p, x, d_state=N, chunk=CHUNK)
    calls.clear()
    ps = {k: v.detach().requires_grad_() for k, v in p.items()}
    got = PS.mamba_scan_chunked(ps, x, d_state=N, chunk=CHUNK)
    assert torch.equal(got, want)
    assert calls == [("fwd", 16), ("fwd", 16), ("fwd", 8)]
    calls.clear()
    got.float().sum().backward()
    assert calls == [("fwd", 8), ("bwd", 8), ("fwd", 16), ("bwd", 16),
                     ("fwd", 16), ("bwd", 16)]


# --------------------------------------------------------------------------
# the CUDA source, run on the host: g++ with the stand-in runtime in
# tests/cuda_host (one std::thread per CUDA thread)
# --------------------------------------------------------------------------

HOST_SM90 = HOST_CUDA / "sm90"


def _host_build(tmp_path_factory, src, name, entry, argtypes, tc):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    so = tmp_path_factory.mktemp(name) / f"{name}.so"
    flags = ["-D__CUDACC__", f"-I{HOST_SM90}"] if tc else []
    p = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *flags,
         f"-I{HOST_CUDA}", "-x", "c++", "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lib = ctypes.CDLL(str(so))
    getattr(lib, entry).argtypes = argtypes
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The backward (its cp.async copies under the emulated sm90.cuh)."""
    return _host_build(tmp_path_factory, SB.KERNEL.cu, "host_ssb",
                       "selective_scan_bwd_f32",
                       SB.KERNEL.argtypes["selective_scan_bwd_f32"], True)


@pytest.fixture(scope="module")
def fwd_lib(tmp_path_factory):
    """The forward, which saves the states."""
    return _host_build(tmp_path_factory, SS.KERNEL.cu, "host_ss",
                       "selective_scan_f32",
                       SS.KERNEL.argtypes["selective_scan_f32"], False)


def _host_states(fwd_lib, t, h0):
    """The forward kernel's saved states (NaN first) from h0 (None:
    zeros), and the states of the plain forward."""
    B, S, d, n = t["dA"].shape
    states = torch.full(SS.states_shape(B, S, d, n), float("nan"))
    h = None if h0 is None else h0.clone()
    y = torch.empty(B, S, d)
    assert fwd_lib.selective_scan_f32(
        t["dA"].data_ptr(), t["dBx"].data_ptr(), t["Cm"].data_ptr(),
        None if h is None else h.data_ptr(), states.data_ptr(),
        y.data_ptr(), B, S, d, n, None) == 0
    want = torch.full_like(states, float("nan"))
    SS.selective_scan_plain(t["dA"], t["dBx"], t["Cm"],
                            None if h0 is None else h0.clone(), want)
    return states, want


def _host_run(lib, fwd_lib, t, h0, dh):
    B, S, d, n = t["dA"].shape
    outs = [torch.full_like(t["dA"], float("nan")),
            torch.full_like(t["dBx"], float("nan")),
            torch.full_like(t["Cm"], float("nan")),
            torch.full((B, d, n), float("nan"))]
    n_cb = -(-d // SB.cta_channels(n)) if n in SS.STATE_SIZES else 1
    partial = torch.full((B, n_cb, S, n), float("nan"))
    states = (_host_states(fwd_lib, t, h0)[0] if n in SS.STATE_SIZES
              else torch.zeros(SS.states_shape(B, S, d, n)))
    err = lib.selective_scan_bwd_f32(
        t["dA"].data_ptr(), t["dBx"].data_ptr(), t["Cm"].data_ptr(),
        states.data_ptr(), t["dy"].data_ptr(),
        None if dh is None else dh.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), partial.data_ptr(), outs[2].data_ptr(),
        outs[3].data_ptr(), B, S, d, n, None)
    return err, outs, SB.selective_scan_bwd_plain(
        t["dA"], t["dBx"], t["Cm"], h0, t["dy"], dh)


@pytest.mark.parametrize("shape", [
    (2, 40, 16, 8), (2, 17, 16, 16), (1, 12, 32, 4),
    (2, 9, 200, 16),      # d past one CTA and not a multiple of 32
    (1, 13, 600, 4),      # S ragged at n = 4, d past one CTA
    (2, 6, 300, 8),       # S ragged at n = 8, d past one CTA
])
@pytest.mark.parametrize("with_states", [False, True])
def test_source_matches_plain_on_host(shape, with_states, host_lib,
                                      fwd_lib):
    """From the forward kernel's saved states (a segment of STATE_EVERY
    steps; S a multiple of it or not), with h0 and dh_last or neither."""
    t = _inputs(shape, 30)
    h0, dh = (t["h0"], t["dh"]) if with_states else (None, None)
    err, got, want = _host_run(host_lib, fwd_lib, t, h0, dh)
    assert err == 0
    for name, g, w in zip(("d(dA)", "d(dBx)", "dCm", "dh0"), got, want):
        assert _rel(g, w) <= HOST_TOL, name


@pytest.mark.parametrize("which", ["h0", "dh_last"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_source_with_one_state_matches_plain_on_host(which, n, host_lib,
                                                     fwd_lib):
    """A first state without a last-state gradient, and the other way
    round, at each state size, S = 11 (ragged)."""
    t = _inputs((2, 11, 40, n), 31 + n)
    h0 = t["h0"] if which == "h0" else None
    dh = t["dh"] if which == "dh_last" else None
    err, got, want = _host_run(host_lib, fwd_lib, t, h0, dh)
    assert err == 0
    for name, g, w in zip(("d(dA)", "d(dBx)", "dCm", "dh0"), got, want):
        assert _rel(g, w) <= HOST_TOL, name


@pytest.mark.parametrize("shape", [(2, 9, 200, 16), (1, 13, 24, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_forward_states_match_plain_on_host(shape, with_h0, fwd_lib):
    """The forward kernel's states: the state entering every
    STATE_EVERY-th step, the first h0's (or zeros), equal to the plain
    forward's bit for bit."""
    t = _inputs(shape, 32)
    got, want = _host_states(fwd_lib, t, t["h0"] if with_h0 else None)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 0], t["h0"] if with_h0
                       else torch.zeros_like(t["h0"]))


def test_segment_is_the_shape_of_the_states():
    """Both scan sources take the segment from one header, whose kSeg
    is the STATE_EVERY that sizes ``states``; the two kernels' build keys
    cover it."""
    m = re.search(r"constexpr int kSeg = (\d+);", SS.SEGMENT_H.read_text())
    assert m and int(m.group(1)) == SS.STATE_EVERY
    for k in (SS.KERNEL, SB.KERNEL):
        assert SS.SEGMENT_H in k.headers
        assert '#include "scan_segment.cuh"' in k.cu.read_text()


def test_source_refuses_a_state_size_it_does_not_take(host_lib, fwd_lib):
    t = _inputs((1, 4, 8, 2), 7)
    assert _host_run(host_lib, fwd_lib, t, None, None)[0] != 0
