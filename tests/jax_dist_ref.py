"""The JAX package's side of ``tests/test_torch_distributed.py``, run in a
subprocess with 4 host devices: the reference's ``make_pipelined_apply``
on the test's tanh layers, and for the smoke granite with the test's
params and tokens: its ``build_train_step`` on a (2, 2) host mesh (the
loss and grad norm), each leaf's gradient of its loss under that mesh's
shardings, and its ``jit_prefill_step`` and a few ``jit_decode_step``
steps on the meshes (2, 2) and (1, 4). On the (2, 2) mesh, with the
test's params for them (routers zeroed): jamba's smoke loss from
``build_train_step`` (in a second process); in float32 (``float32_lm``)
its prefill of 32 tokens (a multiple of its ``ssm_chunk``: ROADMAP C10)
and 6 decode steps, and xlstm's smoke 6 decode steps (its recurrence;
its chunked prefill is ROADMAP C14's).

    python tests/jax_dist_ref.py WORKDIR   (writes WORKDIR/jax_ref.npz)
    python tests/jax_dist_ref.py WORKDIR jamba_train
        (jamba's train step alone, the slowest to compile, beside the
        rest: writes WORKDIR/jax_ref_jamba_train.npz)
"""
import contextlib
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.distributed.pipeline import make_pipelined_apply  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models.blueprint import is_leaf  # noqa: E402
from repro.train.train_step import (StepConfig, build_train_step,  # noqa
                                    jit_decode_step, jit_prefill_step,
                                    param_sharding_tree)
from repro.train.optimizer import AdamWConfig, init_opt_state  # noqa


def auto_mesh(shape, names):
    """A mesh whose axes are all ``Auto``, as the reference's sharded steps
    were written for (newer JAX makes ``Explicit`` axes by default, under
    which the embedding's gather of a sharded table is refused)."""
    return jax.make_mesh(shape, names, axis_types=(
        jax.sharding.AxisType.Auto,) * len(shape))


@contextlib.contextmanager
def float32_lm():
    """The reference's LM in float32 while inside: its embedding's rows,
    which ``repro.models.transformer`` casts to ``jnp.bfloat16`` by name,
    stay float32 there, so that every layer computes in its input's dtype
    from float32 params and caches. A test's patch, the counterpart of
    ``torch_dist_worker.float32_lm``: it holds the sharded port to the
    reference where bf16 noise on the random smoke models (ROADMAP C15)
    would hide it."""
    import repro.models.transformer as T

    class Names:
        def __getattr__(self, name):
            return jnp.float32 if name == "bfloat16" else getattr(jnp, name)
    saved, T.jnp = T.jnp, Names()
    try:
        yield
    finally:
        T.jnp = saved


def jamba_train(workdir: str) -> None:
    model = get_model(get_config("jamba-1.5-large-398b", smoke=True))
    _, params = load(workdir, model, "params_jamba.npz")
    tokens = jnp.asarray(np.load(os.path.join(workdir, "batch.npz"))
                         ["tokens"])
    mesh = auto_mesh((2, 2), ("data", "model"))
    oc = AdamWConfig(lr=1e-3)
    step = jax.jit(build_train_step(model, mesh,
                                    StepConfig(remat=True, opt=oc)))
    with mesh:
        _, _, met = step(params, init_opt_state(params, oc),
                         {"tokens": tokens})
    np.savez(os.path.join(workdir, "jax_ref_jamba_train.npz"),
             jamba_loss=np.float64(met["loss"]))


def main(workdir: str) -> None:
    g = np.load(os.path.join(workdir, "gpipe.npz"))
    Ws, xs = jnp.asarray(g["Ws"]), jnp.asarray(g["xs"])
    L, d = Ws.shape[0], Ws.shape[1]
    mesh = jax.make_mesh((4,), ("pipe",))

    def layer_fn(stage_params, x):
        def one(x, w):
            return jnp.tanh(x @ w), None
        y, _ = jax.lax.scan(one, x, stage_params)
        return y
    piped = make_pipelined_apply(mesh, layer_fn, xs.shape[0])
    with mesh:
        ys = piped(Ws.reshape(4, L // 4, d, d), xs)

    model = get_model(get_config("granite-3-2b", smoke=True))
    paths, params = load(workdir, model, "params.npz")
    b = np.load(os.path.join(workdir, "batch.npz"))
    tokens = jnp.asarray(b["tokens"])
    tmesh = auto_mesh((2, 2), ("data", "model"))
    oc = AdamWConfig(lr=1e-3)
    step = jax.jit(build_train_step(model, tmesh,
                                    StepConfig(remat=True, opt=oc)))
    out = {"ys": np.asarray(ys)}
    with tmesh:
        _, _, met = step(params, init_opt_state(params, oc),
                         {"tokens": tokens})
        grads = jax.jit(jax.grad(lambda p, t: model.loss_fn(
            p, {"tokens": t}, remat=True)))(
            jax.device_put(params, param_sharding_tree(model, tmesh)),
            tokens)
    out.update(loss=np.float64(met["loss"]),
               grad_norm=np.float64(met["grad_norm"]))
    for (p, _), g in zip(paths, jax.tree.leaves(grads)):
        out["grad__" + key(p)] = np.asarray(g, np.float32)

    pre_s, dec_len, steps = (int(b[k]) for k in ("pre_s", "dec_len",
                                                  "dec_steps"))
    B = tokens.shape[0]
    for shape in ((2, 2), (1, 4)):
        mesh = auto_mesh(shape, ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        pre, _ = jit_prefill_step(model, mesh, "prefill_32k")
        dec, _ = jit_decode_step(model, mesh, "decode_32k")
        with mesh:
            out["prefill_" + tag] = np.asarray(
                pre(params, {"tokens": tokens[:, :pre_s]}), np.float32)
            cache = model.init_cache(B, dec_len)
            logits = []
            for t in range(steps):
                lo, cache = dec(params, {
                    "tokens": tokens[:, t:t + 1],
                    "pos": jnp.full((B,), t, jnp.int32), "cache": cache})
                logits.append(np.asarray(lo, np.float32))
            out["decode_" + tag] = np.stack(logits)

    mesh = auto_mesh((2, 2), ("data", "model"))
    for arch, name in (("jamba-1.5-large-398b", "jamba"),
                       ("xlstm-1.3b", "xlstm")):
        model = get_model(get_config(arch, smoke=True))
        _, params = load(workdir, model, f"params_{name}.npz", jnp.float32)
        with float32_lm(), mesh:
            dec, _ = jit_decode_step(model, mesh, "decode_32k")
            if name == "jamba":
                pre, _ = jit_prefill_step(model, mesh, "prefill_32k")
                out["jamba_prefill"] = np.asarray(pre(params, {
                    "tokens": tokens[:, :int(b["pre_s_hybrid"])]}))
            cache = jax.tree.map(lambda t: t.astype(jnp.float32),
                                 model.init_cache(B, dec_len))
            logits = []
            for t in range(steps):
                lo, cache = dec(params, {
                    "tokens": tokens[:, t:t + 1],
                    "pos": jnp.full((B,), t, jnp.int32), "cache": cache})
                logits.append(np.asarray(lo))
            out[name + "_decode"] = np.stack(logits)
    np.savez(os.path.join(workdir, "jax_ref.npz"), **out)


def key(path) -> str:
    return "__".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)


def load(workdir: str, model, fname: str, dtype=None):
    """(the blueprint's leaves with their paths, the params) from the
    test's numpy draw in ``fname``, in each leaf's dtype or ``dtype``."""
    arrays = np.load(os.path.join(workdir, fname))
    paths, treedef = jax.tree_util.tree_flatten_with_path(
        model.blueprint(), is_leaf=is_leaf)
    return paths, jax.tree.unflatten(treedef, [
        jnp.asarray(arrays[key(p)], dtype=dtype or l.dtype)
        for p, l in paths])


if __name__ == "__main__":
    (jamba_train if sys.argv[2:] == ["jamba_train"] else main)(sys.argv[1])
