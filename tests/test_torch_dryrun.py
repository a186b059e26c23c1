"""The port's dry run, roofline and variants, on the CPU.

  (f) Every mixer takes a sharding context (``LM.sharded``); the
      ``seqpar`` variant sets ``seq_shard_activations`` and the hill-climb
      table has the reference's three ``seqpar`` rows; the reference's
      other dropped variants raise ``ValueError`` naming their knob.
  (g) The dry run, in a subprocess (it starts a fake world):
      ``python -m repro_torch.launch.dryrun --arch granite-3-2b --shape
      train_4k --mesh 2x4`` writes ``status: ok`` with the reference's
      keys, flops, bytes, all-gather and all-reduce bytes > 0, and
      ``long_500k`` is ``skipped`` (the reference's
      ``test_mini_dryrun_subprocess``); the roofline CLI prints its row.
      For granite's smoke config cut to 4 layers on 2x4 (data 2, model
      4), the collective bytes and counts of the train, prefill and
      decode steps equal, to the byte, those reckoned below from the
      reference's specs and the step's structure, and
      ``_depth_extrapolate``'s result equals the full count. The same for
      jamba's smoke config (2 periods of mamba, attention, dense and MoE
      layers; train with ``ssm_chunk1k``, and with ``seqpar`` as well;
      decode, also extrapolated) and xlstm's (train with
      ``xlstm_chunk512``; decode): a smoke chunk of 16 would make 256
      chunks a layer at train_4k's S, minutes of tracing. Each in a
      subprocess of its own, beside granite's.
  (h) The roofline: ``ring_factor`` as in the reference's test, and
      ``analyze`` on a hand-made record with the H100's constants.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.launch.dryrun import VARIANTS as REF_VARIANTS
from repro.models import get_model as ref_get_model
from repro.models.blueprint import is_leaf as ref_is_leaf
from repro.models.blueprint import param_specs as ref_param_specs
from repro.models.registry import dynamic_rules as ref_dynamic_rules
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parent.parent
REF_KEYS = {"arch", "shape", "mesh", "variant", "status", "n_devices",
            "mesh_shape", "n_params", "step_kind", "flops",
            "bytes_accessed", "cost_analysis", "memory_analysis",
            "collectives", "extrapolated", "lower_s", "compile_s"}
SMOKE_CUT = {"n_layers": 4}
KINDS = {"train_4k": "train", "prefill_32k": "prefill",
         "decode_32k": "decode"}


#: the recurrent smoke records: (arch, shape, variant), each's name
RECURRENT = {"jamba-train": ("jamba-1.5-large-398b", "train_4k",
                             "ssm_chunk1k"),
             "jamba-seqpar": ("jamba-1.5-large-398b", "train_4k",
                              "ssm_chunk1k+seqpar"),
             "jamba-decode": ("jamba-1.5-large-398b", "decode_32k", ""),
             "xlstm-train": ("xlstm-1.3b", "train_4k", "xlstm_chunk512"),
             "xlstm-decode": ("xlstm-1.3b", "decode_32k", "")}


def _recurrent_code(out: Path, arch: str) -> str:
    cells = [v for v in RECURRENT.values() if v[0] == arch]
    return textwrap.dedent(f"""
        from pathlib import Path
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        for arch, shape, variant in {cells!r}:
            dryrun.run_cell(arch, shape, "2x4", Path({str(out)!r}),
                            verbose=False, variant=variant,
                            cfg=get_config(arch, smoke=True),
                            extrapolate=shape == "decode_32k")
        print("DRYRUN_OK")
    """)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    code = textwrap.dedent(f"""
        import dataclasses
        from pathlib import Path
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        out = Path({str(d)!r})
        for shape in ("train_4k", "long_500k"):
            assert dryrun.main(["--arch", "granite-3-2b", "--shape", shape,
                                "--mesh", "2x4", "--out", str(out)]) == 0
        cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True),
                                  **{SMOKE_CUT!r})
        for shape in {tuple(KINDS)!r}:
            dryrun.run_cell("granite-smoke", shape, "2x4", out / "smoke",
                            verbose=False, cfg=cfg)
        # recost fills a record's missing extrapolation
        import json
        from repro_torch.launch import recost
        (out / "recost").mkdir()
        (out / "recost" / "r.json").write_text(json.dumps(
            {{"arch": "granite-3-2b", "shape": "prefill_32k", "mesh": "2x4",
              "variant": "", "status": "ok"}}))
        assert recost.main(["--artifacts", str(out / "recost")]) == 0
        print("DRYRUN_OK")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    codes = [code] + [_recurrent_code(d / "recurrent", a)
                      for a in ("jamba-1.5-large-398b", "xlstm-1.3b")]
    procs = [subprocess.Popen([sys.executable, "-c", c], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in codes]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0 and "DRYRUN_OK" in out, err[-3000:]
    return d


def _rec(d: Path, name: str) -> dict:
    return json.loads((d / name).read_text())


# --------------------------------------------------------------------------
# (g) the dry run
# --------------------------------------------------------------------------

def test_dryrun_cell_has_reference_keys_and_counts(cells):
    rec = _rec(cells, "granite-3-2b__train_4k__2x4.json")
    assert rec["status"] == "ok", rec
    assert set(rec) == REF_KEYS
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collectives"]["bytes"]["all-gather"] > 0
    assert rec["collectives"]["bytes"]["all-reduce"] > 0
    assert set(rec["collectives"]["bytes"]) == set(dryrun.col.KINDS)
    assert rec["n_devices"] == 8 and rec["mesh_shape"] == [2, 4]
    mem = rec["memory_analysis"]
    assert mem["available"] and mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    assert rec["extrapolated"]["method"] == "linear-extrapolation"
    assert rec["extrapolated"]["flops"] == rec["flops"]


def test_dryrun_long_shape_skipped(cells):
    rec = _rec(cells, "granite-3-2b__long_500k__2x4.json")
    assert rec["status"] == "skipped"


def test_roofline_cli_prints_the_row(cells):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert roofline.main(["--artifacts", str(cells), "--mesh",
                              "2x4"]) == 0
    rows = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("| granite-3-2b | train_4k")]
    assert len(rows) == 1 and "80G" in rows[0], buf.getvalue()


def test_recost_fills_extrapolation(cells):
    ex = _rec(cells / "recost", "r.json")["extrapolated"]
    assert ex["method"] == "linear-extrapolation" and ex["periods"] == 40
    assert ex["flops"] > 0 and ex["coll"]["all-gather"] > 0


def test_perf_table_marks_missing_records(tmp_path):
    from repro_torch.launch import perf_table
    buf = io.StringIO()
    with redirect_stdout(buf):
        perf_table.main(str(tmp_path), "2x4")
    out = buf.getvalue()
    assert out.count("MISSING") == sum(len(v) for _, _, v in
                                       perf_table.CELLS)


def _reckon(kind: str) -> dict:
    """The collectives of rank 0's step of granite's smoke config cut to
    4 layers on 2x4, from the reference's specs: output bytes and calls
    by kind."""
    cfg = dataclasses.replace(ref_get_config("granite-3-2b", smoke=True),
                              **SMOKE_CUT)
    import jax
    import numpy as np
    sizes = {"data": 2, "model": 4}
    rules = ref_dynamic_rules(cfg, sizes)
    bp = ref_get_model(cfg).blueprint()
    specs = ref_param_specs(bp, rules, "data")
    items = jax.tree_util.tree_flatten_with_path(bp, is_leaf=ref_is_leaf)[0]
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    P = cfg.n_layers
    bytes_ = dict.fromkeys(dryrun.col.KINDS, 0)
    calls = dict.fromkeys(dryrun.col.KINDS, 0)

    def add(k, nbytes, n=1):
        bytes_[k] += nbytes * n
        calls[k] += n
    train = kind == "train"
    for (path, l), spec in zip(items, spec_leaves):
        name = str(getattr(path[0], "key", path[0]))
        axes = [a for a in tuple(spec)]
        m = int(np.prod([sizes[a] for a in axes if a == "model"] or [1]))
        d = int(np.prod([sizes[a] for a in axes if a == "data"] or [1]))
        tp = int(np.prod(l.shape)) // m * np.dtype(l.dtype).itemsize
        if name == "stack":       # a gather a period, again under remat
            per = tp // P
            add("all-gather", per, P * (2 if train else 1))
            if train:
                add("reduce-scatter", per // d, P)
        else:                     # embed twice (tied), ln_f once
            uses = 2 if name == "embed" else 1
            add("all-gather", tp, uses)
            if train:
                add("reduce-scatter", tp // d, uses)
        if train and "model" not in axes:   # replicated on model: summed
            add("all-reduce", tp // d)
    B = {"train": 256, "prefill": 32, "decode": 128}[kind] // 2
    S = {"train": 4096, "prefill": 32768, "decode": 1}[kind]
    act = B * S * cfg.d_model * 2          # (B, S, d) bf16
    if kind == "decode":
        Hl, hd = cfg.n_heads // 4, cfg.head_dim
        # the embedding; a layer: q's heads gathered, the partial softmax
        # (max, sum, weighted V, float32), wo and the FF's wo
        add("all-reduce", act)
        add("all-gather", B * cfg.n_heads * hd * 2, P)
        add("all-reduce", B * cfg.n_heads * 4, 2 * P)
        add("all-reduce", B * cfg.n_heads * hd * 4, P)
        add("all-reduce", act, 2 * P)
        assert Hl == 1
        return {"bytes": bytes_, "counts": calls}
    # the embedding and two row-parallel products a layer; under remat
    # the recompute stops at the last saved tensor, so it repeats all
    # but the period's last all-reduce; the backward one each
    fwd = 1 + 2 * P
    add("all-reduce", act, fwd + (P if train else 0)
        + (fwd if train else 0))
    if train:
        row = B * S * 4                  # (B, S) float32
        add("all-reduce", row, 3 + 2)    # max, sum, label; 2 backwards
        add("all-reduce", 4, 3)          # NLL sum, its backward, count
        add("all-reduce", 4)             # the global grad norm
    return {"bytes": bytes_, "counts": calls}


@pytest.mark.parametrize("shape", sorted(KINDS))
def test_smoke_collectives_equal_reckoning(cells, shape):
    rec = _rec(cells / "smoke", f"granite-smoke__{shape}__2x4.json")
    assert rec["status"] == "ok"
    assert rec["collectives"] == _reckon(KINDS[shape])


@pytest.mark.parametrize("shape", sorted(KINDS))
def test_depth_extrapolation_equals_full_count(cells, shape):
    rec = _rec(cells / "smoke", f"granite-smoke__{shape}__2x4.json")
    ex = rec["extrapolated"]
    assert ex["periods"] == SMOKE_CUT["n_layers"]
    assert ex["flops"] == rec["flops"] > 0
    assert ex["bytes"] == rec["bytes_accessed"] > 0
    assert ex["coll"] == rec["collectives"]["bytes"]


def _leaf_collectives(cfg, train: bool, sizes, add) -> None:
    """The params' collectives of rank 0's step, from the reference's
    specs: each leaf with a data-sharded dim all-gathered over the fsdp
    axis where it is read (a stacked leaf once a period, again in the
    recompute under remat; a tied embedding twice) and its gradient
    reduce-scattered back (but the mLSTM's ``norm``, gathered and never
    read); each leaf's gradient all-reduced once over the axes that
    replicate it."""
    import jax
    import numpy as np
    rules = ref_dynamic_rules(cfg, sizes)
    bp = ref_get_model(cfg).blueprint()
    specs = ref_param_specs(bp, rules, "data")
    items = jax.tree_util.tree_flatten_with_path(bp, is_leaf=ref_is_leaf)[0]
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    P = cfg.n_layers // len(cfg.layer_pattern())
    for (path, l), spec in zip(items, spec_leaves):
        keys = [str(getattr(k, "key", k)) for k in path]
        axes = {a for a in tuple(spec) if a is not None}
        m = sizes["model"] if "model" in axes else 1
        d = sizes["data"] if "data" in axes else 1
        tp = int(np.prod(l.shape)) // m * np.dtype(l.dtype).itemsize
        stack = keys[0] == "stack"
        uses = P if stack else (2 if keys[0] == "embed"
                                and cfg.tie_embeddings else 1)
        per = tp // P if stack else tp
        if "data" in axes:
            add("all-gather", per, uses * (2 if train and stack else 1))
            if train and keys[-2:] != ["mlstm", "norm"]:
                add("reduce-scatter", per // d, uses)
        if train and set(sizes) - axes:
            add("all-reduce", tp // d)


def _reckon_recurrent(name: str) -> dict:
    """The collectives of rank 0's step of a ``RECURRENT`` record on 2x4
    (data 2, model 4), from the reference's specs and the step's
    structure: output bytes and calls by kind."""
    arch, shape, variant = RECURRENT[name]
    cfg = ref_get_config(arch, smoke=True)
    for v in filter(None, variant.split("+")):
        cfg = REF_VARIANTS[v](cfg)
    sizes = {"data": 2, "model": 4}
    bytes_ = dict.fromkeys(dryrun.col.KINDS, 0)
    calls = dict.fromkeys(dryrun.col.KINDS, 0)

    def add(k, nbytes, n=1):
        bytes_[k] += nbytes * n
        calls[k] += n
    train = shape == "train_4k"
    _leaf_collectives(cfg, train, sizes, add)
    P = cfg.n_layers // len(cfg.layer_pattern())
    kinds = cfg.layer_pattern()
    d, E, H, hd = cfg.d_model, cfg.moe_experts, cfg.n_heads, cfg.head_dim
    B = {"train_4k": 256, "decode_32k": 128}[shape] // 2
    S = {"train_4k": 4096, "decode_32k": 1}[shape]
    act, act32 = B * S * d * 2, B * S * d * 4   # (B, S, d) bf16, float32
    part = act // 4                             # a rank's S shard
    sp = cfg.seq_shard_activations
    # x_proj's float32 partials (B, S, dt_rank + 2N), a chunk at a time
    xproj = B * S * (max(1, d // 16) + 2 * cfg.ssm_d_state) * 4
    chunks = -(-S // cfg.ssm_chunk)
    # the row-parallel products of a period in order, (their bytes,
    # whether the residual takes them; the MoE's float32), and the
    # collectives of each pass that are no residual's
    rows, other = [], []
    for k in kinds:
        if k.mixer == "mamba":
            rows.append(act)
            other.append(("all-reduce", xproj // chunks, chunks))
        elif k.mixer == "slstm":
            rows.append(act)
            if train:       # wx, wh and b gathered whole over model
                for n in (d * 4 * d * 2, d * 4 * d * 2, 4 * d * 2):
                    other.append(("all-gather", n, 1))
        else:
            rows.append(act)
        if k.ff == "dense":
            rows.append(act)
        elif k.ff == "moe":
            rows.append(act32)
            # the whole batch's counts (2, E) and probabilities (E,)
            other += [("all-gather", 2 * E * 4, 1), ("all-reduce", E * 4, 1)]
    if not train:   # decode: one step, no residual split, no remat
        add("all-reduce", act)                  # the embedding
        for k in kinds:
            if k.mixer == "mamba":
                add("all-reduce", xproj, P)
            elif k.mixer == "mlstm":     # q, k, v and the gates gathered
                add("all-gather", B * H * hd * 2, 3 * P)
                add("all-gather", B * H * 4, 2 * P)
            elif k.mixer == "slstm":     # h gathered
                add("all-gather", B * d * 2, P)
            elif k.mixer == "attn":      # q's heads; the partial softmax
                add("all-gather", B * H * hd * 2, P)
                add("all-reduce", B * H * 4, 2 * P)
                add("all-reduce", B * H * hd * 4, P)
        for n in rows:
            add("all-reduce", n, P)
        for k, n, c in other:
            if n in (2 * E * 4, E * 4):         # the MoE's batch sums
                add(k, n, c * P)
        return {"bytes": bytes_, "counts": calls}
    # train: forward, the recompute (stopping before the period's last
    # collective, which saves nothing), the backward; a mamba chunk's
    # x_proj all-reduce again in its own region's recompute
    for k, n, c in other:
        if k == "all-reduce" and n == xproj // chunks:
            add(k, n, 4 * c * P)
        else:
            add(k, n, 2 * c * P)
            if k == "all-reduce":
                add(k, n, c * P)                # the probs' backward
            elif n != 2 * E * 4:
                add("reduce-scatter", n // 4, c * P)
    if sp:      # gathered after each norm, scattered after each product
        add("all-gather", act, 2 * 2 * len(kinds) * P)
        add("reduce-scatter", part, 2 * len(kinds) * P)   # their bwds
        for n in rows:
            add("reduce-scatter", n // 4, 2 * P)
            add("all-gather", n, P)             # their backwards
        calls["reduce-scatter"] -= P            # the period's last RS
        bytes_["reduce-scatter"] -= rows[-1] // 4 * P
        # the embedding and the final norm's gather, and their backwards
        add("reduce-scatter", part, 2)
        add("all-gather", act, 2)
    else:
        for n in rows:
            add("all-reduce", n, 3 * P)
        calls["all-reduce"] -= P                # the period's last AR
        bytes_["all-reduce"] -= rows[-1] * P
        add("all-reduce", act, 2)               # the embedding, its bwd
    row = B * S * 4                             # (B, S) float32
    add("all-reduce", row, 3 + 2)    # max, sum, label; 2 backwards
    add("all-reduce", 4, 3)          # NLL sum, its backward, count
    add("all-reduce", 4)             # the global grad norm
    return {"bytes": bytes_, "counts": calls}


def _recurrent_rec(cells, name):
    arch, shape, variant = RECURRENT[name]
    f = f"{arch}__{shape}__2x4" + (f"__{variant}" if variant else "")
    return _rec(cells / "recurrent", f + ".json")


@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_recurrent_smoke_records_are_ok(cells, name):
    rec = _recurrent_rec(cells, name)
    assert rec["status"] == "ok" and set(rec) == REF_KEYS, rec
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0


@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_recurrent_collectives_equal_reckoning(cells, name):
    assert _recurrent_rec(cells, name)["collectives"] == \
        _reckon_recurrent(name)


def test_seqpar_turns_the_residual_all_reduce_into_rs_and_ag(cells):
    """jamba's ``seqpar`` record against the same step without it: the
    reduce-scatter and all-gather bytes equal the reckoning, and the
    residual's all-reduces are gone (the x_proj partials, the MoE's
    batch sums, the loss's and the params' stay)."""
    on = _recurrent_rec(cells, "jamba-seqpar")["collectives"]["bytes"]
    off = _recurrent_rec(cells, "jamba-train")["collectives"]["bytes"]
    want = _reckon_recurrent("jamba-seqpar")["bytes"]
    for k in ("reduce-scatter", "all-gather", "all-reduce"):
        assert on[k] == want[k], k
    assert on["reduce-scatter"] > off["reduce-scatter"]
    assert on["all-gather"] > off["all-gather"]
    assert on["all-reduce"] < off["all-reduce"]


def test_recurrent_depth_extrapolation_equals_full_count(cells):
    rec = _recurrent_rec(cells, "jamba-decode")
    ex = rec["extrapolated"]
    assert ex["periods"] == 2 and ex["method"] == "linear-extrapolation"
    assert ex["flops"] == rec["flops"] > 0
    assert ex["bytes"] == rec["bytes_accessed"] > 0
    assert ex["coll"] == rec["collectives"]["bytes"]


# The time loops counted from their shapes (``dryrun._by_shape``), each
# against the stepped loop it stands in for at a small size: the same
# flops (the sLSTM's backward one (B, d) x (d, 4d) product more: the loop's
# first h is the initial state's and needs no gradient), every input
# read by an op and every output made by one, at the loop's shapes and
# dtypes, and bytes between the operands' (each read or written once) and
# the stepped loop's.

_SB, _SS, _SD, _SN = 2, 8, 6, 4


class _Reads(TorchDispatchMode):
    """The storages that non-view aten ops read and wrote."""

    def __init__(self):
        super().__init__()
        self.read, self.wrote = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.read |= {t.untyped_storage().data_ptr()
                          for t in dryrun._tensors((args, kwargs))}
            self.wrote |= {t.untyped_storage().data_ptr()
                           for t in dryrun._tensors(out)}
        return out


def _count(fn, *args):
    """(flops, bytes, storages read, storages written, output) of fn."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, \
            dryrun.OpCounter() as oc, _Reads() as rd:
        out = fn(*args)
    return fc.get_total_flops(), oc.bytes, rd.read, rd.wrote, out


def _scan_args(which, with_state):
    from repro_torch.kernels.selective_scan.selective_scan import \
        states_shape
    g = torch.Generator().manual_seed(0)
    B, S, d, n = _SB, _SS, _SD, _SN
    dA = torch.rand(B, S, d, n, generator=g)
    dBx = torch.randn(B, S, d, n, generator=g)
    Cm = torch.randn(B, S, n, generator=g)
    h = torch.randn(B, d, n, generator=g) if with_state else None
    if which == "fwd":
        st = torch.zeros(states_shape(B, S, d, n)) if with_state else None
        return lambda: (dA, dBx, Cm, None if h is None else h.clone(), st)
    dy = torch.randn(B, S, d, generator=g)
    dh = torch.randn(B, d, n, generator=g) if with_state else None
    return lambda: (dA, dBx, Cm, h, dy, dh)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_scan_by_shape_counts_the_loops_work(which, with_state):
    from repro_torch.kernels.selective_scan import selective_scan as ss
    from repro_torch.kernels.selective_scan import selective_scan_bwd as sb
    loop, stand = {"fwd": (ss.selective_scan_plain, dryrun._scan_by_shape),
                   "bwd": (sb.selective_scan_bwd_plain,
                           dryrun._scan_bwd_by_shape)}[which]
    make = _scan_args(which, with_state)
    a, b = make(), make()
    fl_loop, by_loop, _, _, out_loop = _count(loop, *a)
    fl, by, read, wrote, out = _count(stand, *b)
    assert fl == fl_loop
    assert fl == (2 * _SB * _SS * _SD * _SN if which == "fwd" else 0)
    ins = [t for t in dryrun._tensors(b)]
    outs = [t for t in dryrun._tensors(out)]
    assert all(t.untyped_storage().data_ptr() in read for t in ins)
    assert all(t.untyped_storage().data_ptr() in wrote
               for t in outs + [t for t in b[3:] if t is not None
                                and which == "fwd"])
    want = dryrun._tensors(out_loop)
    assert [(t.shape, t.dtype) for t in outs] == \
        [(t.shape, t.dtype) for t in want]
    io = sum(dryrun._nbytes(t) for t in ins + outs)
    assert io <= by < by_loop, (io, by, by_loop)


def test_slstm_by_shape_counts_the_loops_work():
    from repro_torch.models import xlstm
    B, S, d = _SB, _SS, _SD
    g = torch.Generator().manual_seed(0)
    wh = (torch.randn(d, 4 * d, generator=g) * 0.3).bfloat16()
    zx0 = torch.randn(B, S, 4 * d, generator=g).bfloat16()
    res = {}
    for name, fn in (("loop", xlstm._slstm_steps),
                     ("stand", dryrun._slstm_steps_by_shape)):
        p = {"wh": wh.clone().requires_grad_(),
             "b": torch.zeros(4 * d).bfloat16()}
        zx = zx0.clone().requires_grad_()

        def run():
            hs = fn(p, zx, d)
            hs.float().sum().backward()
            return hs
        res[name] = _count(run) + (p, zx)
    fl_loop, by_loop, _, _, hs_loop, _, _ = res["loop"]
    fl, by, read, _, hs, p, zx = res["stand"]
    assert fl == fl_loop + 2 * B * d * 4 * d
    assert (hs.shape, hs.dtype) == (hs_loop.shape, hs_loop.dtype)
    for t in (zx, p["wh"], p["b"]):
        assert t.untyped_storage().data_ptr() in read
    assert p["wh"].grad is not None and zx.grad is not None
    io = sum(dryrun._nbytes(t) for t in (zx, p["wh"], p["b"], hs,
                                          p["wh"].grad, zx.grad))
    assert io <= by < by_loop, (io, by, by_loop)


# --------------------------------------------------------------------------
# (f) contexts and variants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_every_mixer_takes_a_context(arch):
    model = get_model(get_config(arch, smoke=True))
    assert {k.mixer for k in model.period} & {"mamba", "mlstm", "slstm"}
    assert model.sharded(None).cfg is model.cfg


def test_seqpar_variant_and_its_rows():
    cfg = dryrun.apply_variant(get_config("jamba-1.5-large-398b"),
                               "seqpar+moe_cap1")
    assert cfg.seq_shard_activations and cfg.moe_capacity == 1.0
    from repro_torch.launch import perf_table
    rows = {(a, s, v) for a, s, vs in perf_table.CELLS for v in vs
            if "seqpar" in v}
    assert rows == {("jamba-1.5-large-398b", "train_4k", "seqpar"),
                    ("jamba-1.5-large-398b", "train_4k", "seqpar+moe_cap1"),
                    ("llama3-405b", "train_4k", "seqpar")}


@pytest.mark.parametrize("variant,knob", [
    ("skip_blocks", "attn_skip_masked_blocks"),
    ("chunk1k", "attn_chunk"), ("naive_attn", "attn_impl")])
def test_dropped_variants_raise(variant, knob):
    with pytest.raises(ValueError, match=knob):
        dryrun.apply_variant(get_config("granite-3-2b"), variant)
    assert dryrun.apply_variant(get_config("granite-3-2b"),
                                "loss_chunk").loss_chunk == 512


# --------------------------------------------------------------------------
# (h) the roofline
# --------------------------------------------------------------------------

def test_ring_factors():
    assert roofline.ring_factor("all-reduce", 16) == 2 * 15 / 16
    assert roofline.ring_factor("all-gather", 16) == 15 / 16
    assert roofline.ring_factor("collective-permute", 16) == 1.0


@pytest.mark.parametrize("mesh_shape,link", [([2, 4], 450e9),
                                             ([1, 16], 50e9)])
def test_analyze_uses_h100_constants(mesh_shape, link):
    cfg = get_config("granite-3-2b")
    n = mesh_shape[0] * mesh_shape[1]
    ring = mesh_shape[1]
    rec = {"status": "ok", "arch": "granite-3-2b", "shape": "train_4k",
           "mesh": "x".join(map(str, mesh_shape)), "n_devices": n,
           "mesh_shape": mesh_shape, "n_params": 2_534_049_792,
           "step_kind": "train", "flops": 989e12 * 2,
           "bytes_accessed": 3.35e12 * 3,
           "collectives": {"bytes": {"all-reduce": 1e9}}}
    row = roofline.analyze(rec, cfg)
    assert row.compute_s == pytest.approx(2.0)
    assert row.memory_s == pytest.approx(3.0)
    want = 1e9 * 2 * (ring - 1) / ring / link
    assert row.collective_s == pytest.approx(want)
    assert row.dominant == "memory"
    assert row.fit_note.endswith("FITS 80G")
    mf = 6 * rec["n_params"] * 256 * 4096
    assert row.model_flops == pytest.approx(mf)
    assert row.useful_ratio == pytest.approx(mf / (rec["flops"] * n))
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES) == \
        (989e12, 3.35e12, 80e9)
