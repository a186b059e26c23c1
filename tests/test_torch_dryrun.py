"""The port's dry run, roofline and refusals, on the CPU.

  (f) jamba's and xlstm's refusal: ``LM.sharded`` raises
      ``NotImplementedError`` naming ROADMAP A16, and the dry run writes
      ``status: "not_ported"``; the reference's dropped variants raise
      ``ValueError`` naming their knob.
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
      ``_depth_extrapolate``'s result equals the full count.
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

from repro.configs import get_config as ref_get_config
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
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "DRYRUN_OK" in r.stdout, r.stderr[-3000:]
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


# --------------------------------------------------------------------------
# (f) refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_mamba_and_xlstm_refuse_a_context(arch, tmp_path):
    model = get_model(get_config(arch, smoke=True))
    with pytest.raises(NotImplementedError, match="A16"):
        model.sharded(None)
    rec = dryrun.run_cell(arch, "train_4k", "2x4", tmp_path, verbose=False)
    assert rec["status"] == "not_ported" and "A16" in rec["reason"]
    assert json.loads(next(tmp_path.glob("*.json")).read_text()) == rec


@pytest.mark.parametrize("variant,knob", [
    ("seqpar", "seq_shard_activations"), ("skip_blocks",
                                          "attn_skip_masked_blocks"),
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
