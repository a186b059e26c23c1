"""The port's assembler (core/backends/asm.py) and cycle model
(core/simx.py) against the reference's: for every bench under every
ABLATION_LADDER configuration, ``emit_asm`` gives the same text (register
numbers renumbered, as tests/test_torch_pipeline.py does for VIR dumps),
``static_counts`` the same counts, and ``CycleModel.cycles`` of a launch
through each package's Runtime on the host the same cycles, with
__shared__ arrays mapped to local memory and to global memory (the Fig 10
trade-off)."""
import re

import numpy as np
import pytest

from repro.core.backends.asm import emit_asm as ref_emit_asm
from repro.core.backends.asm import static_counts as ref_static_counts
from repro.core.passes.pipeline import ABLATION_LADDER as REF_LADDER
from repro.core.passes.pipeline import run_pipeline as ref_run_pipeline
from repro.core.runtime import Runtime as RefRuntime
from repro.core.simx import CycleModel as RefCycleModel
from repro.volt_bench.suite import BENCHES as REF_BENCHES
from repro_torch.core.backends.asm import emit_asm, static_counts
from repro_torch.core.passes.pipeline import ABLATION_LADDER, run_pipeline
from repro_torch.core.runtime import Runtime
from repro_torch.core.simx import CycleModel
from repro_torch.volt_bench.suite import BENCHES

from test_torch_pipeline import _renumber

_LABEL = re.compile(r"(?<![%\w.#])([A-Za-z_][\w.]*)\.(\d+)\b")


def _renumber_asm(text: str) -> str:
    """``_renumber`` for the registers, then the block labels (``entry.7:``,
    ``j for.cond.12``: no ``%`` in assembly) in order of first appearance;
    their suffixes come from process-global counters too."""
    seen = {}

    def sub(m):
        key = m.group(0)
        if key not in seen:
            seen[key] = len(seen)
        return f"{m.group(1)}.#{seen[key]}"

    return _LABEL.sub(sub, _renumber(text))


@pytest.fixture(autouse=True)
def _private_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("VOLT_CACHE_DIR", str(tmp_path))


def _launch(rt, fn, bufs0, sc, params):
    for k, v in bufs0.items():
        rt.create_buffer(k, v.copy())
    try:
        rt.launch(fn, grid=params.grid, block=params.local_size,
                  scalar_args=sc)
    except Exception as e:       # the same error on both sides below
        return type(e).__name__
    return None


@pytest.mark.parametrize("cfg_i", range(len(ABLATION_LADDER)),
                         ids=[c.label for c in ABLATION_LADDER])
@pytest.mark.parametrize("name", list(BENCHES))
def test_asm_and_cycles_match_the_reference(name, cfg_i):
    b, rb = BENCHES[name], REF_BENCHES[name]
    fn = run_pipeline(b.handle.build(None), b.handle.name,
                      ABLATION_LADDER[cfg_i]).fn
    ref_fn = ref_run_pipeline(rb.handle.build(None), rb.handle.name,
                              REF_LADDER[cfg_i]).fn
    assert _renumber_asm(emit_asm(fn)) == _renumber_asm(ref_emit_asm(ref_fn))
    assert static_counts(fn) == ref_static_counts(ref_fn)
    bufs0, sc, params = b.make(np.random.default_rng(3))
    rbufs0, rsc, _ = rb.make(np.random.default_rng(3))
    for shared_in_local in (True, False):
        rt = Runtime(device="cpu", shared_in_local=shared_in_local)
        ref_rt = RefRuntime(shared_in_local=shared_in_local)
        err = _launch(rt, fn, bufs0, sc, params)
        assert err == _launch(ref_rt, ref_fn, rbufs0, rsc, params)
        if err is not None:
            continue
        assert rt.last_report.executor == ref_rt.last_report.executor
        assert rt.cycles() == ref_rt.cycles()
        for k in bufs0:
            assert rt.buffers[k].tobytes() == ref_rt.buffers[k].tobytes()


def test_renumber_asm_is_a_bijection_on_labels():
    a = "entry.3:\n    bnez %v7, for.cond.12, exit.4\nfor.cond.12:\n    j exit.4"
    b = "entry.9:\n    bnez %v1, for.cond.2, exit.5\nfor.cond.2:\n    j exit.5"
    assert _renumber_asm(a) == _renumber_asm(b)
    assert _renumber_asm(a) != _renumber_asm(a.replace("j exit.4",
                                                       "j for.cond.12"))
    assert "0.5" in _renumber_asm("    %v2 = mul %v1, 0.5")


def test_shared_mapping_moves_cycles_as_fig10():
    """Mapping __shared__ to global memory costs psum cycles, and the
    model's knobs equal the reference's."""
    assert CycleModel() == CycleModel(**{
        k: getattr(RefCycleModel(), k)
        for k in RefCycleModel.__dataclass_fields__})
    b = BENCHES["psum"]
    fn = run_pipeline(b.handle.build(None), "psum", ABLATION_LADDER[-1]).fn
    bufs0, sc, params = b.make(np.random.default_rng(0))
    cyc = {}
    for local in (True, False):
        rt = Runtime(device="cpu", shared_in_local=local)
        assert _launch(rt, fn, bufs0, sc, params) is None
        assert rt.last_stats.shared_requests > 0
        cyc[local] = rt.cycles()
    assert cyc[False] > cyc[True]
