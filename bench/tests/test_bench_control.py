"""The control at a size a test run holds: the plain reference in fp8, put
in the program's place, comes out not correct against the small cells'
limits, while the program's own readings pass them."""
from __future__ import annotations

import sys

import pytest

from bench import control, harness
from bench.tests.helpers import TINY_CHECKS, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def clean_modules(monkeypatch):
    for m in harness.forbidden_modules():
        monkeypatch.delitem(sys.modules, m)


def _fails(numbers, cell) -> bool:
    return any(numbers[k] > c["limit"] for k, c in TINY_CHECKS[cell].items())


@pytest.mark.parametrize("cell", ["tiny-dense.prefill-tiny",
                                  "tiny-dense.train-tiny"])
def test_control_is_not_correct(root, cell):
    out = control.readings(root, cell, [5], [5], "cpu", emit=lambda _: None)
    assert not _fails(out["program"][0], cell), out["program"]
    assert _fails(out["control"][0], cell), out["control"]
    for fault, rs in out["faults"].items():
        assert _fails(rs[0], cell), (fault, rs)
    s = control.summary(out, out["train"])
    assert set(s) >= set(TINY_CHECKS[cell])
