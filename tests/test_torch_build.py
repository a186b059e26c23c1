"""kernels/build.py: the build key covers the headers a source includes,
and nvcc is given their directories. Runs on the host: no nvcc is
called (``subprocess.Popen`` is replaced by a stand-in that writes the
library file)."""
import re
import subprocess
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.kernels.selective_scan import selective_scan as SS

KERNELS = (RN, FA, MD, SS)


def _sources(tmp_path: Path):
    inc = tmp_path / "inc"
    inc.mkdir()
    hdr = inc / "shared.cuh"
    hdr.write_text("#define SHARED 1\n")
    cu = tmp_path / "k.cu"
    cu.write_text('#include "shared.cuh"\nextern "C" int k() { return 0; }\n')
    return cu, hdr


def test_source_key_covers_header_bytes(tmp_path):
    cu, hdr = _sources(tmp_path)
    src, flags = cu.read_text(), ["-O3"]
    key = build.source_key(src, [hdr], flags)
    assert build.source_key(src, [hdr], flags) == key
    hdr.write_text("#define SHARED 2\n")
    assert build.source_key(src, [hdr], flags) != key
    assert build.source_key(src, [], flags) != key


def test_source_kernel_key_follows_its_headers(tmp_path):
    cu, hdr = _sources(tmp_path)
    k = build.SourceKernel("probe", cu, {}, headers=[hdr])
    before = k.key()
    hdr.write_bytes(hdr.read_bytes() + b"// edited\n")
    assert k.key() != before
    assert k.includes() == [cu.parent, hdr.parent]


class _FakeNvcc:
    """Stands in for the nvcc process: records the command and writes the
    output file named after ``-o``."""
    commands = []

    def __init__(self, cmd, stdout=None, stderr=None):
        self.commands.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        self.returncode = 0

    def poll(self):
        return 0


def test_build_passes_every_include_directory(tmp_path, monkeypatch):
    cu, hdr = _sources(tmp_path)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.commands = []
    k = build.SourceKernel("probe", cu, {}, headers=[hdr])
    so, _ = k.build()
    assert so.name == f"{k.key()}.so" and so.exists()
    (cmd,) = _FakeNvcc.commands
    assert f"-I{cu.parent}" in cmd and f"-I{hdr.parent}" in cmd
    assert "-Xptxas=-v" in cmd
    # built once: the same key is not built again; an edited header is
    k.build()
    assert len(_FakeNvcc.commands) == 1
    hdr.write_text("#define SHARED 3\n")
    so2, _ = k.build()
    assert so2 != so and len(_FakeNvcc.commands) == 2


@pytest.mark.parametrize("mod", KERNELS, ids=lambda m: m.KERNEL.kind)
def test_every_included_header_is_declared(mod):
    """Each quoted header a kernel's source includes is either beside it or
    among the headers its SourceKernel hashes."""
    k = mod.KERNEL
    names = re.findall(r'#include\s+"([^"]+)"', k.cu.read_text())
    for name in names:
        beside = (k.cu.parent / name).exists()
        declared = any(h.name == name and h.exists() for h in k.headers)
        assert beside or declared, f"{k.cu.name} includes {name}"


@pytest.mark.parametrize("mod", (FA, MD), ids=lambda m: m.KERNEL.kind)
def test_tensor_core_kernels_build_with_the_shared_header(mod):
    assert build.CSRC / "sm90.cuh" in mod.KERNEL.headers
    assert build.CSRC in mod.KERNEL.includes()
    assert '#include "sm90.cuh"' in mod.KERNEL.cu.read_text()
