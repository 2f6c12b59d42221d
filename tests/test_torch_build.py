"""The CUDA build's cache key (``repro_torch.kernels._build._target``): a
library is named by a hash of its source, of the local headers the source
includes (through other headers too) and of the flags, so that an edited
header rebuilds every source that includes it rather than loading a stale
library.  Nothing here needs nvcc or a card."""
import pytest

from repro_torch.kernels import _build


def _tree(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// inner\n")
    (csrc / "k.cu").write_text('#include <cuda.h>\n#include "outer.cuh"\nint x;\n')
    (csrc / "other.cu").write_text("int y;\n")
    return csrc


@pytest.mark.parametrize("edited", ["k.cu", "outer.cuh", "inner.cuh"])
def test_an_edited_source_or_header_changes_the_target(tmp_path, monkeypatch, edited):
    csrc = _tree(tmp_path)
    monkeypatch.setitem(_build.SOURCES, "k", csrc / "k.cu")
    monkeypatch.setitem(_build.SOURCES, "other", csrc / "other.cu")
    before = {n: _build._target(n) for n in ("k", "other")}
    assert before["k"].name.startswith("k_") and before["k"].suffix == ".so"
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert _build._target("k") != before["k"]
    assert _build._target("other") == before["other"]  # includes none of them


def test_inputs_follow_local_includes_once(tmp_path):
    csrc = _tree(tmp_path)
    (csrc / "inner.cuh").write_text('#pragma once\n#include "outer.cuh"\n')  # a cycle
    assert [p.name for p in _build._inputs(csrc / "k.cu")] == ["k.cu", "outer.cuh", "inner.cuh"]


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_attention_sources_hash_the_shared_header(name):
    """K6 and K6b share csrc/hopper.cuh (tensor maps, mbarriers, wgmma)."""
    got = [p.name for p in _build._inputs(_build.SOURCES[name])]
    assert got == [f"{name}.cu", "hopper.cuh"]


@pytest.mark.parametrize("name", ["block_join", "cms_update", "histogram", "ingest_fused", "wkv6",
                                  "wkv6_bwd"])
def test_other_sources_include_no_local_header(name):
    assert [p.name for p in _build._inputs(_build.SOURCES[name])] == [f"{name}.cu"]
