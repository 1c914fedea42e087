"""The port's kernel build (paddle_tpu_torch.ops._build) on the CPU: the
library's digest covers every file under `csrc/` — the sources nvcc
compiles and the headers they include — so an edited header rebuilds the
library instead of reusing a stale one. Runs on a temporary copy of
`csrc/` (`CSRC` monkeypatched); nothing is compiled."""
import re
import shutil

import pytest

from paddle_tpu_torch.ops import _build
import torch_threads  # noqa: F401  (one torch thread a worker)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_every_source_is_in_csrc_and_every_include_is_a_header_there():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SOURCES) <= names
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc.endswith(".cuh") and inc in names, (src, inc)


@pytest.mark.parametrize("name", ["mma_sm90.cuh", "flash_attn_bwd.cu"])
def test_editing_a_header_or_source_changes_the_digest(csrc_copy, name):
    before = _build._digest()
    assert _build._digest() == before  # a function of the bytes alone
    path = csrc_copy / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build._digest() != before


def test_a_new_header_changes_the_digest(csrc_copy):
    before = _build._digest()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build._digest() != before


def test_files_that_are_not_sources_leave_the_digest(csrc_copy):
    before = _build._digest()
    (csrc_copy / "notes.txt").write_text("not compiled\n")
    assert _build._digest() == before
