"""The kernel libraries' names: a digest of everything a build reads.

``_build.target`` names ``build/kernels/<name>-<digest>.so``; a library is
loaded only under its current name, so the digest must change whenever a
build would compile other bytes: the source, any header of ``csrc/`` that a
source may include (``hopper.cuh``), or the flags.  Each case edits a
temporary copy of ``csrc``, never the tree itself.
"""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_target_changes_with_what_a_build_reads(csrc, edit):
    before = {n: _build.target(n, csrc) for n in _build.SOURCES}
    if edit == "header":
        path = csrc / "hopper.cuh"
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        path = csrc / "flash_attention.cu"
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = {n: _build.target(n, csrc) for n in _build.SOURCES}
    if edit == "source":
        assert after["flash_attention"] != before["flash_attention"]
        assert all(after[n] == before[n] for n in _build.SOURCES
                   if n != "flash_attention")
    else:                       # any source may include a header
        assert all(after[n] != before[n] for n in _build.SOURCES)


def test_target_of_the_tree_is_its_copy(csrc):
    """The digest reads bytes, not paths: a copy of ``csrc`` names the same
    libraries as the tree, and a file that is no source or header changes
    nothing."""
    (csrc / "notes.txt").write_text("not read by a build")
    assert all(_build.target(n, csrc) == _build.target(n)
               for n in _build.SOURCES)
