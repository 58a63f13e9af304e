"""``utils/build.py`` on the CPU (no ``nvcc`` needed): the library's name
covers the source and every header it may include."""

from __future__ import annotations

import shutil

from sdtk_tpu_torch.utils import build


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the log-mel kernels share a header"
    before = {name: build.library_path(name) for name in build.kernel_names()}
    assert before == {name: build.library_path(name) for name in build.kernel_names()}
    with open(headers[0], "ab") as f:
        f.write(b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.kernel_names()}
    assert all(before[name] != after[name] for name in before)


def test_library_path_changes_with_its_source_only(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.kernel_names()}
    with open(csrc / "cosine.cu", "ab") as f:
        f.write(b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.kernel_names()}
    assert [name for name in before if before[name] != after[name]] == ["cosine"]
