"""The ``fused_epilogue_share`` readers on the canned trace of
``test_bench_spans.py`` with a filled counter registry."""

import pytest
from test_bench_spans import REQUESTS, WORK
from test_bench_trace import read

from benchlib import trace
from sdtk_tpu_torch.utils import profiling

NAMES = ["fused_epilogue_share.batch", "fused_epilogue_share.recording"]


@pytest.fixture
def tr():
    return trace.parse(REQUESTS)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("counted,share", [
    ({"tower.epilogues": 2 * 13 * 29, "tower.fused_epilogues": 2 * 13 * 29}, 100.0),
    ({"tower.epilogues": 30, "tower.fused_epilogues": 24}, 80.0),
    ({"tower.epilogues": 29}, 0.0),  # the eager route alone
])
def test_share_of_fused_epilogues(tr, monkeypatch, name, counted, share):
    monkeypatch.setattr(profiling, "counters", lambda: dict(counted, **{"embed.rows": 128}))
    assert read(name, tr, WORK) == pytest.approx(share)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_counters(tr, monkeypatch, name):
    monkeypatch.setattr(profiling, "counters", lambda: {"embed.rows": 128})
    assert read(name, tr, WORK) is None  # a program that counts no epilogue
    monkeypatch.delattr(profiling, "counters")
    assert read(name, tr, WORK) is None  # a program without counters
    assert read(name, trace.parse([]), WORK) is None
