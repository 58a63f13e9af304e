"""The ``graph_row_share.recording`` reader on the canned trace of
``test_bench_spans.py`` with a filled counter registry."""

import pytest
from test_bench_spans import REQUESTS, WORK
from test_bench_trace import read

from benchlib import trace
from sdtk_tpu_torch.utils import profiling

NAME = "graph_row_share.recording"


@pytest.fixture
def tr():
    return trace.parse(REQUESTS)


@pytest.mark.parametrize("counted,share", [
    ({"embed.rows": 2 * 13 * 128, "embed.graph_rows": 2 * 13 * 128}, 100.0),
    ({"embed.rows": 4 * 128, "embed.graph_rows": 3 * 128}, 75.0),
    ({"embed.rows": 128, "embed.graph_rows": 0}, 0.0),
])
def test_share_of_graph_rows(tr, monkeypatch, counted, share):
    monkeypatch.setattr(profiling, "counters", lambda: dict(counted))
    assert read(NAME, tr, WORK) == pytest.approx(share)


def test_none_without_the_counters(tr, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {"embed.rows": 128})
    assert read(NAME, tr, WORK) is None  # a program without the graph route
    monkeypatch.setattr(profiling, "counters", lambda: {"embed.graph_rows": 0})
    assert read(NAME, tr, WORK) is None  # no row embedded
    monkeypatch.delattr(profiling, "counters")
    assert read(NAME, tr, WORK) is None  # a program without counters
    assert read(NAME, trace.parse([]), WORK) is None
