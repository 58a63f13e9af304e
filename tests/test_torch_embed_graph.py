"""The embed engine's graph route (``backends/embed_graph.py``).

On the CPU: which calls the route takes (the decision reads only types,
shapes and modes, so a route built for "cuda" answers without a card), a
shape's first call left to the eager route, the engine's eager route with
no graph row, and the tape of counts and launches.  On the
card (``cuda`` marker; ``python -m pytest -m cuda tests/test_torch_embed_graph.py``):
the graph's embeddings bit-equal to the eager route's, results that
survive the next call, threads, weights written after capture, the
counters and launches a replay adds, and the cache's bound.  This file
imports only torch and the port."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from sdtk_tpu_torch.backends import embed_graph, gpu
from sdtk_tpu_torch.backends.embed_graph import CEILING, MAX_SHAPES, GraphRoute
from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.models.wavlm import WavLMEcapa, WavLMEcapaConfig
from sdtk_tpu_torch.models.xvector import XVector, XVectorConfig
from sdtk_tpu_torch.ops import kernel_wrappers
from sdtk_tpu_torch.utils import profiling

SMALL = dict(channels=64, mfa_channels=192, se_bottleneck=16, attention_channels=16)
WAVLM_SMALL = dict(conv_dim=(32,) * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, channels=64, emb_dim=32, se_bottleneck=16,
                   attention_channels=16, mfa_channels=192)
CHUNK = (128, 16000)  # the diarizer's chunk of 1 s windows


def _meta(rows: int, samples: int) -> torch.Tensor:
    return torch.empty((rows, samples), device="meta")


def _route(model: torch.nn.Module, device: str = "cuda") -> GraphRoute:
    return GraphRoute(model.eval(), torch.device(device), forward=None)


def _ecapa(**over) -> EcapaTdnn:
    return EcapaTdnn(EcapaConfig(**(SMALL | over)))


@pytest.mark.parametrize("shape,takes", [
    (CHUNK, True), ((16, 48000), True), ((1, CEILING), True),
    ((1024, 48000), False), ((1, CEILING + 1), False), ((0, 16000), False),
])
def test_the_route_engages_by_size(shape, takes):
    with torch.inference_mode():
        assert _route(_ecapa()).engages(_meta(*shape)) is takes
    assert 2 ** 21 <= CEILING <= 2 ** 24 and CHUNK[0] * CHUNK[1] <= CEILING


def test_the_xvector_engages_and_other_towers_do_not():
    with torch.inference_mode():
        assert _route(XVector(XVectorConfig(channels=32, pre_pool_channels=48,
                                            emb_dim=16))).engages(_meta(*CHUNK))
        assert not _route(Conformer(ConformerConfig(dim=32, n_blocks=1))).engages(_meta(*CHUNK))
        assert not _route(WavLMEcapa(WavLMEcapaConfig(**WAVLM_SMALL))).engages(_meta(*CHUNK))


def _f32():
    return _route(_ecapa(dtype="float32"))


def _cpu():
    return _route(_ecapa(), "cpu")


def _tp():
    route = _route(_ecapa())
    route.model.block2.res2.conv3.tp = object()  # any split takes the eager ops
    return route


@pytest.mark.parametrize("make", [_f32, _cpu, _tp], ids=["f32", "cpu", "tp"])
def test_off_the_serving_route_it_stays_eager(make):
    with torch.inference_mode():
        assert not make().engages(_meta(*CHUNK))


def test_autograd_on_stays_eager():
    route = _route(_ecapa())
    with torch.enable_grad():
        assert not route.engages(_meta(*CHUNK))
    with torch.no_grad():
        assert route.engages(_meta(*CHUNK))


def test_training_stays_eager_and_drops_the_graphs():
    route = _route(_ecapa())
    route._graphs[CHUNK] = object()
    route.model.train()
    with torch.inference_mode():
        assert not route.engages(_meta(*CHUNK))
    assert not route._graphs


@pytest.fixture()
def counted(monkeypatch):
    monkeypatch.setenv("SDTK_PROFILE", "1")
    profiling.reset()
    yield profiling.counters
    profiling.reset()


def test_the_cpu_engine_embeds_eagerly(counted):
    eng = gpu.GpuBackend(device="cpu").engine
    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal((2, 16000))).astype(np.float32)
    got = eng.embed(x, np.array([16000, 9000], np.int32))
    with torch.inference_mode():
        want = eng.log_mel_forward(torch.from_numpy(x), torch.tensor([16000, 9000]))
    assert torch.equal(got, want)
    c = counted()
    assert c["embed.rows"] == 2 and c.get("embed.graph_rows", 0) == 0
    assert "embed.graph_captures" not in c


def test_a_tape_takes_this_threads_counts(counted):
    profiling.count("a", 1)
    seen = {}

    def other():
        profiling.count("a", 5)

    with profiling.tape() as taped:
        profiling.count("a", 2)
        profiling.count("b", 3)
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with pytest.raises(ValueError):
            profiling.count("c", torch.tensor(1))
        seen.update(taped.counts)
    assert seen == {"a": 2, "b": 3}
    assert counted() == {"a": 6}  # the registry: outside the tape, and the other thread


def test_a_tape_counts_with_counting_off(monkeypatch):
    monkeypatch.delenv("SDTK_PROFILE", raising=False)
    profiling.reset()
    with profiling.tape() as taped:
        profiling.count("tower.epilogues", 29)
    assert taped.counts == {"tower.epilogues": 29} and profiling.counters() == {}


def _wrapper():
    def fn():
        pass
    fn.launches = 0
    return fn


def test_a_tape_takes_this_threads_launches():
    fn = _wrapper()
    profiling.launched(fn)
    ready, done = threading.Event(), threading.Event()

    def other():  # launches while the tape is open
        ready.wait()
        profiling.launched(fn)
        profiling.launched(fn)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with profiling.tape() as taped:
        profiling.launched(fn)
        ready.set()
        done.wait()
    t.join()
    assert taped.launches == {fn: 1} and fn.launches == 3
    taped.add()  # a replay
    assert fn.launches == 4


def test_a_shapes_first_call_is_left_to_the_eager_route():
    route = _route(_ecapa())
    x, lens = torch.zeros(CHUNK), torch.full((CHUNK[0],), CHUNK[1])
    assert route(x, lens) is None and list(route._seen) == [CHUNK] and not route._graphs
    for rows in range(1, embed_graph.MAX_SEEN + 1):
        assert route(torch.zeros(rows, 8), torch.full((rows,), 8)) is None
    assert CHUNK not in route._seen and len(route._seen) == embed_graph.MAX_SEEN


# ---- on the card ----

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _engine(model: str = "ecapa"):
    return gpu.GpuBackend(model=model, device="cuda").engine


def _chunk(rows: int, samples: int, real: int | None = None, seed: int = 0):
    """``real`` windows of speech-like noise with ragged lengths, then zero
    pad rows of full length, as ``Diarizer._embed_windows`` fills its last
    chunk."""
    real = rows if real is None else real
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, samples), np.float32)
    x[:real] = 0.1 * rng.standard_normal((real, samples))
    lens = np.full(rows, samples, np.int32)
    lens[:real] = rng.integers(400, samples + 1, real)
    lens[0] = samples
    for i in range(real):
        x[i, lens[i]:] = 0.0
    return x, lens


def _eager(eng, x, lens) -> torch.Tensor:
    with torch.inference_mode():
        return eng.log_mel_forward(torch.from_numpy(x).to(eng.device),
                                   torch.from_numpy(lens.astype(np.int64)).to(eng.device))


@pytest.mark.cuda
@pytest.mark.parametrize("model,shape,real", [
    ("ecapa", CHUNK, 128), ("ecapa", CHUNK, 61), ("ecapa", (16, 48000), 16),
    ("xvector", CHUNK, 100),
], ids=["ecapa-chunk", "ecapa-last-chunk", "ecapa-identify", "xvector-chunk"])
def test_the_graph_is_bit_equal_to_the_eager_route(cuda, counted, model, shape, real):
    eng = _engine(model)
    for seed in range(4):  # eager, the capture, then two replays
        x, lens = _chunk(*shape, real, seed)
        got = eng.embed(x, lens)
        assert torch.equal(got, _eager(eng, x, lens)), seed
    c = counted()
    assert c["embed.graph_rows"] == 3 * shape[0] and c["embed.graph_captures"] == 1
    assert list(eng._graph._graphs) == [shape]


@pytest.mark.cuda
def test_a_result_survives_the_next_call(cuda):
    eng = _engine()
    (x1, l1), (x2, l2) = _chunk(*CHUNK, seed=1), _chunk(*CHUNK, seed=2)
    for _ in range(2):  # eager, then the capture
        eng.embed(x1, l1)
    a = eng.embed(x1, l1)
    kept = a.clone()
    b = eng.embed(x2, l2)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and torch.equal(a, _eager(eng, x1, l1))
    assert not torch.equal(a, b)


@pytest.mark.cuda
def test_threads_get_the_serial_results(cuda):
    eng = _engine()
    inputs = [_chunk(*CHUNK, seed=s) for s in range(8)]
    serial = [eng.embed(x, lens).cpu() for x, lens in inputs]
    got: dict[int, torch.Tensor] = {}

    def work(part: int) -> None:
        for i in range(part, len(inputs), 2):
            got[i] = eng.embed(*inputs[i]).cpu()

    threads = [threading.Thread(target=work, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(torch.equal(got[i], serial[i]) for i in range(len(inputs)))


@pytest.mark.cuda
def test_a_weight_written_after_capture_is_served(cuda, counted):
    eng = _engine()
    x, lens = _chunk(*CHUNK)
    for _ in range(2):  # eager, then the capture
        eng.embed(x, lens)
    before = eng.embed(x, lens)
    with torch.no_grad():
        eng.model.block1.tdnn_in.conv.weight.mul_(1.5)
        eng.model.asp_bn.running_mean.add_(0.25)
    want = _eager(eng, x, lens)
    assert not torch.equal(want, before)
    for _ in range(3):  # the graphs dropped: eager, the capture, a replay
        assert torch.equal(eng.embed(x, lens), want)
    c = counted()
    assert c["embed.graph_captures"] == 2 and c["embed.graph_rows"] == 4 * CHUNK[0]


def _one_call(eng, x, lens) -> tuple[dict, dict]:
    """What one ``embed`` call adds to the counters and the launches."""
    wrappers = kernel_wrappers()
    launched = {k: fn.launches for k, fn in wrappers.items()}
    profiling.reset()
    eng.embed(x, lens)
    torch.cuda.synchronize()
    return profiling.counters(), {k: fn.launches - launched[k] for k, fn in wrappers.items()}


@pytest.mark.cuda
def test_a_replay_counts_as_an_eager_call(cuda, counted, monkeypatch):
    eng = _engine()
    x, lens = _chunk(*CHUNK)
    first_counts, first_launches = _one_call(eng, x, lens)
    capture_counts, capture_launches = _one_call(eng, x, lens)
    replay_counts, replay_launches = _one_call(eng, x, lens)
    monkeypatch.setattr(embed_graph, "CEILING", 0)  # the same call, eagerly
    eager_counts, eager_launches = _one_call(eng, x, lens)
    assert eager_launches["log_mel_wave"] == 1 and eager_launches["tower_epilogue"] > 0
    assert replay_launches == eager_launches == capture_launches == first_launches
    assert first_counts == eager_counts
    assert eager_counts["tower.epilogues"] == eager_counts["tower.fused_epilogues"] == 29
    rows = {"embed.graph_rows": CHUNK[0]}
    assert replay_counts == eager_counts | rows
    assert capture_counts == eager_counts | rows | {"embed.graph_captures": 1}


@pytest.mark.cuda
def test_the_cache_drops_its_fifth_shape(cuda, counted):
    eng = _engine()
    shapes = [(rows, 16000) for rows in (8, 16, 32, 64, 128)]
    for shape in shapes:
        for _ in range(2):  # eager, then the capture
            eng.embed(*_chunk(*shape))
    assert list(eng._graph._graphs) == shapes[1:] and len(shapes) == MAX_SHAPES + 1
    eng.embed(*_chunk(*shapes[1]))  # a hit: now the most recent
    for _ in range(2):  # dropped, so met anew: eager, then captured again, dropping shapes[2]
        eng.embed(*_chunk(*shapes[0]))
    assert list(eng._graph._graphs) == [shapes[3], shapes[4], shapes[1], shapes[0]]
    assert profiling.counters()["embed.graph_captures"] == 6
