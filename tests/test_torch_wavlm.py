"""WavLM + ECAPA (sdtk_tpu_torch/models/wavlm.py) on the CPU, at a small size
(2 layers, d 64, 4 heads, a CNN 32 wide), against the plain float32
reference (``benchmark/reference/wavlm_ecapa.py``, which imports nothing of
either package), and its place in the port and the benchmark:

1. the model against the reference on seeded weights, full and ragged clips,
   in float32 and bfloat16; a ragged clip's embedding does not move when its
   zeroed tail or its buffer's length changes;
2. WavLM's relative-position buckets (the port's and the reference's)
   against a hand-written table, and the gate formula against its loops;
3. ECAPA's new fields at their defaults keep the c512 and c1024 towers as
   they were: the JAX variables layout, and the plain ECAPA reference;
4. ``GpuBackend(model="wavlm_ecapa")``: the engine's waveform route (never
   the log-mel kernel), its checkpoint and sidecar round trip;
5. the spans and counters under ``SDTK_PROFILE=1``;
6. the benchmark's new cell: ``manifest.problems()``, the seeded weights'
   leaves against the port's state dict, the work counts, each new metric
   reader on a canned trace, and a small run of the cell's loop.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sdtk_tpu_torch.backends import gpu
from sdtk_tpu_torch.models import wavlm
from sdtk_tpu_torch.models.ecapa import BatchNorm, EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.models.wavlm import WavLMEcapa, WavLMEcapaConfig
from sdtk_tpu_torch.utils import checkpoint, profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import manifest, trace, wavlm_weights, wavlm_yardstick  # noqa: E402
from reference import ecapa as plain_ecapa  # noqa: E402
from reference import wavlm_ecapa as plain  # noqa: E402

SMALL = dict(conv_dim=(32,) * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
             channels=64, emb_dim=32, se_bottleneck=16, attention_channels=16, mfa_channels=192)
SR = 16000
CELL = "wavlm-large-ecapa.batch-8s"


def small_model(seed: int = 0, dtype: str = "float32") -> WavLMEcapa:
    """The small model with random weights, BatchNorm statistics and state
    weights, so that no norm is the identity and no state weight equal."""
    m = WavLMEcapa(WavLMEcapaConfig(**SMALL, dtype=dtype))
    g = torch.Generator().manual_seed(seed)
    m.reset_parameters(g)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(1.0 + 0.1 * torch.rand(c, generator=g))
                mod.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
        m.mix.weight.copy_(0.3 * torch.randn(m.mix.weight.shape, generator=g))
        for layer in m.layers:
            layer.gate_const.copy_(1.0 + 0.3 * torch.randn(layer.gate_const.shape, generator=g))
    return m.eval()


def clips(b: int, n: int, seed: int, ragged: bool):
    """(b, n) speech-scaled noise and valid lengths; ragged: all but the
    first clip cut short, the tail zeroed."""
    g = torch.Generator().manual_seed(seed)
    x = 0.3 * torch.randn(b, n, generator=g)
    lens = torch.full((b,), n)
    if ragged:
        lens[1:] = torch.randint(n // 3, n - 400, (b - 1,), generator=g)
    return x * (torch.arange(n)[None, :] < lens[:, None]), lens


def plain_of(m: WavLMEcapa) -> plain.WavLMEcapa:
    tree = checkpoint.ecapa_jax_tree(m.state_dict())
    return plain.WavLMEcapa(tree, dataclasses.asdict(m.cfg), "cpu")


def plain_embed(ref, x, lens) -> torch.Tensor:
    return torch.cat([ref(x[i : i + 1, : int(lens[i])]) for i in range(len(lens))])


def port_embed(m, x, lens) -> torch.Tensor:
    with torch.no_grad():
        return F.normalize(m(x, lens).float(), dim=1)


def gaps(got, want) -> tuple[float, float]:
    """(largest 1 − cos, the same after centring both on want's mean row)."""
    mu = want.mean(0, keepdim=True)
    raw = 1.0 - F.cosine_similarity(got.double(), want.double())
    centred = 1.0 - F.cosine_similarity((got - mu).double(), (want - mu).double())
    return raw.max().item(), centred.max().item()


# ── 1. the model against the plain reference ─────────────────────────────


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_matches_the_plain_reference(seed, ragged):
    """Both in float32: they differ only in the order of sums (masked sums
    over the padded buffer against sums over each clip's own samples), so
    1e-5 on 1 − cos and 1e-4 on any element of the unit rows (3e-7 seen)."""
    m = small_model(seed)
    x, lens = clips(6, SR, seed, ragged)
    got, want = port_embed(m, x, lens), plain_embed(plain_of(m), x, lens)
    assert gaps(got, want)[0] <= 1e-5
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_bfloat16_matches_the_plain_reference(ragged):
    """bf16 products (operands rounded to 8 bits, 2⁻⁹ relative) through two
    layers and the head: 1e-3 on 1 − cos and 0.05 once centred (3e-5 and
    2e-3 seen); the f32 statistics keep the gap this small."""
    m32 = small_model(3)
    m16 = WavLMEcapa(WavLMEcapaConfig(**SMALL, dtype="bfloat16")).eval()
    m16.load_state_dict(m32.state_dict())
    x, lens = clips(8, SR, 3, ragged)
    raw, centred = gaps(port_embed(m16, x, lens), plain_embed(plain_of(m32), x, lens))
    assert raw <= 1e-3 and centred <= 0.05


@pytest.mark.parametrize("change", ["tail", "buffer"])
def test_a_ragged_clip_ignores_its_padding(change):
    """The tail's samples are zeroed before anything reads them (bit-equal);
    a longer buffer changes only the shapes the sums run over (1e-6)."""
    m = small_model(4)
    x, lens = clips(3, SR, 4, ragged=True)
    base = port_embed(m, x, lens)
    if change == "tail":
        noisy = x + 5.0 * (torch.arange(SR)[None, :] >= lens[:, None]) * torch.randn(x.shape)
        assert torch.equal(port_embed(m, noisy, lens), base)
    else:
        longer = F.pad(x, (0, SR // 2))
        assert (port_embed(m, longer, lens) - base).abs().max().item() <= 1e-6


def test_frame_lengths_follow_the_cnn():
    """Valid frames = the frames a convolution stack computes on the valid
    samples alone; 8 s of 16 kHz gives 399."""
    m = small_model(5)
    lens = torch.tensor([400, 401, 719, 720, 16000, 128000])
    got = wavlm.frame_lengths(lens, m.cfg).tolist()
    for n, t in zip(lens.tolist(), got):
        y = torch.zeros(1, 1, n)
        for conv in (getattr(m, f"conv{i}") for i in range(7)):
            y = conv(y.expand(1, conv.in_channels, -1))[:, :1]
        assert y.shape[-1] == t
    assert got[-1] == 399 == wavlm_yardstick.frames(128000, dataclasses.asdict(m.cfg))[-1]


# ── 2. buckets and gates ─────────────────────────────────────────────────

# key − query offset → bucket, worked by hand from WavLM's rule with 320
# buckets and distance 800: |n| < 80 is its own bucket; else
# 80 + ⌊ln(|n|/80)/ln(10)·80⌋, at most 159; n > 0 adds 160
BUCKETS = {0: 0, 1: 161, -1: 1, 79: 239, -79: 79, 80: 240, -80: 80, 81: 240, 100: 247,
           -100: 87, 400: 295, -400: 135, 799: 319, 800: 319, -800: 159, 2000: 319, -2000: 159}


@pytest.mark.parametrize("offset", sorted(BUCKETS))
def test_relative_bucket(offset):
    n = torch.tensor([offset])
    assert wavlm.relative_buckets(n).item() == BUCKETS[offset]
    assert plain.bucket(n).item() == BUCKETS[offset]


@pytest.mark.parametrize("const", [0.5, 1.0, 2.0])
def test_gate_formula(const):
    """g = a·(b·c − 1) + 2 with a, b the sigmoids of the two 4-sums of the
    head's Linear(64 → 8), here over heads of 16."""
    g = torch.Generator().manual_seed(7)
    h = torch.randn(2, 5, 64, generator=g)
    w, b = torch.randn(8, 16, generator=g), torch.randn(8, generator=g)
    c = torch.full((4,), const)
    got = wavlm.gates(F.linear(h.view(2, 5, 4, 16), w, b), c)
    assert got.shape == (2, 4, 5)
    for bi in range(2):
        for hi in range(4):
            for t in range(5):
                z = [float(h[bi, t, hi * 16 : (hi + 1) * 16] @ w[j] + b[j]) for j in range(8)]
                a = 1.0 / (1.0 + math.exp(-sum(z[:4])))
                bb = 1.0 / (1.0 + math.exp(-sum(z[4:])))
                assert got[bi, hi, t].item() == pytest.approx(a * (bb * const - 1.0) + 2.0,
                                                              rel=1e-5)


# ── 3. ECAPA's defaults ──────────────────────────────────────────────────

C512 = dict(n_mels=80, channels=64, emb_dim=32, scale=8, se_bottleneck=16,
            attention_channels=16, mfa_channels=192, dilations=[2, 3, 4], dtype="float32",
            mfa_bn=False, asp_tdnn=False)
LAYOUTS = {"c512": C512, "c1024": dict(C512, mfa_bn=True, asp_tdnn=True)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ecapa_defaults_keep_the_towers(layout):
    """With ``global_context`` and ``dense_blocks`` at their defaults the tower
    has the JAX variables' leaves (the benchmark's ``ecapa_leaves``) and
    computes the plain ECAPA reference's embeddings (f32, 1e-5)."""
    from benchlib import weights

    m = LAYOUTS[layout]
    cfg = EcapaConfig(**{k: tuple(v) if k == "dilations" else v for k, v in m.items()})
    assert not cfg.dense_blocks and cfg.global_context
    tower = EcapaTdnn(cfg)
    tower.reset_parameters(torch.Generator().manual_seed(1))
    tree = checkpoint.ecapa_jax_tree(tower.state_dict())
    flat = {"/".join(k): v for k, v in _leaves(tree)}
    assert flat == {"/".join(p): s for p, s, _ in weights.ecapa_leaves(m)}
    feats = torch.randn(3, 50, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = F.normalize(tower.eval()(feats), dim=1)
    want = plain_ecapa.Ecapa(tree, m, "cpu")(feats)
    assert (got - want).abs().max().item() <= 1e-5


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*path, k))
        else:
            yield (*path, k), tuple(np.shape(v))


# ── 4. the backend's waveform route and the checkpoint ───────────────────


@pytest.fixture()
def served(tmp_path):
    m = small_model(6)
    path = tmp_path / "wavlm_ecapa.msgpack"
    checkpoint.write_wavlm_ecapa(path, m)
    return m, path


def test_checkpoint_round_trips(served):
    m, path = served
    sd = checkpoint.ecapa_state_dict(checkpoint.read_msgpack(path))
    assert sd.keys() == m.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in m.state_dict().items())
    side = gpu.EmbedEngine._read_json_sidecar(path.with_suffix(".config.json"), "config")
    assert WavLMEcapaConfig.from_dict(side["model"]) == m.cfg


def test_engine_takes_the_waveform_route(served, monkeypatch):
    """The engine embeds raw samples through the model and never calls the
    log-mel kernel (its wrapper raises here)."""
    m, path = served

    def no_k1(*a, **k):
        raise AssertionError("K1 called on the waveform route")
    monkeypatch.setattr(gpu, "log_mel_wave", no_k1)
    backend = gpu.GpuBackend(model="wavlm_ecapa", params_path=path, device="cpu")
    eng = backend.engine
    assert eng.waveform and eng.params_source == str(path) and backend.embedding_dim == 32
    x, lens = clips(4, 2 * SR, 8, ragged=True)
    got = eng.embed(x.numpy(), lens.numpy())
    assert (got - port_embed(m, x, lens)).abs().max().item() <= 1e-6
    assert backend.embed_windows(x[0].numpy()).shape == (1, 32)


def test_the_backend_names_the_model():
    with pytest.raises(ValueError, match="wavlm_ecapa"):
        gpu.GpuBackend(model="wavlm-base")
    assert gpu.CKPT_SLUG["wavlm_ecapa"] == "wavlm_ecapa"


def test_the_tower_variable_selects_the_model(monkeypatch):
    monkeypatch.setenv("SDTK_BACKEND_TOWER", "wavlm_ecapa")
    assert gpu.GpuBackend(device="cpu")._args[0] == "wavlm_ecapa"


# ── 5. spans and counters ────────────────────────────────────────────────


@pytest.fixture()
def profiled(monkeypatch):
    monkeypatch.setenv("SDTK_PROFILE", "1")
    profiling.reset()
    m = small_model(9)
    x, lens = clips(3, SR, 9, ragged=True)
    with torch.no_grad():
        m(x, lens)
    yield m, lens, dict(profiling._times), profiling.counters()
    profiling.reset()


@pytest.mark.parametrize("name", ["wavlm.extract", "wavlm.encoder", "wavlm.head"])
def test_spans_are_timed(profiled, name):
    assert len(profiled[2][name]) == 1


def test_counters(profiled):
    m, lens, _, c = profiled
    t = 49  # frames of a second
    frames = wavlm.frame_lengths(lens, m.cfg)
    assert c["wavlm.frames"] == 3 * t
    assert c["wavlm.pad_frames"] == 3 * t - int(frames.sum())
    assert c["wavlm.bias_bytes"] == 2 * 3 * 4 * t * 64 * 4  # 2 layers, rows padded to 64, f32


def test_a_tensor_count_waits_until_read(monkeypatch):
    monkeypatch.setenv("SDTK_PROFILE", "1")
    profiling.reset()
    profiling.count("x", torch.tensor(3))
    profiling.count("x", 2)
    assert profiling.counters()["x"] == 5 and profiling.counters()["x"] == 5
    profiling.reset()


# ── 6. the benchmark cell ────────────────────────────────────────────────


def test_the_benchmark_has_no_problem():
    bench = manifest.load()
    assert manifest.problems(bench) == []
    assert CELL in {w["name"] for w in bench["workloads"]}


def test_seeded_leaves_are_the_ports():
    """The benchmark's seeded tree loads into the port (the same leaves and
    shapes), in bfloat16 that both readers widen exactly."""
    cfg = dataclasses.asdict(WavLMEcapaConfig(**SMALL))
    tree = wavlm_weights.seeded_tree(cfg, 3, "cpu")
    spec = {"/".join(p): s for p, s, _ in wavlm_weights.leaves(cfg)}
    ours = checkpoint.ecapa_jax_tree(small_model().state_dict())
    assert {"/".join(p): s for p, s in _leaves(ours)} == spec
    assert all(v.dtype == torch.bfloat16 for _, v in _tensors(tree))


def _tensors(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensors(v, (*path, k))
        else:
            yield (*path, k), v


def test_seeded_file_is_read_by_both(tmp_path):
    cfg = {"name": "small", "model": dataclasses.asdict(WavLMEcapaConfig(**SMALL)),
           "weights": {"seed": 3}}
    path = wavlm_weights.weights_file(cfg, tmp_path, "cpu")
    m = WavLMEcapa(WavLMEcapaConfig(**SMALL))
    m.load_state_dict(checkpoint.ecapa_state_dict(checkpoint.read_msgpack(path)))
    from reference import flaxio

    tree = flaxio.read(path)
    assert np.array_equal(tree["params"]["proj"]["kernel"], m.proj.weight.detach().numpy().T)
    assert wavlm_weights.weights_file(cfg, tmp_path, "cpu") == path  # written once


def test_flops_count_the_products():
    """The count at the published widths: about 79 TFLOP for 256 clips of
    8 s, 85 % of it in the transformer's products."""
    m = manifest.cell(manifest.load(), CELL)["config"]["model"]
    total = wavlm_yardstick.flops_per_clip(m, 128000) * 256
    assert 75e12 < total < 82e12
    t, d = 399, 1024
    layers = 24 * 2 * (4 * t * d * d + 2 * t * d * 4096 + 2 * t * t * d) * 256
    assert 0.8 < layers / total < 0.9
    nbytes, flops = wavlm_yardstick.attention_work(256, t, m)
    assert flops == 4 * 256 * t * t * d and nbytes > 2 * 4 * 256 * t * d


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# a 10 000 µs window of one step: the encoder span (4 000 µs) launches two
# attention kernels of 1 000 µs and a GEMM; the device is busy 4 000 µs
CANNED = [
    _ev("user_annotation", "bench.window", 0, 10_000),
    _ev("user_annotation", "bench.embed", 0, 9000),
    _ev("user_annotation", "sdtk.wavlm.encoder", 1000, 4000),
    _ev("cuda_runtime", "cudaLaunchKernel", 1100, 5, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 1200, 5, corr=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 1300, 5, corr=3),
    _ev("kernel", "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7", 2000,
        1000, corr=1),
    _ev("kernel", "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7", 3000,
        1000, corr=2),
    _ev("kernel", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", 4000, 2000, corr=3),
]


@pytest.fixture()
def ctx(monkeypatch):
    monkeypatch.setattr(profiling, "_counts", {"wavlm.bias_bytes": 96_000_000})
    model = manifest.cell(manifest.load(), CELL)["config"]
    return SimpleNamespace(trace=trace.parse(CANNED),
                           work={"steps": 1, "clips": 256, "samples": 128000, "config": model})


def test_reader_step_mfu(ctx):
    flops = wavlm_yardstick.flops_per_clip(ctx.work["config"]["model"], 128000) * 256
    got = manifest.module("metrics", "step_mfu.wave").read(ctx)
    assert got == pytest.approx(100 * flops / 0.01 / 989e12)


def test_reader_rel_attn_roofline(ctx):
    nbytes, flops = wavlm_yardstick.attention_work(256, 399, ctx.work["config"]["model"])
    got = manifest.module("metrics", "rel_attn_roofline.wave").read(ctx)
    assert got == pytest.approx(100 * max(nbytes / 3.35e12, flops / 989e12) / 1e-3)


def test_reader_rel_bias_mb(ctx):
    assert manifest.module("metrics", "rel_bias_mb.wave").read(ctx) == pytest.approx(96.0)


def test_reader_encoder_issue_ms(ctx):
    assert manifest.module("metrics", "encoder_issue_ms.wave").read(ctx) == pytest.approx(4.0)


def test_reader_idle_share(ctx):
    assert manifest.module("metrics", "idle_share.wave").read(ctx) == pytest.approx(60.0)


@pytest.mark.parametrize("name", ["step_mfu.wave", "rel_attn_roofline.wave",
                                  "rel_bias_mb.wave", "encoder_issue_ms.wave",
                                  "idle_share.wave"])
def test_readers_return_nothing_without_a_trace(name):
    empty = SimpleNamespace(trace=trace.parse([]), work={})
    assert manifest.module("metrics", name).read(empty) is None


@pytest.mark.parametrize("traced", [0, 1])
def test_a_small_run_of_the_cell(tmp_path, monkeypatch, traced):
    """The cell's loop at a small size on the CPU: correct, and in a traced
    run the program's counter and span metrics read."""
    import run

    # the harness serves its weights through $SDTK_MODEL_PATH; set here
    # (empty reads as unset) so that it is unset again after the test, and
    # later tests in this process search the default paths
    monkeypatch.setenv("SDTK_MODEL_PATH", "")
    cell = manifest.cell(manifest.load(), CELL)
    cfg = dict(cell["config"], name="small-wavlm",
               model=dict(cell["config"]["model"], **{k: list(v) if isinstance(v, tuple) else v
                                                      for k, v in SMALL.items()}))
    cell = dict(cell, config=cfg, traffic=dict(cell["traffic"], batch=8, window_s=2.0,
                                               ragged_s=[1.0, 0.25], utterance_s=3.0,
                                               warmup_steps=1, trace_steps=1, check_steps=2))
    res = run.run_cell(cell, 2**31 + 23, 0.2, bool(traced), torch.device("cpu"),
                       t_start=time.perf_counter(), root=tmp_path)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(cell["limits"])
    if traced:
        assert {"rel_bias_mb.wave", "encoder_issue_ms.wave"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
