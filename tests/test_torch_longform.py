"""The port's long-form path (sdtk_tpu_torch/ops/longform.py,
pipeline/longform.py, ``cli.diarize --longform``) against the JAX
package's, world size by world size: the port on 1, 2 and 4 gloo ranks
(CPU processes, ``tests/torch_dist_workers.py``), JAX on a mesh of the
same size over the conftest's virtual CPU devices.  The window count, the
bucket padding and so the labels depend on the world size, so each size
is held against JAX's at that size.  Both sides run from the same
weights: a random ECAPA-64 from flax's init in float32 (a float32
sidecar), and the bundled 512-channel checkpoint, in float32 for the CLI
and in bf16, as it serves, for the silence-heavy case.  The port's
eigensolver starts from JAX's ``jax.random.normal(PRNGKey(0))`` matrix.
Tolerances are stated in each test."""

from __future__ import annotations

import shutil
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from sdtk_tpu.models import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models import EcapaTdnn as JaxEcapa
from sdtk_tpu.ops import fbank as jax_fbank
from sdtk_tpu.ops import longform as jax_longform
from sdtk_tpu.parallel import make_mesh
from sdtk_tpu.parallel import multihost as jax_multihost
from sdtk_tpu.pipeline.longform import LongformConfig as JaxLongformConfig
from sdtk_tpu.pipeline.longform import LongformDiarizer as JaxLongformDiarizer
from sdtk_tpu_torch.cluster.affinity import cosine_affinity, refine_affinity
from sdtk_tpu_torch.ops.fbank import FrontendConfig
from sdtk_tpu_torch.ops.longform import pad_for_sharding, sharded_log_mel
from sdtk_tpu_torch.parallel.multihost import host_work_shard
from sdtk_tpu_torch.pipeline.longform import LongformConfig, LongformDiarizer

MODELS = Path(__file__).resolve().parent.parent / "models"
SR = 16000
WORLDS = (1, 2, 4)
F32_SIDECAR = '{"model": {"dtype": "float32"}, "frontend": {"compute_dtype": "float32"}}'
LOG_MEL_CONFIGS = {
    "f32": {"compute_dtype": "float32"},
    "f32-raw": {"compute_dtype": "float32", "mean_norm": False},
    "bf16": {},
}


def _voice(freq, seconds, gain=0.4):
    t = np.arange(int(seconds * SR)) / SR
    x = sum((0.5 / (k + 1)) * np.sin(2 * np.pi * freq * (k + 1) * t) for k in range(4))
    return (gain * x / np.max(np.abs(x))).astype(np.float32)


def _pair():
    """tests/test_longform.py's 220 / 520 / 220 Hz harmonic pair, 12 s."""
    rng = np.random.default_rng(11)
    wav = np.concatenate([_voice(220, 4), _voice(520, 4), _voice(220, 4)])
    return wav + 0.005 * rng.standard_normal(len(wav)).astype(np.float32)


def _silence_heavy():
    """tests/test_longform.py's meeting with two 3 s silences, 15 s."""
    rng = np.random.default_rng(3)
    silence = (1e-4 * rng.standard_normal(SR * 3)).astype(np.float32)
    wav = np.concatenate([_voice(220, 3), silence, _voice(520, 3), silence, _voice(220, 3)])
    return wav + 1e-4 * rng.standard_normal(len(wav)).astype(np.float32)


def _log_mel_signal():
    rng = np.random.default_rng(0)
    n = 81920 - 333  # padded differently at each world size
    x = 0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / SR) + 0.02 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A random ECAPA-64 from flax's init and a copy of the bundled
    checkpoint, each with a float32 sidecar."""
    d = tmp_path_factory.mktemp("longform-ckpt")
    model = JaxEcapa(JaxEcapaConfig(channels=64, dtype="float32"))
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 100, 80)),
                           mask=jnp.ones((1, 100), bool))
    small = d / "ecapa64.msgpack"
    small.write_bytes(flax.serialization.msgpack_serialize(jax.device_get(dict(variables))))
    (d / "ecapa64.config.json").write_text(F32_SIDECAR)
    full = d / "ecapatdnn-fam5tel.msgpack"
    shutil.copy(MODELS / "ecapatdnn-fam5tel.msgpack", full)
    (d / "ecapatdnn-fam5tel.config.json").write_text(F32_SIDECAR)
    return {64: str(small), 512: str(full)}


def _cases(ckpt) -> dict:
    """name → (signal, LongformConfig fields, channels, checkpoint)."""
    pair = _pair()
    return {
        "pair": (pair, {"n_speakers": 2}, 64, ckpt[64]),
        "pair-auto": (pair, {}, 64, ckpt[64]),
        # trailing padding: 100 samples at every world size; 59, 219, 539
        "trim-100": (pair[:-100], {"n_speakers": 2}, 64, ckpt[64]),
        "extend-101": (np.concatenate([pair, pair[:101]]), {"n_speakers": 2}, 64, ckpt[64]),
        # the bundled checkpoint as it serves (bf16), as tests/test_longform.py
        # runs it: in f32 the energy gate keeps every window of this signal
        "silence-512": (_silence_heavy(), {}, 512, str(MODELS / "ecapatdnn-fam5tel.msgpack")),
    }


def _jax_starts() -> dict:
    """JAX's subspace start for every bucket size the cases reach."""
    return {(n, min(n, 17)): np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                          (n, min(n, 17)), jnp.float32))
            for n in range(16, 129, 8)}


_PORT_RUNS: dict = {}


@pytest.fixture(scope="module")
def port_runs(checkpoints):
    """world → every rank's results on all cases (one group of processes
    per world size, started on first use)."""
    payload = {
        "log_mel": {name: (_log_mel_signal(), kw) for name, kw in LOG_MEL_CONFIGS.items()},
        "affinity": np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32),
        "diarize": _cases(checkpoints),
        "starts": _jax_starts(),
    }

    def get(world):
        if world not in _PORT_RUNS:
            _PORT_RUNS[world] = workers.run_ranks(world, "longform_cases", payload)
        return _PORT_RUNS[world]

    yield get
    _PORT_RUNS.clear()


def _same_partition(a, b) -> bool:
    """Equal label tracks up to a permutation of the labels (−1 fixed)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a == -1, b == -1):
        return False
    pairs = set(zip(a[a >= 0].tolist(), b[b >= 0].tolist()))
    return len(pairs) == len({p[0] for p in pairs}) == len({p[1] for p in pairs})


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_log_mel_matches_one_rank_and_jax(port_runs, world):
    """Every rank returns the same (T, 80) features.  Without CMN they equal
    the port's own one-rank frontend (no group) on the same padded signal
    exactly; with CMN within 1e-5 (the order of the global sum).  Against
    JAX's ``sharded_log_mel`` on a mesh of the same size: f32 within 5e-4
    + 1e-4 relative (the bar tests/test_longform.py holds JAX's own sharded
    frontend to against its one-device one: low-power bins amplify the
    packages' different f32 sums through the log), bf16 within 0.05 (a
    power bin whose bf16 rounding flips between the two packages' f32 sums
    moves a narrow mel band by up to ~4e-3; the bar the kernel is held to
    on the card)."""
    ranks = port_runs(world)
    mesh = make_mesh(f"data={world}", jax.devices()[:world])
    x = _log_mel_signal()
    for name, kw in LOG_MEL_CONFIGS.items():
        got = ranks[0]["log_mel"][name]
        for other in ranks[1:]:
            assert np.array_equal(other["log_mel"][name], got), name
        cfg = FrontendConfig(**kw)
        xp = pad_for_sharding(x, world, cfg)
        one = sharded_log_mel(torch.from_numpy(xp.copy()), cfg).numpy()
        assert got.shape == one.shape == (cfg.num_frames(len(xp)), 80)
        if cfg.mean_norm:
            np.testing.assert_allclose(got, one, rtol=0, atol=1e-5, err_msg=name)
        else:
            assert np.array_equal(got, one), name
        want = np.asarray(jax_longform.sharded_log_mel(
            jnp.asarray(xp), mesh, jax_fbank.FrontendConfig(**kw)))
        tol = {"rtol": 1e-4, "atol": 5e-4} if "f32" in name else {"rtol": 0, "atol": 0.05}
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_affinity_matches_refine_and_jax(port_runs, world):
    """The gathered row blocks equal the port's one-device
    ``refine_affinity(cosine_affinity(·))`` and JAX's
    ``sharded_affinity_rows`` within 1e-6."""
    ranks = port_runs(world)
    emb = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)
    got = ranks[0]["affinity"]
    for other in ranks[1:]:
        assert np.array_equal(other["affinity"], got)
    want = refine_affinity(cosine_affinity(torch.from_numpy(emb))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    mesh = make_mesh(f"data={world}", jax.devices()[:world])
    jax_want = np.asarray(jax_longform.sharded_affinity_rows(jnp.asarray(emb), mesh))
    np.testing.assert_allclose(got, jax_want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["pair", "pair-auto", "trim-100", "extend-101", "silence-512"])
@pytest.mark.parametrize("world", WORLDS)
def test_longform_diarizer_matches_jax(port_runs, checkpoints, world, case):
    """The port's ``LongformDiarizer`` on ``world`` ranks against JAX's on a
    mesh of ``world`` devices: every rank returns the same result; the same
    speaker count, windows kept and window starts; the same window labels
    up to a permutation (−1 where the gate dropped a window); so the same
    segments after relabelling by first appearance."""
    wav, kw, channels, path = _cases(checkpoints)[case]
    ranks = port_runs(world)
    got = ranks[0]["diarize"][case]
    for other in ranks[1:]:
        assert other["diarize"][case] == got
    mesh = make_mesh(f"data={world}", jax.devices()[:world])
    want = JaxLongformDiarizer(mesh, JaxLongformConfig(**kw), channels=channels,
                               params_path=path).diarize_waveform(wav)
    assert got["mesh_devices"] == want["mesh_devices"] == world
    assert got["n_speakers"] == want["n_speakers"]
    assert got["windows_kept"] == want["windows_kept"]
    assert got["window_starts"] == want["window_starts"]
    assert _same_partition(got["window_labels"], want["window_labels"]), \
        (got["window_labels"], want["window_labels"])
    assert got["segments"] == [tuple(s) for s in want["segments"]]
    if case == "silence-512":  # the gate dropped the silences before clustering
        assert -1 in got["window_labels"] and got["windows_kept"] < len(got["window_labels"])


def test_world_sizes_agree_with_each_other(port_runs):
    """With the count given, 1, 2 and 4 ranks give the same partition of
    the windows they share.  The signal is padded to a multiple of world ·
    hop first, so ``extend-101`` has one more window (over the padding) at
    2 and 4 ranks, as in JAX.  With the count estimated the sizes need not
    agree: the bucket padding, max(8·world, 16) rows, enters the Laplacian
    in either package, and ``pair-auto`` counts 1 speaker at 4 ranks in
    both."""
    runs = {w: port_runs(w)[0]["diarize"] for w in WORLDS}
    for case in ("pair", "trim-100", "extend-101"):
        for w in WORLDS[1:]:
            a, b = runs[1][case], runs[w][case]
            assert a["n_speakers"] == b["n_speakers"] == 2
            n = len(a["window_labels"])
            assert len(b["window_labels"]) == n + (case == "extend-101")
            assert _same_partition(a["window_labels"], b["window_labels"][:n]), (case, w)
            assert b["window_starts"][:n] == a["window_starts"]


def test_one_rank_without_a_group_matches_a_group_of_one(port_runs, checkpoints):
    """No group at all (the default on one device) gives what a gloo group
    of one rank gives."""
    wav, kw, channels, path = _cases(checkpoints)["pair"]
    starts = _jax_starts()
    got = LongformDiarizer(LongformConfig(**kw), channels=channels, params_path=path,
                           device="cpu", subspace_start=lambda n, m: starts[n, m]
                           ).diarize_waveform(wav)
    assert set(got.pop("timings")) == {"frontend", "embed", "affinity", "eigensolve", "labels"}
    assert got == port_runs(1)[0]["diarize"]["pair"]


def test_window_starts_follow_the_frames_at_the_cli_hop(checkpoints):
    """At the CLI's 1.0 s / 0.375 s, windows step int(0.375 · 100) = 37
    frames.  Labels, counts and windows kept equal JAX's; the port places
    window i at i · 0.37 s, where its frames start, and JAX labels it
    i · 0.375 s (5 ms a window ahead)."""
    wav = _pair()
    path = checkpoints[64]
    starts = _jax_starts()
    got = LongformDiarizer(LongformConfig(window_seconds=1.0, hop_seconds=0.375, n_speakers=2),
                           channels=64, params_path=path, device="cpu",
                           subspace_start=lambda n, m: starts[n, m]).diarize_waveform(wav)
    want = JaxLongformDiarizer(make_mesh("data=1", jax.devices()[:1]),
                               JaxLongformConfig(window_seconds=1.0, hop_seconds=0.375,
                                                 n_speakers=2),
                               channels=64, params_path=path).diarize_waveform(wav)
    w = len(want["window_labels"])
    assert w == 1 + (1198 - 100) // 37  # 1 198 frames of 12 s
    assert got["windows_kept"] == want["windows_kept"]
    assert got["n_speakers"] == want["n_speakers"] == 2
    assert _same_partition(got["window_labels"], want["window_labels"])
    np.testing.assert_allclose(got["window_starts"], np.arange(w) * 0.37, rtol=0, atol=1e-12)
    np.testing.assert_allclose(want["window_starts"], np.arange(w) * 0.375, rtol=0, atol=1e-12)


def test_cli_longform_writes_the_jax_rttm(checkpoints, tmp_path, monkeypatch):
    """``cli.diarize --longform`` on 2 ranks, each started as a user starts
    it (the group from ``SDTK_*`` variables), against the JAX CLI on a mesh
    of 2: rank 0 writes the same RTTM byte for byte.  At 1.5 s / 0.75 s a
    window's hop is a whole number of frames, so the starts agree too."""
    import wave

    from sdtk_tpu.cli import diarize as jax_cli

    wav_path = tmp_path / "pair.wav"
    with wave.open(str(wav_path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes((np.clip(_pair(), -1, 1) * 32767).astype("<i2").tobytes())
    monkeypatch.setenv("SDTK_MODEL_PATH", checkpoints[512])
    args = [str(wav_path), "--longform", "--format", "rttm", "--window", "1.5", "--hop", "0.75",
            "--num-speakers", "2", "--recording-id", "pair", "-q"]
    real_make_mesh = make_mesh
    monkeypatch.setattr("sdtk_tpu.parallel.make_mesh",
                        lambda spec=None, devices=None: real_make_mesh("data=2", jax.devices()[:2]))
    assert jax_cli.main([*args, "--output", str(tmp_path / "jax.rttm")]) == 0
    payload = {"store": str(tmp_path / "cli-store"),
               "argv": [*args, "--device", "cpu", "--output", str(tmp_path / "port.rttm")]}
    assert workers.run_ranks(2, "cli_rank", payload) == [0, 0]
    want = (tmp_path / "jax.rttm").read_text()
    assert want.count("SPEAKER") >= 3
    assert (tmp_path / "port.rttm").read_text() == want


def test_host_work_shard_splits_as_jax(monkeypatch):
    """The MD5 split: every process count from 1 to 4, every process index,
    the same paths as JAX's ``host_work_shard``; the shards cover the list
    once."""
    paths = [f"/corpus/meeting_{i:03d}.wav" for i in range(40)]
    for n in range(1, 5):
        shards = []
        for pid in range(n):
            monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
            monkeypatch.setattr(jax, "process_count", lambda n=n: n)
            want = jax_multihost.host_work_shard(paths)
            got = host_work_shard(paths, pid, n)
            assert got == want
            shards += got
        assert sorted(map(str, shards)) == sorted(paths)
    assert host_work_shard(paths) == [Path(p) for p in paths]  # one process: everything


def test_process_corpus_queues_this_process_shard(tmp_path, speakers_dir, monkeypatch):
    """``process_corpus`` finds the corpus, queues the MD5 shard of this
    process (all of it without a group) and hands those items to the
    port's ``process_batch`` with the caller's options."""
    from conftest import make_wav

    from sdtk_tpu_torch.parallel import multihost
    from sdtk_tpu_torch.pipeline import process

    corpus = tmp_path / "corpus"
    (corpus / "sub").mkdir(parents=True)
    for i, name in enumerate(["a.wav", "b.wav", "sub/c.wav"]):
        make_wav(corpus / name, seconds=0.5, seed=i)
    seen = {}

    def fake_batch(items, queue=None, parallel=1, **kw):
        seen.update(items=items, parallel=parallel, **kw)
        return [process.ProcessResult(it["audio_path"], it["b3sum"], True) for it in items]

    monkeypatch.setattr(process, "process_batch", fake_batch)
    got = multihost.process_corpus(corpus, parallel=2, device="cpu")
    assert got == {"completed": 3, "failed": 0, "host_shard": 3, "corpus_total": 3}
    assert sorted(Path(it["audio_path"]).name for it in seen["items"]) == ["a.wav", "b.wav", "c.wav"]
    assert seen["parallel"] == 2 and seen["device"] == "cpu"
