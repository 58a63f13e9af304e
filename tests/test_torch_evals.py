"""The port's held-out evaluation and calibration (sdtk_tpu_torch/evals/
{eer,calibrate,der}.py) against the JAX package's scripts
(evals/benchmark_eer.py, calibrate_threshold.py, benchmark_der.py):

1. ``eer_point`` equal to the JAX script's (exact).
2. With the ``fake`` backend (NumPy, the same vectors in both packages)
   each module prints the JAX script's JSON line, wall-time fields aside,
   and the calibration writes the same sidecars byte for byte.
3. With one narrow random ECAPA in float32, written as a flax msgpack and
   read by ``utils/checkpoint.py``: ``GpuBackend(device="cpu")`` embeds
   the held-out utterances as ``TpuBackend`` does (within 1e-5), the EER
   and calibration fields agree within 1e-3, and the sidecar one package
   writes is read alike by both backends.
4. The calibration writes nothing under ``models/``.
"""

from __future__ import annotations

import json
import runpy
import shutil
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdtk_tpu.backends import base as jbase
from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu_torch.backends import base
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.data.synth_heldout import heldout_utterance
from sdtk_tpu_torch.evals import calibrate, der, eer

REPO = Path(__file__).resolve().parent.parent
EVALS = REPO / "evals"
WALL = ("wall_seconds", "audio_s_per_s")
TOWER = {"channels": 64, "se_bottleneck": 32, "attention_channels": 32, "mfa_channels": 192,
         "dtype": "float32"}


def _jax_script(name: str, argv: list[str], monkeypatch, capsys) -> dict:
    """Run ``evals/<name>`` as ``python evals/<name> argv`` does, in this
    process; its JSON line."""
    monkeypatch.setattr(sys, "argv", [str(EVALS / name), *argv])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(EVALS / name), run_name="__main__")
    assert done.value.code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port(module, argv: list[str], capsys) -> dict:
    assert module.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def fresh_backends(monkeypatch):
    """Each test builds its backends anew in both registries."""
    monkeypatch.setattr(base, "_instances", {})
    monkeypatch.setattr(jbase, "_instance_cache", {})


@pytest.fixture()
def models_untouched():
    """Fails the test if anything under ``models/`` was written."""
    before = {p: p.stat().st_mtime_ns for p in (REPO / "models").rglob("*")}
    yield
    assert {p: p.stat().st_mtime_ns for p in (REPO / "models").rglob("*")} == before


def test_eer_point_equals_jax():
    """The calibration's threshold sweep: equal (eer, threshold) on random
    and on tied, separable and overlapping score sets."""
    jax_eer_point = runpy.run_path(str(EVALS / "calibrate_threshold.py"))["eer_point"]
    rng = np.random.default_rng(0)
    cases = [(rng.normal(0.7, 0.1, 96), rng.normal(0.2, 0.15, 1440)),
             (rng.normal(0.4, 0.2, 50), rng.normal(0.35, 0.2, 400)),
             (np.full(8, 0.9), np.full(24, 0.1)),
             (np.round(rng.uniform(0, 1, 30), 1), np.round(rng.uniform(0, 1, 60), 1))]
    for gen, imp in cases:
        assert calibrate.eer_point(gen, imp) == jax_eer_point(gen, imp)


@pytest.mark.parametrize("argv", [
    ["--speakers", "4", "--trials-per-speaker", "2"],
    ["--speakers", "5", "--trials-per-speaker", "3", "--tier", "noise", "--snr-db", "5"],
    ["--speakers", "4", "--trials-per-speaker", "2", "--tier", "reverb", "--seconds", "2"],
    ["--speakers", "4", "--trials-per-speaker", "2", "--tier", "telephone"],
])
def test_eer_fake_prints_the_jax_json(argv, monkeypatch, capsys):
    want = _jax_script("benchmark_eer.py", ["--backend", "fake", *argv], monkeypatch, capsys)
    got = _port(eer, ["--backend", "fake", "--device", "cpu", *argv], capsys)
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--speakers", "4", "--trials-per-speaker", "2", "--cohort-size", "0"],
    ["--speakers", "4", "--trials-per-speaker", "2", "--cohort-size", "8",
     "--families", "0,1,2", "--augment-prob", "0.5"],
    ["--speakers", "3", "--trials-per-speaker", "2", "--cohort-size", "8", "--augment-prob", "0",
     "--base-id", "700000", "--seconds", "1.5"],
])
def test_calibrate_fake_prints_the_jax_json_and_sidecars(argv, tmp_path, monkeypatch, capsys,
                                                         models_untouched):
    """The JSON line, the ``.calib.json`` and the ``.cohort.npy`` (when a
    cohort is asked for) equal the JAX script's, byte for byte."""
    want = _jax_script("calibrate_threshold.py",
                       ["--backend", "fake", *argv, "--out", str(tmp_path / "jax.calib.json")],
                       monkeypatch, capsys)
    got = _port(calibrate, ["--backend", "fake", "--device", "cpu", *argv,
                            "--out", str(tmp_path / "port.calib.json")], capsys)
    assert got == want
    for suffix in (".calib.json", ".cohort.npy"):
        if suffix == ".cohort.npy" and got["cohort_size"] == 0:
            assert not (tmp_path / f"port{suffix}").exists()
            continue
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()


def test_calibrate_without_a_checkpoint_asks_for_out(capsys):
    """The fake backend has no checkpoint: without ``--out`` nothing is
    written and the exit code is 1, as in JAX."""
    assert calibrate.main(["--backend", "fake", "--device", "cpu", "--speakers", "2",
                           "--trials-per-speaker", "1", "--cohort-size", "0"]) == 1
    assert "use --out" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--meetings", "1", "--turns", "4"],
    ["--meetings", "2", "--turns", "3", "--heldout", "--tier", "noise", "--overlap-frac", "0.3",
     "--gap-frac", "0.3", "--collars", "0.75,0.25,0.0"],
    ["--meetings", "1", "--turns", "4", "--heldout", "--tier", "telephone", "--known-k",
     "--no-boundary-refine", "--detect-overlap"],
])
def test_der_fake_prints_the_jax_json(argv, monkeypatch, capsys):
    want = _jax_script("benchmark_der.py", ["--backend", "fake", *argv], monkeypatch, capsys)
    got = _port(der, ["--backend", "fake", "--device", "cpu", *argv], capsys)
    for key in WALL:
        assert got.pop(key) > 0
        want.pop(key)
    assert got == want


def test_der_corpus_route_prints_the_jax_json(tmp_path, monkeypatch, capsys):
    """``--corpus DIR`` over a WAV + RTTM tree of two meetings (and one WAV
    without a reference): the JAX script's line with its per-recording
    DER."""
    from sdtk_tpu_torch.utils.audio import save_wav

    root = tmp_path / "corpus"
    (root / "audio").mkdir(parents=True)
    (root / "rttm").mkdir()
    for m in range(2):
        wav, ref = der.build_meeting(m, 2, 3, 2.0, heldout=True)
        save_wav(root / "audio" / f"mtg{m}.wav", wav)
        (root / "rttm" / f"mtg{m}.rttm").write_text("".join(
            f"SPEAKER mtg{m} 1 {a:.3f} {b - a:.3f} <NA> <NA> {lab} <NA> <NA>\n"
            for a, b, lab in ref))
    save_wav(root / "audio" / "noref.wav", np.zeros(8000, np.float32))
    want = _jax_script("benchmark_der.py", ["--backend", "fake", "--corpus", str(root)],
                       monkeypatch, capsys)
    got = _port(der, ["--backend", "fake", "--device", "cpu", "--corpus", str(root)], capsys)
    for key in WALL:
        got.pop(key), want.pop(key)
    assert got == want
    assert sorted(got["per_recording_der"]) == ["mtg0", "mtg1"]
    assert der.main(["--backend", "fake", "--device", "cpu", "--corpus",
                     str(tmp_path / "corpus" / "rttm")]) == 1


@pytest.mark.parametrize("kw", [
    {},
    {"heldout": True, "tier": "music", "overlap_frac": 0.5, "gap_frac": 0.5},
    {"heldout": True, "tier": "reverb", "snr_db": 5.0},
])
def test_build_meeting_equals_jax(kw):
    jax_build = runpy.run_path(str(EVALS / "benchmark_der.py"))["build_meeting"]
    got_wav, got_ref = der.build_meeting(1, 3, 5, 2.0, **kw)
    want_wav, want_ref = jax_build(1, 3, 5, 2.0, **kw)
    np.testing.assert_array_equal(got_wav, want_wav)
    assert got_ref == want_ref


# -- a narrow ECAPA in float32, through both packages' backends ---------------

@pytest.fixture(scope="module")
def narrow_checkpoint(tmp_path_factory):
    """A random narrow ECAPA (BatchNorm statistics redrawn) as a flax
    msgpack with a float32 config sidecar, and no calibration."""
    d = tmp_path_factory.mktemp("narrow")
    v = jax.jit(JaxEcapa(JaxEcapaConfig(**TOWER)).init)(jax.random.PRNGKey(7),
                                                       jnp.zeros((1, 64, 80)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(8)

    def redraw(t):
        return {k: redraw(x) if isinstance(x, dict) else
                (np.abs(rng.standard_normal(x.shape)) + 0.5 if k == "var"
                 else 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
                for k, x in t.items()}

    path = d / "narrow.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"params": v["params"], "batch_stats": redraw(v["batch_stats"])}))
    path.with_suffix(".config.json").write_text(json.dumps(
        {"model": TOWER, "frontend": {"compute_dtype": "float32"}}))
    return path


def test_heldout_embeddings_match_tpu_backend(narrow_checkpoint):
    """``embed_batch`` of 3 s held-out utterances (one window each: the
    batched route) and of 2 s ones: within 1e-5 of ``TpuBackend``'s."""
    port = GpuBackend(channels=64, params_path=narrow_checkpoint, device="cpu")
    ref = TpuBackend(channels=64, params_path=narrow_checkpoint)
    for seconds in (3.0, 2.0):
        wavs = [heldout_utterance(s, u, seconds) for s in range(3) for u in range(2)]
        got, want = port.embed_batch(wavs), np.asarray(ref.embed_batch(wavs))
        assert got.shape == want.shape == (6, 192)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _close(got: dict, want: dict, atol: float = 1e-3) -> None:
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert abs(g - w) <= atol, (key, g, w)
        elif isinstance(w, list) and w and isinstance(w[0], dict):
            for a, b in zip(g, w):
                _close(a, b, atol)
        else:
            assert g == w, key


def test_calibrate_and_eer_on_a_narrow_ecapa_match_jax(narrow_checkpoint, tmp_path, monkeypatch,
                                                       capsys, models_untouched):
    """``calibrate`` with a cohort, then ``eer`` scored through that
    calibration, in both packages on the same float32 tower: every field
    within 1e-3.  Each package's backend then reads the port's sidecars
    as the other does: merge bar, decision threshold, calibrated scores
    and the cohort."""
    ckpt = tmp_path / "narrow.msgpack"
    shutil.copy(narrow_checkpoint, ckpt)
    shutil.copy(narrow_checkpoint.with_suffix(".config.json"), ckpt.with_suffix(".config.json"))
    monkeypatch.setenv("SDTK_MODEL_PATH", str(ckpt))
    args = ["--speakers", "4", "--trials-per-speaker", "2", "--cohort-size", "8",
            "--families", "0,1"]
    want = _jax_script("calibrate_threshold.py",
                       ["--backend", "tpu", *args, "--out", str(tmp_path / "jax.calib.json")],
                       monkeypatch, capsys)
    # the default --out: next to the checkpoint (a copy, never models/)
    got = _port(calibrate, ["--backend", "gpu", "--device", "cpu", *args], capsys)
    want["backend"] = "gpu"
    _close(got, want)
    assert ckpt.with_suffix(".calib.json").exists()
    np.testing.assert_allclose(np.load(tmp_path / "narrow.cohort.npy"),
                               np.load(tmp_path / "jax.cohort.npy"), rtol=0, atol=1e-5)

    monkeypatch.setattr(base, "_instances", {})
    monkeypatch.setattr(jbase, "_instance_cache", {})
    eer_args = ["--speakers", "4", "--trials-per-speaker", "2", "--tier", "telephone"]
    want = _jax_script("benchmark_eer.py", ["--backend", "tpu", *eer_args], monkeypatch, capsys)
    got = _port(eer, ["--backend", "gpu", "--device", "cpu", *eer_args], capsys)
    assert "scored_eer" in got and got["scored_uses_asnorm"]
    want["backend"] = "gpu"
    _close(got, want)

    port = GpuBackend(channels=64, params_path=ckpt, device="cpu")
    ref = TpuBackend(channels=64, params_path=ckpt)
    tau = json.loads(ckpt.with_suffix(".calib.json").read_text())["suggested_merge_tau"]
    assert port.cluster_merge_tau == ref.cluster_merge_tau == tau
    assert port.raw_decision_threshold == ref.raw_decision_threshold
    np.testing.assert_array_equal(port.cohort, ref.cohort)
    sims = np.linspace(-0.2, 1.0, 25, dtype=np.float32)
    np.testing.assert_allclose(port.calibrate_score(sims), ref.calibrate_score(sims),
                               rtol=0, atol=1e-6)
    q = np.random.default_rng(2).standard_normal((5, 192)).astype(np.float32)
    p = np.random.default_rng(3).standard_normal((7, 192)).astype(np.float32)
    np.testing.assert_allclose(port.score_matrix(q, p), np.asarray(ref.score_matrix(q, p)),
                               rtol=0, atol=1e-4)
