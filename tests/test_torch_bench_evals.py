"""The port's speed harnesses beside their JAX scripts
(sdtk_tpu_torch/evals/benchmark_{topk,frontend,decode}.py and
run_matrix.sh against evals/):

1. topk: at W 8, N 4 096, D 32, k 16 the port's survivors on the CPU (K2's
   plain version) equal ``identify_topk_pallas``'s in interpret mode, scores
   within 1e-5 (both f32 products of the same bf16 rows); the command's
   line maps onto the JAX script's keys, and its hard gate exits 1 when
   the survivor rows, or the scores beyond 5e-2, differ;
2. frontend: at (2, 16 000) in f32 the port's three functions (plain
   log-mel, frames -> K4's plain version, K1's plain version) equal JAX's
   (``fbank.log_mel``, ``fbank_frames.log_mel_fused`` and ``log_mel_wave``,
   the Pallas kernels in interpret mode) within 2e-3 (the kernel phase's
   f32 bar); the line's keys map one to one onto the JAX script's;
3. decode: 2 files of 0.5 s at 44.1 kHz, written byte-equal to the JAX
   script's; ``load_audio_batch`` equals JAX's, bit for bit (JAX's side in
   a fresh interpreter with its C++ library, ``tests/torch_jax_native.py``),
   and so does the NumPy path; the line's keys equal the JAX script's;
4. run_matrix.sh runs ``evals.der`` with the 8 argument lists of
   ``evals/run_matrix.sh`` (both scripts run with a stub ``python``).
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.ops import fbank as jfbank
from sdtk_tpu.ops.research import fbank_frames as jframes
from sdtk_tpu.ops.research.fbank_wave import log_mel_wave as jax_log_mel_wave
from sdtk_tpu.ops.research.topk_pallas import identify_topk_pallas
from sdtk_tpu.utils import audio as jaudio
from sdtk_tpu_torch.evals import benchmark_decode as bd
from sdtk_tpu_torch.evals import benchmark_frontend as bf
from sdtk_tpu_torch.evals import benchmark_topk as bt
from sdtk_tpu_torch.ops.fbank import FrontendConfig
from sdtk_tpu_torch.utils import audio
from torch_jax_native import REPO, run_jax

EVALS = REPO / "evals"
W, N, DIM, K = 8, 4096, 32, 16


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", EVALS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv) -> tuple[int, dict, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


# -- topk --------------------------------------------------------------------

def _topk_inputs():
    rng = np.random.default_rng(0)  # the scripts' order: queries, then profiles
    q = rng.standard_normal((W, DIM)).astype(np.float32)
    p, p_norm = bt.profiles(rng, N, DIM, torch.device("cpu"))
    return q, p, p_norm


def test_topk_survivors_equal_pallas():
    q, p, _ = _topk_inputs()
    s, i = bt.identify_topk_fused(torch.from_numpy(q), p, K)
    p_jax = jnp.asarray(p.float().numpy(), jnp.bfloat16)  # the same bf16 rows
    s_pl, i_pl = identify_topk_pallas(jnp.asarray(q), p_jax, k=K, interpret=True)
    assert set(i.tolist()) == set(np.asarray(i_pl).tolist())
    np.testing.assert_allclose(np.sort(s.numpy()), np.sort(np.asarray(s_pl)), atol=1e-5, rtol=0)


ARGV = ["--n", str(N), "--windows", str(W), "--dim", str(DIM), "--k", str(K), "--iters", "2",
        "--device", "cpu"]
TOPK_KEYS = {"pallas_ms": "k2_ms", "xla_ms": "library_ms", "pallas_wins_all": "k2_wins_all"}


def test_topk_line_and_gate_pass():
    rc, line, err = _run(bt.main, ARGV)
    assert rc == 0 and not err
    row = line["sizes"][str(N)]
    assert row["survivor_overlap"] == 1.0 and row["max_score_diff"] <= bt.SCORE_BAR
    assert line["parity_ok"] is True and line["tile_n"] == 512
    # the JAX script's keys, renamed where the port runs another function
    src = (EVALS / "benchmark_topk.py").read_text()
    jax_keys = {k for k in ("benchmark", "windows", "dim", "k", "tile_n", "backend", "sizes",
                            "pallas_ms", "xla_ms", "speedup", "survivor_overlap",
                            "max_score_diff", "pallas_wins_all", "parity_ok")
                if f'"{k}"' in src}
    assert len(jax_keys) == 14
    port_keys = set(line) | set(row)
    assert {TOPK_KEYS.get(k, k) for k in jax_keys} <= port_keys


@pytest.mark.parametrize("fault", ["rows", "scores"])
def test_topk_gate_fails_on_differing_survivors(fault, monkeypatch):
    real = bt.identify_topk_fused

    def wrong(q, p, k):
        s, i = real(q, p, k)
        return (s, (i + 1) % p.shape[0]) if fault == "rows" else (s + 0.1, i)

    monkeypatch.setattr(bt, "identify_topk_fused", wrong)
    rc, line, err = _run(bt.main, ARGV)
    assert rc == 1 and line["parity_ok"] is False and "PARITY FAILURE" in err
    row = line["sizes"][str(N)]
    if fault == "rows":
        assert row["survivor_overlap"] < 1.0
    else:
        assert row["survivor_overlap"] == 1.0 and row["max_score_diff"] > bt.SCORE_BAR


# -- frontend ----------------------------------------------------------------

def test_frontend_functions_equal_jax():
    x = np.random.default_rng(0).standard_normal((2, 16000)).astype(np.float32)
    cfg = FrontendConfig(compute_dtype="float32")
    jcfg = jfbank.FrontendConfig(compute_dtype="float32")
    want = {"torch": jfbank.log_mel(jnp.asarray(x), jcfg)[0],
            "k4_frames": jframes.log_mel_fused(jnp.asarray(x), jcfg)[0],
            "k1_wave": jax_log_mel_wave(jnp.asarray(x), jcfg)[0]}
    fns = bf.functions(cfg)
    assert set(fns) == set(want) == set(bf.FUNCTIONS)
    for name, fn in fns.items():
        got = fn(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 98, 80)
        np.testing.assert_allclose(got, np.asarray(want[name]), atol=2e-3, rtol=0,
                                   err_msg=name)


# the port's line's keys -> the JAX script's (the module's docstring maps them)
FRONTEND_KEYS = {"benchmark": "benchmark", "batch": "batch", "seconds": "seconds",
                 "torch_ms": "xla_ms", "k4_frames_ms": "pallas_frames_ms",
                 "k1_wave_ms": "pallas_wave_ms",
                 "wave_vs_torch_max_abs_err": "wave_vs_xla_max_abs_err",
                 "k1_frames_per_block": "chunk_rows", "backend": "backend", "winner": "winner"}


def test_frontend_keys_map_onto_jax():
    tree = ast.parse((EVALS / "benchmark_frontend.py").read_text())
    jax_keys = {"winner"}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "results" for t in node.targets)):
            jax_keys |= {k.value for k in node.value.keys}
    assert set(FRONTEND_KEYS.values()) == jax_keys
    assert len(set(FRONTEND_KEYS.values())) == len(FRONTEND_KEYS)  # one to one
    rc, line, err = _run(bf.main, ["--batch", "2", "--seconds", "1", "--iters", "2",
                                   "--device", "cpu"])
    assert rc == 0 and not err
    added = {"frames_vs_torch_max_abs_err", "tol", "frames", "launches",
             *(f"{f}_device_ms" for f in bf.FUNCTIONS)}
    assert set(line) == set(FRONTEND_KEYS) | added
    assert line["winner"] in bf.FUNCTIONS and line["frames"] == 2 * 98
    assert line["wave_vs_torch_max_abs_err"] <= bf.TOL
    assert line["frames_vs_torch_max_abs_err"] <= bf.TOL
    assert line["launches"] == {"log_mel_wave": 0, "fbank_frames": 0}  # CPU: plain versions


# -- decode ------------------------------------------------------------------

_JAX_DECODE = r"""
import contextlib, io, json, sys
import numpy as np
from sdtk_tpu.utils import audio
from sdtk_tpu.utils.nativelib import get_lib
job = json.loads(sys.argv[1])
if get_lib() is None:
    print(json.dumps({"native": False})); sys.exit(0)
np.savez(job["out"], *audio.load_audio_batch(job["paths"], target_sr=16000))
sys.path.insert(0, job["evals"])
import benchmark_decode
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    benchmark_decode.main(job["argv"])
line = json.loads(buf.getvalue().splitlines()[-1])
print(json.dumps({"native": True, "keys": sorted(line),
                  "sweep": sorted(line.get("thread_sweep_audio_s_per_s", {}))}))
"""


def test_decode_equals_jax(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir(), theirs.mkdir()
    paths = bd.make_wavs(ours, 2, 0.5, 44100)
    jax_paths = _jax_script("benchmark_decode").make_wavs(theirs, 2, 0.5, 44100)
    assert [p.read_bytes() for p in paths] == [p.read_bytes() for p in jax_paths]

    argv = ["--files", "2", "--seconds", "0.5", "--thread-sweep"]
    out = run_jax(_JAX_DECODE, {"paths": [str(p) for p in paths], "out": str(tmp_path / "j.npz"),
                                "evals": str(EVALS), "argv": argv})
    want = np.load(tmp_path / "j.npz")
    got = audio.load_audio_batch(paths, target_sr=16000)
    assert len(got) == len(want.files) == 2
    for g, name in zip(got, want.files):
        assert g.shape == (8000,) and np.array_equal(g, want[name])

    serial = bd.numpy_serial(paths)
    for g, p in zip(serial, paths):
        x, sr = jaudio._decode_wav(p)
        np.testing.assert_array_equal(g, jaudio.resample(x.mean(axis=1), sr, 16000))

    rc, line, _ = _run(bd.main, [*argv, "--device", "cpu"])
    assert rc == 0
    assert sorted(line) == out["keys"]
    assert sorted(line["thread_sweep_audio_s_per_s"]) == out["sweep"]
    assert line["per_core_audio_s_per_s"] > 0 and 0 < line["core_scaling_efficiency"]


def test_decode_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bd.main(["--files", "1", "--seconds", "0.1"])


# -- the DER matrix ----------------------------------------------------------

def _matrix_args(script: Path, tmp_path: Path, name: str) -> list[list[str]]:
    """The argument lists ``script`` gives its 8 runs, through a stub
    ``python`` that records them (the part before ``--backend`` dropped)."""
    stub_dir = tmp_path / f"bin-{name}"
    stub_dir.mkdir()
    log = tmp_path / f"{name}.log"
    stub = stub_dir / "python"
    stub.write_text(f'#!/bin/sh\nprintf "%s\\n" "$*" >> "{log}"\n')
    stub.chmod(0o755)
    env = {**os.environ, "PATH": f"{stub_dir}:{os.environ['PATH']}", "BACKEND": "X"}
    env.pop("PYTHON", None)
    subprocess.run(["bash", str(script), "--meetings", "1"], env=env, check=True,
                   capture_output=True, timeout=60)
    runs = [ln.split() for ln in log.read_text().splitlines()]
    return [r[r.index("--backend"):] for r in runs], [r[:r.index("--backend")] for r in runs]


def test_run_matrix_runs_jax_argument_lists(tmp_path):
    port, port_heads = _matrix_args(REPO / "sdtk_tpu_torch" / "evals" / "run_matrix.sh",
                                    tmp_path, "port")
    jax_, jax_heads = _matrix_args(EVALS / "run_matrix.sh", tmp_path, "jax")
    assert len(port) == len(jax_) == 8
    assert port == jax_
    assert port[0] == ["--backend", "X", "--meetings", "1"]
    assert all(h == ["-m", "sdtk_tpu_torch.evals.der"] for h in port_heads)
    assert all(h == ["evals/benchmark_der.py"] for h in jax_heads)


def test_run_matrix_backend_defaults_to_gpu():
    text = (REPO / "sdtk_tpu_torch" / "evals" / "run_matrix.sh").read_text()
    assert "B=${BACKEND:-gpu}" in text
