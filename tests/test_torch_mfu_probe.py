"""The port's MFU probe (sdtk_tpu_torch/evals/mfu_probe.py) against
evals/mfu_probe.py, imported by path: the same analytic FLOP counts for
the towers and frontends it reports, and its command on the CPU at a tiny
batch (rows with the JAX script's keys; ``mfu`` is null off the card)."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.ops.fbank import FrontendConfig as JaxFrontendConfig
from sdtk_tpu_torch.evals import mfu_probe
from sdtk_tpu_torch.models.ecapa import EcapaConfig
from sdtk_tpu_torch.ops.fbank import FrontendConfig
from sdtk_tpu_torch.tools.convert_ecapa import SB_FRONTEND

REPO = Path(__file__).resolve().parent.parent


def _jax_probe():
    spec = importlib.util.spec_from_file_location("jax_mfu_probe", REPO / "evals" / "mfu_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOWERS = {
    "c512-s8": {"channels": 512},
    "c512-s4": {"channels": 512, "scale": 4},
    "c1024-published": {"channels": 1024, "mfa_channels": 3072, "mfa_bn": True,
                        "asp_tdnn": True},
}


@pytest.mark.parametrize("n_frames", [101, 298])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_ecapa_flops_equal_jax(tower, n_frames):
    want = _jax_probe().ecapa_flops_per_window(JaxEcapaConfig(**TOWERS[tower]), n_frames)
    got = mfu_probe.ecapa_flops_per_window(EcapaConfig(**TOWERS[tower]), n_frames)
    assert got == want
    if tower == "c1024-published" and n_frames == 101:  # 1 s at SpeechBrain's framing
        assert round(got / 1e9, 2) == 3.79


@pytest.mark.parametrize("frontend", ["default", "speechbrain"])
def test_frontend_flops_equal_jax(frontend):
    kw = SB_FRONTEND if frontend == "speechbrain" else {}
    fcfg, jcfg = FrontendConfig(**kw), JaxFrontendConfig(**kw)
    n_frames = fcfg.num_frames(48000)
    assert n_frames == jcfg.num_frames(48000)
    assert (mfu_probe.frontend_flops_per_window(fcfg, n_frames)
            == _jax_probe().frontend_flops_per_window(jcfg, n_frames))


def test_main_on_cpu_prints_rows():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mfu_probe.main(["--stages", "frontend,tower,tower_s4,full", "--batches", "2",
                             "--iters", "2", "--seconds", "0.5", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    rows, last = lines[:-1], lines[-1]
    assert last["benchmark"] == "mfu_probe" and last["rows"] == rows
    assert last["device"] == "cpu" and last["launches"] == {"log_mel_wave": 0, "cosine": 0,
                                                         "identify_topk": 0, "fbank_frames": 0,
                                                         "tower_epilogue": 0}
    assert [r["stage"] for r in rows] == ["frontend", "tower", "tower_s4", "full"]
    for r in rows:
        assert {"stage", "batch", "ms", "audio_s_per_s", "mfu"} <= set(r)
        assert r["batch"] == 2 and r["ms"] > 0 and r["mfu"] is None
    n_frames = FrontendConfig().num_frames(8000)
    assert rows[1]["flops"] == 2 * mfu_probe.ecapa_flops_per_window(EcapaConfig(), n_frames)


def test_main_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mfu_probe.main(["--batches", "1", "--iters", "1"])
