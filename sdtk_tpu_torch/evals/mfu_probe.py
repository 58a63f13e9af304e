"""MFU decomposition probe: the serving pipeline stage by stage at the
requested batch sizes, each stage's ms and its achieved FLOP/s against
the card's dense bf16 peak.

The counterpart of ``evals/mfu_probe.py``, with its analytic FLOP counts
(:func:`ecapa_flops_per_window`, :func:`frontend_flops_per_window`):

  frontend   log-mel only: ``ops/fbank_wave.py:log_mel_wave`` (K1)
  tower      ECAPA-512 on precomputed features, on the device
  tower_s4   the same at Res2 scale 4 (64 → 128 channels a group conv;
             random weights, a what-if of the architecture)
  full       frontend + tower + L2, the serving step

Each stage runs ``--iters`` steps, each chained on the one before (the
next input depends on the last output, so no step can be skipped or
overlapped), timed by CUDA events (``tools/measure.py:event_ms``); on
``--device cpu`` by the host clock, and ``mfu`` is null there (the peak
is the card's).

  python -m sdtk_tpu_torch.evals.mfu_probe --stages frontend,tower \\
      --batches 1024,2048 [--device cuda]

Prints one JSON row a (stage, batch), then ``{"benchmark": "mfu_probe",
"rows": [...], "device": ..., "launches": ...}`` last, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 (tensor cores)


def ecapa_flops_per_window(cfg, n_frames: int) -> float:
    """Analytic MACs×2 for one window through ECAPA (conv + attention
    matmuls; elementwise ignored)."""
    C, S = cfg.channels, cfg.scale
    w = C // S
    f = 0.0
    f += n_frames * 5 * cfg.n_mels * C            # stem k=5
    for _ in cfg.dilations:                        # 3 SE-Res2 blocks
        f += n_frames * C * C                      # tdnn_in 1x1
        f += (S - 1) * n_frames * 3 * w * w        # res2 convs k=3
        f += n_frames * C * C                      # tdnn_out 1x1
        f += C * cfg.se_bottleneck * 2             # SE squeeze/excite
    f += n_frames * 3 * C * cfg.mfa_channels       # MFA 1x1 (3C concat in)
    f += n_frames * 3 * cfg.mfa_channels * cfg.attention_channels  # att1
    f += n_frames * cfg.attention_channels * cfg.mfa_channels      # att2
    f += 2 * cfg.mfa_channels * cfg.emb_dim        # embedding
    return 2.0 * f


def frontend_flops_per_window(fcfg, n_frames: int) -> float:
    n_freqs = fcfg.n_fft // 2 + 1
    per_frame = 2 * (fcfg.win_length * n_freqs * 2 + n_freqs * fcfg.n_mels)
    return float(n_frames * per_frame)


def bench(fn, arr, iters: int, device) -> float:
    """Seconds per step of ``iters`` steps of ``fn``, each fed ``arr`` plus
    1e-30 times a value of the step before (so the steps run in order and
    none can be skipped)."""
    def run():
        a = arr
        for _ in range(iters):
            out = fn(a)
            a = arr + out.reshape(-1)[0].float() * 1e-30
        return a

    if device.type == "cuda":
        from ..tools.measure import event_ms

        return event_ms(run, reps=3, warmup=1) / 1e3 / iters
    run()
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) / iters


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, else torch's
    name of it; "cpu" for the CPU."""
    import subprocess

    import torch

    if device.type != "cuda":
        return "cpu"
    from ..tools.measure import smi

    try:
        return smi("name,power.limit")
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.mfu_probe")
    ap.add_argument("--stages", default="frontend,tower,full")
    ap.add_argument("--batches", default="512,1024,2048")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")
    batches = [int(b) for b in args.batches.split(",")]

    import torch

    from ..models.ecapa import EcapaConfig, EcapaTdnn, l2_normalize
    from ..ops import fbank_wave
    from ..ops.fbank import FrontendConfig
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    fcfg = FrontendConfig()
    n = int(args.seconds * fcfg.sample_rate)
    n_frames = fcfg.num_frames(n)
    rng = np.random.default_rng(0)

    def tower(scale: int = 8):
        cfg = EcapaConfig(channels=512, scale=scale)
        model = EcapaTdnn(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return cfg, model.to(device).eval()

    fbank_wave.log_mel_wave.launches = 0
    results = []
    for batch in batches:
        wav = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32)).to(device)
        feats = torch.from_numpy(
            rng.standard_normal((batch, n_frames, fcfg.n_mels)).astype(np.float32)).to(device)

        for stage in stages:
            if stage == "frontend":
                def fn(a):
                    return fbank_wave.log_mel_wave(a, fcfg)[0]
                arg = wav
                flops = frontend_flops_per_window(fcfg, n_frames) * batch
            elif stage in ("tower", "tower_s4"):
                mcfg, model = tower(4 if stage == "tower_s4" else 8)
                fn, arg = model, feats
                flops = ecapa_flops_per_window(mcfg, n_frames) * batch
            elif stage == "full":
                mcfg, model = tower()

                def fn(a, model=model):
                    fe, mask = fbank_wave.log_mel_wave(a, fcfg)
                    return l2_normalize(model(fe, mask))
                arg = wav
                flops = (frontend_flops_per_window(fcfg, n_frames)
                         + ecapa_flops_per_window(mcfg, n_frames)) * batch
            else:
                raise SystemExit(f"unknown stage {stage}")

            with torch.inference_mode():
                sec = bench(fn, arg, args.iters, device)
            row = {
                "stage": stage, "batch": batch,
                "ms": round(sec * 1000, 3),
                "audio_s_per_s": round(batch * args.seconds / sec, 1),
                "mfu": round(flops / sec / PEAK_FLOPS, 4) if device.type == "cuda" else None,
                "flops": flops,
            }
            results.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"benchmark": "mfu_probe", "rows": results, "device": card_name(device),
                      "peak_flops": PEAK_FLOPS,
                      "launches": {"log_mel_wave": fbank_wave.log_mel_wave.launches}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
