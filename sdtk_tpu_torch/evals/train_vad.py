"""Train the frame-level VAD (``models/vad.py:VadNet``) on synthetic speech
against the non-speech negative classes (``data/nonspeech.py``).

The counterpart of ``evals/train_vad.py``.  Positives: 1.5 s windows from
the multi-family TRAIN voices (``data/synth.py``), clean, bed-mixed
(speech over music / noise at SNR 4-20 dB) and band-limited; negatives:
music, noise, hum, keyboard, silence; composites splice both inside one
window with per-frame labels.  The batches are the JAX script's, draw for
draw, from one seeded ``np.random.Generator``.  A step featurizes the
batch on ``--device`` with the waveform→log-mel kernel
(``ops/fbank_wave.py``, K1; its plain version on the CPU), runs
``VadNet``, takes the pos-weighted binary cross-entropy over the frames
and one Adam step (``parallel/train.py:AdamW`` without decay, optax's
arithmetic).  Held-out windows (seed + 10 000) are then scored through
the NumPy serving path (``VadScorer`` on ``log_mel_reference``
features), which catches train / serve skew.

``--out`` is required: the port never writes the bundled
``models/vad.msgpack`` (the JAX script's default).

Usage: python -m sdtk_tpu_torch.evals.train_vad --out X.msgpack [--steps 400]
       [--batch 64] [--lr 1e-3] [--seed 0] [--arch v4|v3] [--pos-weight 2.0]
       [--device cuda]
Prints one JSON line; exits 0 when the held-out window accuracy is ≥ 0.9.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..utils.device import full_f32

SR = 16000
WIN_S = 1.5
N = int(WIN_S * SR)
# Lowest speech-over-bed SNR labelled "speech" in training (the JAX
# script's floor: at 0 dB bed and speech are indistinguishable targets).
BED_SNR_LO = 4.0


def speech_window(rng: np.random.Generator) -> np.ndarray:
    from ..data import nonspeech
    from ..data.augment import band_limit
    from ..data.synth import synth_utterance

    spk = int(rng.integers(64))
    x = synth_utterance(spk, int(rng.integers(1 << 30)), WIN_S + 0.2)[:N]
    if len(x) < N:
        x = np.pad(x, (0, N - len(x)))
    r = rng.uniform()
    if r < 0.35:  # bed under the speech — still speech
        bed = nonspeech.sample_nonspeech(WIN_S, int(rng.integers(1 << 30)))
        x = nonspeech.mix_at_snr(x, bed, float(rng.uniform(BED_SNR_LO, 20.0)))
    elif r < 0.5:  # channel shift
        x = band_limit(x, float(rng.uniform(80, 320)), float(rng.uniform(3000, 7600)))
    return (x * float(rng.uniform(0.2, 1.0))).astype(np.float32)


def nonspeech_window(rng: np.random.Generator) -> np.ndarray:
    from ..data import nonspeech

    if rng.uniform() < 0.12:  # near-silence
        return (1e-4 * rng.standard_normal(N)).astype(np.float32)
    return nonspeech.sample_nonspeech(WIN_S, int(rng.integers(1 << 30)))[:N]


def composite_window(rng: np.random.Generator, n_frames: int, frame_hop: int = 160,
                     frame_len: int = 400) -> tuple[np.ndarray, np.ndarray]:
    """Speech and non-speech spliced inside one window, with per-frame
    labels from the construction (a frame's centre decides its side)."""
    s = speech_window(rng)
    ns = nonspeech_window(rng)
    ns = np.pad(ns, (0, max(0, N - len(ns))))[:N]
    cut = int(rng.uniform(0.25, 0.75) * N)
    speech_first = rng.uniform() < 0.5
    wav = np.concatenate([s[:cut], ns[cut:]] if speech_first else [ns[:cut], s[cut:]])
    in_first = np.arange(n_frames) * frame_hop + frame_len // 2 < cut
    labels = np.where(in_first, 1.0, 0.0) if speech_first else np.where(in_first, 0.0, 1.0)
    return wav.astype(np.float32), labels.astype(np.float32)


def make_batch(rng: np.random.Generator, size: int, n_frames: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """(size, N) windows and (size, n_frames) frame labels: speech 35 %,
    non-speech 35 %, composites 30 %."""
    wavs, labels = [], []
    for _ in range(size):
        r = rng.uniform()
        if r < 0.35:
            wavs.append(speech_window(rng))
            labels.append(np.ones(n_frames, np.float32))
        elif r < 0.7:
            w = nonspeech_window(rng)
            wavs.append(np.pad(w, (0, max(0, N - len(w))))[:N])
            labels.append(np.zeros(n_frames, np.float32))
        else:
            w, lab = composite_window(rng, n_frames)
            wavs.append(w)
            labels.append(lab)
    return np.stack(wavs), np.stack(labels)


def vad_config(arch: str, n_mels: int):
    from ..models.vad import VadConfig

    return VadConfig(n_mels=n_mels, deep=arch == "v4", extra_feats=arch == "v4")


def vad_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             pos_weight: float) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy`` per frame, weighted by
    1 + (pos_weight − 1)·label and the frame mask, over the weighted mask's
    sum (at least 1)."""
    per = -labels * torch.nn.functional.logsigmoid(logits) \
        - (1.0 - labels) * torch.nn.functional.logsigmoid(-logits)
    w = 1.0 + (pos_weight - 1.0) * labels
    m = mask.to(logits.dtype)
    return (per * w * m).sum() / torch.clamp((w * m).sum(), min=1.0)


def vad_update(model, optimizer, feats: torch.Tensor, mask: torch.Tensor,
               labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """The net, the loss, its backward and one ``optimizer`` step on
    features already made, in full f32.  Returns the loss (before the
    update)."""
    # The net amplifies rounding: a frame whose ReLU outputs are nearly all zero
    # gives a LayerNorm variance far below ε = 1e-6, and rsqrt(var + ε) ~ 1e3
    # scales what TF32 would round (10-bit mantissas) into the gradients of
    # conv1.  The model is ~20k parameters, so f32 costs the step nothing.
    with full_f32():
        loss = vad_loss(model(feats), labels, mask, pos_weight)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    optimizer.step()
    return loss.detach()


def vad_step(model, optimizer, wavs: np.ndarray, labels: np.ndarray, fcfg,
             pos_weight: float, device: torch.device) -> torch.Tensor:
    """One Adam step from host windows: K1 featurizes ``wavs`` on
    ``device`` (no gradient flows into the frontend), then
    :func:`vad_update`.  Returns the loss (a device tensor)."""
    from ..ops.fbank_wave import log_mel_wave

    with torch.no_grad():
        feats, mask = log_mel_wave(torch.from_numpy(wavs).to(device), fcfg)
    return vad_update(model, optimizer, feats, mask, torch.from_numpy(labels).to(device),
                      pos_weight)


def make_optimizer(model, lr: float):
    """``optax.adam(lr)``: the port's optax-order AdamW without decay."""
    from ..parallel.train import AdamW

    return AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def holdout_accuracy(params_path: str, seed: int, fcfg, windows: int = 100) -> float:
    """Window accuracy of the saved file through the NumPy serving path: a
    window is called speech when over 30 % of its frames score > 0.5."""
    from ..models.vad import VadScorer
    from ..ops.fbank import log_mel_reference

    scorer = VadScorer(params_path)
    rng = np.random.default_rng(seed + 10_000)
    correct = 0
    for _ in range(windows):
        is_speech = rng.uniform() < 0.5
        w = speech_window(rng) if is_speech else nonspeech_window(rng)
        w = np.pad(w, (0, max(0, N - len(w))))[:N]
        probs = scorer.frame_probs(log_mel_reference(w, fcfg))
        correct += int((float(np.mean(probs > 0.5)) > 0.3) == is_speech)
    return correct / windows


def main(argv: list[str] | None = None, timings: dict | None = None) -> int:
    """The script.  ``timings``, when given, receives the loop's host
    seconds: ``synth_s`` (batch synthesis), ``step_s`` (the steps' calls),
    ``loop_s`` (the whole loop, one synchronize at its end)."""
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.train_vad")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", required=True,
                    help="where to write the flax-msgpack file (the bundled "
                         "models/vad.msgpack is never a default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="v4", choices=["v3", "v4"],
                    help="v4 (default): derived flatness/flux channels + a dilation-8 third "
                         "conv (~410 ms receptive field); v3: the two-conv graph")
    ap.add_argument("--pos-weight", type=float, default=2.0,
                    help="BCE weight on speech frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from ..models.vad import VadNet, save_params
    from ..ops.fbank import FrontendConfig
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    fcfg = FrontendConfig()
    model = VadNet(vad_config(args.arch, fcfg.n_mels))
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.to(device)
    optimizer = make_optimizer(model, args.lr)
    rng = np.random.default_rng(args.seed)
    n_frames = fcfg.num_frames(N)

    synth_s = step_s = 0.0
    loop0 = time.perf_counter()
    loss = torch.zeros(())
    for i in range(args.steps):
        t0 = time.perf_counter()
        wavs, labels = make_batch(rng, args.batch, n_frames)
        t1 = time.perf_counter()
        loss = vad_step(model, optimizer, wavs, labels, fcfg, args.pos_weight, device)
        step_s += time.perf_counter() - t1
        synth_s += t1 - t0
        if i % 50 == 0:
            print(f"step {i}: loss {float(loss):.4f}", file=sys.stderr)
    final_loss = float(loss)
    if timings is not None:
        timings.update(synth_s=synth_s, step_s=step_s, loop_s=time.perf_counter() - loop0)

    save_params(model, args.out)
    acc = holdout_accuracy(args.out, args.seed, fcfg)
    print(json.dumps({
        "benchmark": "train_vad", "steps": args.steps, "final_loss": round(final_loss, 4),
        "holdout_window_accuracy": acc, "out": args.out,
    }))
    return 0 if acc >= 0.9 else 1


if __name__ == "__main__":
    raise SystemExit(main())
