"""Data-parallel scaling of the serving embed over 1, 2, 4 ... cards.

The counterpart of ``evals/benchmark_scaling.py``, with its flags plus
``--device``.  The embed is the serving one: the waveform kernel
(``ops/fbank_wave.py:log_mel_wave``, bf16, as ``backends/gpu.py`` calls
it) -> ECAPA (``models/ecapa.py``, bf16, seeded weights of the width
``--channels``) -> L2.  Its forward pass has no collective, as in JAX: each
rank embeds its own rows.

The JAX script runs one process over a mesh of N devices; the port runs
one process (rank) per card in a process group (``parallel/multihost.py``:
NCCL on the cards, gloo with ``--device cpu``).  For each size in
``--devices`` it starts that many ranks on this machine.  Rank r embeds
rows r·B .. (r+1)·B − 1 (B = ``--per-device-batch``) of ``--seconds``
each; row i is ``default_rng([0, i])``'s normal draw, so a row is the
same at every size.  Every rank builds the kernel (under the build lock)
and runs one warm-up step (cuDNN's plans) before the first barrier, then
``--iters`` steps, each fed the one before (1e-30 of its first output
added to the input, so none can be skipped or overlapped), timed by CUDA
events (the host clock on the CPU) between two barriers.  Throughput is
the size's audio over the slowest rank's time, and ``scaling_efficiency``
= T_N / (N · T_1).

    python -m sdtk_tpu_torch.evals.benchmark_scaling --devices 1,2,4 \\
        --per-device-batch 1024 --seconds 3 --channels 512 --iters 10
    python -m sdtk_tpu_torch.evals.benchmark_scaling --devices 1,2 --device cpu \\
        --per-device-batch 2 --seconds 1 --channels 64 --iters 2
    python -m sdtk_tpu_torch.evals.benchmark_scaling --roofline [--card-rate X ...]

Prints one JSON line per size (``devices``, ``batch``,
``throughput_audio_s_per_s``: the JAX script's keys), then a ``summary``
line: the sizes with ``scaling_efficiency``, each rank's time, peak
memory, kernel launches and (on the cards) ``nvidia-smi``'s name and power
limit of its card; on the CPU the note that the ranks share the host's
cores.  A size larger than the cards present is skipped, as in JAX.

:func:`roofline` is the JAX script's analytic model with the port's
numbers: the card's embed rate, the host's decode rate per core and its
thread scaling (``evals/benchmark_decode.py``'s counterpart), the
interconnect, and the port's long-form stages, each an argument whose
default names where it was measured.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

BUILD = Path(__file__).resolve().parent.parent / "_build" / "benchmark_scaling"  # the ranks' files

# The roofline's defaults, each beside where it was measured.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CARD_RATE = 37_158.1  # audio-s per s of one card
CARD_RATE_SOURCE = (f"{CARD}: benchmark_scaling --devices 1,2,4 --per-device-batch 1024 "
                    "--seconds 3 --channels 512 --iters 10, its one-card row")
DECODE_PER_CORE = 2_765.9  # audio-s per s, one thread
DECODE_SCALING = 0.103  # 32 threads against 32 times one
DECODE_SOURCE = ("benchmark_decode --thread-sweep (64 WAVs of 30 s at 44.1 kHz to 16 kHz) on the "
                 f"host of the four {CARD} cards")
HOST_CORES, CARDS_PER_HOST = 32, 4  # the four-card machine: 32 cores for 4 cards
TOPOLOGY_SOURCE = "the four-card H100 machine: 32 host cores, 4 cards joined by NVLink"
LINK_BYTES_PER_S = 450e9  # NVLink 4 on H100 SXM5: 900 GB/s in both directions together
LINK_SOURCE = "H100 SXM5 data sheet: NVLink 4, 18 links, 900 GB/s both directions"
# The port's long-form on one card, seconds inside diarize_waveform for the
# hour (3 608.8 s, 9 751 windows of 1.0 s at 0.375 s, D 192).
LONGFORM_STAGES = {"frontend": 0.2258, "embed": 0.2926, "affinity": 0.0109, "eigensolve": 0.0528,
                   "labels": 0.0946}
LONGFORM_SOURCE = f"{CARD}: chip_smoke.py phase longform, stage seconds of the hour"
LONGFORM_SHARDED = ("embed", "affinity")  # the stages a rank does for its rows only
LONGFORM_WINDOWS, EMB_DIM = 9_751, 192
WAV_BYTES_PER_AUDIO_S = 16_000 * 4  # f32 samples at 16 kHz


# roofline()'s arguments on the command line, each with the source it replaces
ROOFLINE_ARGS = {"card_rate": "card_rate", "decode_per_core": "decode",
                 "decode_scaling": "decode", "host_cores": "topology",
                 "cards_per_host": "topology", "link_bytes_per_s": "link"}


def roofline(card_rate: float = CARD_RATE, decode_per_core: float = DECODE_PER_CORE,
             decode_scaling: float = DECODE_SCALING, host_cores: int = HOST_CORES,
             cards_per_host: int = CARDS_PER_HOST, link_bytes_per_s: float = LINK_BYTES_PER_S,
             longform_stages: dict | None = None, sources: dict | None = None) -> dict:
    """The JAX script's analytic bound (a model, not a measurement) with the
    port's numbers.

    Data-parallel embed: no collective in the forward pass, each rank its
    own process and rows, so the model's scale-out efficiency is 1.0; what
    bounds a card's rate end to end is the host's decode, shared by the
    cards of one host: ``host_cores · decode_per_core · decode_scaling /
    cards_per_host`` audio-s per s a card, against ``card_rate``.

    Long-form across N ranks (the port's ``pipeline/longform.py``): each
    rank embeds and scores its own rows (``LONGFORM_SHARDED``), every rank
    pads and copies the whole signal, solves and labels the whole matrix;
    the ranks all-gather the (windows, D) f32 embeddings and one halo of
    frames over ``link_bytes_per_s``.  eff(N) = t_1 / (N · t_N)."""
    stages = dict(LONGFORM_STAGES if longform_stages is None else longform_stages)
    src = {"card_rate": CARD_RATE_SOURCE, "decode": DECODE_SOURCE, "topology": TOPOLOGY_SOURCE,
           "link": LINK_SOURCE, "longform_stages": LONGFORM_SOURCE, **(sources or {})}
    per_card_input = host_cores * decode_per_core * decode_scaling / cards_per_host
    dp = {
        "scale_out_efficiency_model": 1.0,
        "scale_out_gated_by": "nothing shared between ranks in the forward pass",
        "per_card_compute_audio_s_per_s": card_rate,
        "per_card_decode_fed_audio_s_per_s": per_card_input,
        "decode_gated_fraction": per_card_input / card_rate,
        "per_card_input_bytes_per_s": card_rate * WAV_BYTES_PER_AUDIO_S,
        "note": "decode gating does not depend on N (each host feeds its own cards); "
                "it bounds a card's rate on compressed or resampled input, not scaling",
    }
    t1 = sum(stages.values())
    sharded = sum(stages[s] for s in LONGFORM_SHARDED)
    emb_bytes = LONGFORM_WINDOWS * EMB_DIM * 4
    sp = []
    for n in (2, 4, 8):
        # a ring all-gather moves (N-1)/N of the whole matrix into every rank
        t_comm = (emb_bytes * (n - 1) / n + 4096 * 4) / link_bytes_per_s
        t_n = t1 - sharded + sharded / n + t_comm
        sp.append({"devices": n, "efficiency_bound": min(t1 / (n * t_n), 1.0),
                   "speedup_bound": t1 / t_n, "comm_share": t_comm / t_n})
    four = next(r for r in sp if r["devices"] == 4)
    unsharded = ", ".join(s for s in stages if s not in LONGFORM_SHARDED)
    return {
        "model": "analytic roofline, NOT a multi-card measurement",
        "constants": {
            "card_rate_audio_s_per_s": card_rate,
            "host_decode_audio_s_per_s_per_core": decode_per_core,
            "host_decode_core_scaling": decode_scaling,
            "host_cores": host_cores, "cards_per_host": cards_per_host,
            "link_bytes_per_s": link_bytes_per_s,
            "wav_bytes_per_audio_s": WAV_BYTES_PER_AUDIO_S,
            "longform_stage_seconds": stages,
            "longform_windows": LONGFORM_WINDOWS, "embedding_dim": EMB_DIM,
            "sources": src,
        },
        "dp_embed": dp,
        "sp_longform_1h": sp,
        "conclusion": (
            f"data-parallel embed: no collective, efficiency 1.0 in the model; one host's "
            f"decode feeds {dp['decode_gated_fraction']:.3f} of a card's embed rate. "
            f"Long-form: {four['speedup_bound']:.2f}x ({four['efficiency_bound']:.3f}) on 4 "
            f"cards, bounded by the stages every rank does whole ({unsharded}); "
            f"communication is {four['comm_share']:.1e} of a rank's time"),
    }


def row_block(first: int, rows: int, n_samples: int) -> np.ndarray:
    """Rows ``first`` .. ``first + rows - 1`` of the benchmark's waveform:
    row i is ``default_rng([0, i])``'s float32 normal draw."""
    return np.stack([np.random.default_rng([0, i]).standard_normal(n_samples, dtype=np.float32)
                     for i in range(first, first + rows)])


def serving_embed(channels: int, device, dtype: str = "bfloat16", fcfg=None):
    """The serving embed at ECAPA width ``channels`` (seeded weights) in
    ``dtype`` on ``device``: (B, N) waveform -> (B, D) unit rows."""
    import torch

    from ..models.ecapa import EcapaConfig, EcapaTdnn, l2_normalize
    from ..ops.fbank import FrontendConfig
    from ..ops.fbank_wave import log_mel_wave

    fcfg = fcfg or FrontendConfig(compute_dtype=dtype)
    model = EcapaTdnn(EcapaConfig(channels=channels, dtype=dtype))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device).eval()

    @torch.inference_mode()
    def embed(wav):
        feats, mask = log_mel_wave(wav, fcfg)
        return l2_normalize(model(feats, mask))

    embed.model = model
    return embed


def _rank(rank: int, world: int, port: int, job: dict) -> None:
    """One rank of a size: join the group, embed this rank's rows, time
    ``iters`` chained steps between two barriers, write its numbers."""
    import torch
    import torch.distributed as dist

    from ..parallel import multihost
    from ..tools.measure import kernel_wrappers

    device = job["device"]
    if device == "cpu":
        torch.set_num_threads(max(1, job["cores"] // world))
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=device)
    try:
        dev = multihost.rank_device(device)
        cuda = dev.type == "cuda"
        b = job["per_device_batch"]
        wav = torch.from_numpy(row_block(rank * b, b, job["n_samples"])).to(dev)
        embed = serving_embed(job["channels"], dev)
        out = embed(wav)  # warm-up: the kernel's build, the weights, cuDNN's plans
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        wrappers = kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        barrier = (lambda: dist.barrier(device_ids=[dev.index])) if cuda else dist.barrier
        barrier()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        a = wav
        for _ in range(job["iters"]):
            out = embed(a)
            a = wav + out[0, 0].float() * 1e-30
        if cuda:
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        barrier()  # no rank leaves (and frees its card) before the slowest has timed
        res = {"rank": rank, "ms": ms,
               "launches": {name: fn.launches for name, fn in wrappers.items()},
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None}
        if cuda:
            from ..tools.measure import smi

            res["device"] = str(dev)
            res["nvidia_smi"] = smi("name,power.limit", index=dev.index)
        Path(job["out"], f"rank-{world}-{rank}.json").write_text(json.dumps(res))
        if job.get("dump"):
            np.save(Path(job["dump"], f"emb-{world}-{rank}.npy"), out.float().cpu().numpy())
    finally:
        multihost.shutdown()


def measure(sizes: list[int], per_device_batch: int, seconds: float, iters: int,
            channels: int, device: str = "cuda", dump: str | Path | None = None,
            emit=lambda line: print(line, flush=True)) -> dict:
    """Every size of ``sizes``: start its ranks, read their numbers, emit
    its line; returns the summary (``dump``: each rank writes its last
    embeddings there as ``emb-<size>-<rank>.npy``)."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from ..tools.measure import free_port
    from ..utils.device import resolve_device

    kind = resolve_device(device).type
    BUILD.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=BUILD))
    job = {"device": kind, "per_device_batch": per_device_batch, "iters": iters,
           "n_samples": int(seconds * 16000), "channels": channels, "out": str(out),
           "cores": os.cpu_count() or 1, "dump": str(dump) if dump else None}
    results, ranks = [], {}
    try:
        for n in sizes:
            if kind == "cuda" and n > torch.cuda.device_count():
                print(f"SKIP n={n}: only {torch.cuda.device_count()} devices", file=sys.stderr)
                continue
            mp.spawn(_rank, args=(n, free_port(), job), nprocs=n, join=True)
            rows = [json.loads((out / f"rank-{n}-{r}.json").read_text()) for r in range(n)]
            slowest = max(r["ms"] for r in rows)
            batch = per_device_batch * n
            results.append({"devices": n, "batch": batch,
                            "throughput_audio_s_per_s": batch * seconds * iters / (slowest / 1e3)})
            ranks[str(n)] = rows
            emit(json.dumps(results[-1]))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if results and results[0]["devices"] == 1:
        t1 = results[0]["throughput_audio_s_per_s"]
        for r in results[1:]:
            r["scaling_efficiency"] = r["throughput_audio_s_per_s"] / (r["devices"] * t1)
    summary = {"summary": results}
    if kind == "cpu":
        summary["note"] = (
            "CPU ranks over gloo: all ranks share the host's cores, so scaling_efficiency "
            "is NOT meaningful; this run checks the ranks and the harness; run on the "
            "cards for numbers")
    summary.update({"ranks": ranks, "per_device_batch": per_device_batch, "seconds": seconds,
                    "iters": iters, "channels": channels, "device": kind})
    return summary


def main(argv: list[str] | None = None, dump: str | Path | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.benchmark_scaling")
    ap.add_argument("--devices", default="1,2,4,8", help="comma list of rank counts to measure")
    ap.add_argument("--per-device-batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0, help="audio window length")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--channels", type=int, default=128,
                    help="ECAPA width (512 is the bundled fam5tel's)")
    ap.add_argument("--roofline", action="store_true",
                    help="print the analytic multi-card bound (no device needed) and exit")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, one card a rank) or cpu (gloo)")
    rf = ap.add_argument_group("roofline arguments (defaults: the measured constants)")
    rf.add_argument("--card-rate", type=float, default=CARD_RATE)
    rf.add_argument("--decode-per-core", type=float, default=DECODE_PER_CORE)
    rf.add_argument("--decode-scaling", type=float, default=DECODE_SCALING)
    rf.add_argument("--host-cores", type=int, default=HOST_CORES)
    rf.add_argument("--cards-per-host", type=int, default=CARDS_PER_HOST)
    rf.add_argument("--link-bytes-per-s", type=float, default=LINK_BYTES_PER_S)
    args = ap.parse_args(argv)

    if args.roofline:
        kw = {k: getattr(args, k) for k in ROOFLINE_ARGS}
        given = {ROOFLINE_ARGS[k] for k, v in kw.items() if v != ap.get_default(k)}
        print(json.dumps(roofline(**kw, sources={s: "given on the command line" for s in given}),
                         indent=2))
        return 0

    summary = measure([int(s) for s in args.devices.split(",")], args.per_device_batch,
                      args.seconds, args.iters, args.channels, args.device, dump)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
