"""``python -m sdtk_tpu_torch.cli.diarize`` — offline diarization of a WAV
file on the GPU.  The counterpart of ``sdtk_tpu/cli/diarize.py``; non-WAV
containers are not ported yet.

``--longform`` runs the time-sharded pipeline (``pipeline/longform.py``)
for hour-scale recordings.  It joins the process group that the
environment describes (``SDTK_COORDINATOR`` / ``SDTK_NUM_PROCESSES`` /
``SDTK_PROCESS_ID``, or torchrun's variables; ``parallel/multihost.py``),
one rank a device, e.g. ``torchrun --nproc-per-node 4 -m
sdtk_tpu_torch.cli.diarize --longform meeting.wav``; without them it runs
on one device.  Rank 0 prints or writes the result."""

from __future__ import annotations

import argparse
import json

from .common import add_device, add_quiet, err, info


def _run_longform(args) -> dict | None:
    """The long-form result, on rank 0; None on the other ranks."""
    from ..parallel import multihost
    from ..pipeline.longform import LongformConfig, LongformDiarizer
    from ..utils.audio import load_audio

    # The JAX CLI builds the config from this CLI's --window / --hop (1.0 /
    # 0.375 by default), not from LongformConfig's 1.5 / 0.75 defaults.
    # It passes no --vad either, so long-form from the CLI always takes the
    # energy gate; both are kept here.
    lcfg = LongformConfig(
        window_seconds=args.window,
        hop_seconds=args.hop,
        max_speakers=args.max_speakers,
        n_speakers=args.num_speakers,
        resegment=not args.no_resegment,
    )
    wav, _ = load_audio(args.audio, target_sr=lcfg.sample_rate)
    rank = multihost.initialize(device=args.device)["process_index"]
    try:
        result = LongformDiarizer(cfg=lcfg, device=args.device).diarize_waveform(wav)
    finally:
        multihost.shutdown()
    if rank != 0:
        return None
    info(args, f"longform: {result['mesh_devices']} device(s)")
    return result


def cmd_run(args) -> int:
    from ..pipeline.diarize import DiarizeConfig, Diarizer, to_rttm, to_transcript_skeleton

    try:
        if args.longform:
            result = _run_longform(args)
            if result is None:
                return 0
        else:
            cfg = DiarizeConfig(
                window_seconds=args.window,
                hop_seconds=args.hop,
                max_speakers=args.max_speakers,
                n_speakers=args.num_speakers,
                resegment=not args.no_resegment,
                detect_overlap=args.detect_overlap,
                vad=args.vad,
            )
            result = Diarizer(args.backend, cfg, device=args.device).diarize_file(args.audio)
    except FileNotFoundError:
        err(f"audio file not found: {args.audio}")
        return 1
    info(args, f"{result['n_speakers']} speaker(s), {len(result['segments'])} segment(s)")

    if args.eval_rttm:
        from ..cluster.der import diarization_error_rate, load_rttm

        refs = load_rttm(args.eval_rttm)
        ref = refs.get(args.recording_id) or next(iter(refs.values()), [])
        metrics = diarization_error_rate(ref, result["segments"], collar=args.collar)
        info(args, f"DER {metrics['der']:.3f} (miss {metrics['miss']:.3f}, "
                   f"fa {metrics['false_alarm']:.3f}, conf {metrics['confusion']:.3f})")
        result["der"] = metrics

    if args.format == "rttm":
        out = to_rttm(result, recording_id=args.recording_id)
    elif args.format == "transcript":
        out = json.dumps(to_transcript_skeleton(result), indent=2)
    else:
        payload = {
            "n_speakers": result["n_speakers"],
            "segments": [{"start": s, "end": e, "speaker": l} for s, e, l in result["segments"]],
        }
        if "overlap_segments" in result:
            payload["overlap_segments"] = [
                {"start": s, "end": e, "speaker": l} for s, e, l in result["overlap_segments"]
            ]
        if "der" in result:
            payload["der"] = result["der"]
        out = json.dumps(payload, indent=2)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out if out.endswith("\n") else out + "\n")
        info(args, f"Wrote {args.output}")
    else:
        print(out, end="" if out.endswith("\n") else "\n")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="sdtk_tpu_torch.cli.diarize",
                                     description="Offline diarization of a WAV file on the GPU")
    add_quiet(parser)
    parser.add_argument("audio")
    parser.add_argument("--format", choices=["json", "rttm", "transcript"], default="json")
    parser.add_argument("--output", "-o")
    parser.add_argument("--num-speakers", type=int)
    parser.add_argument("--max-speakers", type=int, default=8)
    parser.add_argument("--window", type=float, default=1.0)
    parser.add_argument("--hop", type=float, default=0.375)
    parser.add_argument("--backend", "-b")
    add_device(parser)
    parser.add_argument("--recording-id", default="rec")
    parser.add_argument("--eval-rttm", help="Reference RTTM: print DER after diarizing")
    parser.add_argument("--collar", type=float, default=0.25)
    parser.add_argument("--no-resegment", action="store_true",
                        help="Disable the sticky-HMM Viterbi smoothing pass")
    parser.add_argument("--vad", default="auto", choices=["auto", "energy", "trained"])
    parser.add_argument("--detect-overlap", action="store_true",
                        help="Flag windows with two active speakers")
    parser.add_argument("--longform", action="store_true",
                        help="Time-sharded pipeline over the process group (one rank a "
                             "device): sharded frontend, sharded embed, row-block "
                             "affinity (hour-scale audio)")
    args = parser.parse_args(argv)
    return cmd_run(args)


if __name__ == "__main__":
    raise SystemExit(main())
