"""Where the host's time goes while it issues one chunk of windows.

    python -m sdtk_tpu_torch.tools.profile_issue [--windows 128] [--samples 16000]
        [--reps 40] [--device cuda]

Builds the default GPU backend's embed engine (the bundled c512 tower),
warms it up on ``--windows`` windows of ``--samples`` samples, then prints
three JSON lines:

* ``issue``: the host ms of the eager embed (the copy in, K1, the tower,
  the norm: ``EmbedEngine.log_mel_forward``) and of the tower's forward
  alone, each from its call to its return with the card drained first
  (``tools/measure.py:host_ms``); the card's ms for the eager embed (every
  kernel and copy, ``measure.device_ms_total``, read before any graph is
  captured in the process; None on the CPU); beside them the graph route
  (``backends/embed_graph.py``) at the shape: the host ms of its second
  call, which captures (``capture_ms``, a miss: None where nothing was
  captured), of a later ``EmbedEngine.embed`` call (``graph_issue_ms``),
  and how many of 3 calls replayed (``graph_calls``: 0, and no ms, where
  the route does not engage: on the CPU, or above its ceiling), read from
  the ``embed.graph_*`` counters on a ``profiling.tape``.  Where
  ``embed_issue_ms`` exceeds ``device_ms`` the card waits on the host; the
  rows × samples where the two cross set the route's ceiling;
* ``profile``: ``cProfile`` over ``--reps`` tower forwards, self time per
  forward by group (the serving route's own Python in ``models/ecapa.py``,
  the epilogue's wrapper and ``utils/build.py:launch``, the counters,
  ``torch`` operators, ``nn.Module`` calls, the rest of the tower's Python,
  other) and the functions with the most; the profiler inflates Python
  calls, so ``profiled_ms`` is above ``tower_issue_ms``;
* ``route``: each route function's host µs per call timed alone
  (``timeit``) and, with its calls per forward from the profile, the ms
  per forward without the profiler's inflation: ``route_ms`` for the
  route's own checks (``serving`` and the serving copies' keys),
  ``wrapper_ms`` for the epilogue's wrapper (its checks and the ctypes
  launch); beside them an eager ReLU's µs per call.

On the CPU the tower takes the eager route, so the route's rows read 0
calls; the tool still runs, for its tests.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time
import timeit

_ROUTE = ("serving", "_serving_copy", "_cast_copy", "_params", "serving_affine", "_epilogue")


def _group(path: str, func: str) -> str:
    """The group of a profile entry (``path`` '~' for a builtin)."""
    if path.endswith("models/ecapa.py") and func in _ROUTE:
        return "route"
    if path.endswith(("ops/tower_epilogue.py", "utils/build.py")):
        return "wrapper"
    if path.endswith("utils/profiling.py"):
        return "counters"
    if path == "~" and "torch" in func:
        return "torch_ops"
    if path.endswith("torch/nn/modules/module.py"):
        return "module_call"
    if "sdtk_tpu_torch" in path:
        return "tower_python"
    return "other"


def split(stats: pstats.Stats, reps: int, top: int) -> dict:
    """Self ms per forward by group, calls per forward of the route's
    functions, and the ``top`` functions by self time."""
    groups: dict[str, float] = {}
    calls: dict[str, float] = {}
    rows = []
    for (path, _line, func), (_cc, nc, tt, _ct, _callers) in stats.stats.items():
        g = _group(path, func)
        groups[g] = groups.get(g, 0.0) + tt * 1e3 / reps
        if g in ("route", "wrapper"):
            calls[func] = calls.get(func, 0.0) + nc / reps
        rows.append((tt * 1e3 / reps, nc / reps, f"{path.rsplit('/', 1)[-1]}:{func}"))
    rows.sort(reverse=True)
    return {"profiled_ms": sum(groups.values()), "group_ms": groups, "calls_per_forward": calls,
            "top": [{"fn": name, "self_ms": ms, "calls": n} for ms, n, name in rows[:top]]}


def _us(fn, n: int = 2000) -> float:
    return timeit.timeit(fn, number=n) / n * 1e6


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--windows", type=int, default=128)
    p.add_argument("--samples", type=int, default=16000)
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--device", default="cuda")
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..backends.base import get_backend
    from ..models import ecapa
    from ..ops import fbank_wave, tower_epilogue
    from ..utils import profiling
    from . import measure

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    eng = get_backend("gpu", device=args.device).engine
    wav = 0.1 * np.random.default_rng(0).standard_normal((args.windows, args.samples), np.float32)
    lens = np.full(args.windows, args.samples, np.int32)
    with torch.inference_mode():
        x = torch.from_numpy(wav).to(dev)
        feats, mask = fbank_wave.log_mel_wave(x, eng.cfg, lengths=torch.from_numpy(lens).to(dev))
        if eng._input_norm is not None:
            feats = (feats - eng._input_norm[0]) / eng._input_norm[1]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def forward():
        with torch.inference_mode():
            return eng.model(feats, mask)

    def eager():
        with torch.inference_mode():
            return eng.log_mel_forward(torch.from_numpy(wav).to(dev, non_blocking=True),
                                       torch.from_numpy(lens).to(dev, torch.int64))

    for _ in range(3):
        eager()
    sync()
    host = measure.host_ms if cuda else (lambda fn, reps=5: _us(fn, reps) / 1e3)
    card = measure.smi("name,power.limit") if cuda else "cpu"
    device_ms = measure.device_ms_total(eager) if cuda else None
    eng.embed(wav, lens)  # the shape's first call: eager
    sync()
    with profiling.tape() as taped:
        t0 = time.perf_counter()
        eng.embed(wav, lens)  # the second: the capture
        capture_ms = (time.perf_counter() - t0) * 1e3
        sync()
    captured = taped.counts.get("embed.graph_captures", 0)
    with profiling.tape() as taped:
        for _ in range(3):
            eng.embed(wav, lens)
    graph_calls = taped.counts.get("embed.graph_rows", 0) // args.windows
    graph_ms = host(lambda: eng.embed(wav, lens)) if graph_calls else None
    print(json.dumps({"issue": {"card": card, "windows": args.windows, "samples": args.samples,
                                "embed_issue_ms": host(eager), "tower_issue_ms": host(forward),
                                "device_ms": device_ms,
                                "capture_ms": capture_ms if captured else None,
                                "graph_issue_ms": graph_ms, "graph_calls": graph_calls}}),
          flush=True)

    prof = cProfile.Profile()
    for _ in range(args.reps):
        sync()
        prof.enable()
        forward()
        prof.disable()
    sync()
    prof_split = split(pstats.Stats(prof), args.reps, args.top)
    print(json.dumps({"profile": prof_split}), flush=True)

    dt = eng.model.cfg.compute_dtype
    conv = next(m for m in eng.model.modules() if isinstance(m, ecapa.Conv))
    bn = next(m for m in eng.model.modules() if isinstance(m, ecapa.BatchNorm))
    c = bn.weight.shape[0]
    with torch.inference_mode():
        y = torch.randn(args.windows, c, feats.shape[1], device=dev).to(dt)
        scale, shift = bn.serving_affine()
        per_call = {"serving": _us(lambda: ecapa.serving(conv, y, dt)),
                    "_cast_copy": _us(lambda: ecapa._cast_copy(conv, dt)),
                    "serving_affine": _us(bn.serving_affine),
                    "relu_eager": _us(lambda: torch.relu(y), 200)}
        if cuda:
            sync()
            per_call["tower_epilogue_cuda"] = _us(
                lambda: tower_epilogue.tower_epilogue_cuda(y, mask, scale, shift), 200)
            sync()
    calls = prof_split["calls_per_forward"]

    def ms(names):
        return sum(per_call.get(n, 0.0) * calls.get(n, 0.0) for n in names) / 1e3

    print(json.dumps({"route": {"us_per_call": per_call,
                                "route_ms": ms(("serving", "_cast_copy", "serving_affine")),
                                "wrapper_ms": ms(("tower_epilogue_cuda",))}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
