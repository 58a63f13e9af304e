"""The embed engine's log-mel route (K1 → input norm → tower → L2) replayed
as one CUDA graph per input shape that repeats.

A small batch's forward, such as the diarizer's chunk of 128 one-second
windows, takes the host longer to issue (about 268 launches through Python
and cuDNN's host code) than the card takes to run, so the card waits
between launches.  Replayed as a graph, the whole chain costs the host one
launch.  :class:`GraphRoute` engages only where the call shows it: a CUDA
device, an ECAPA or x-vector tower whose whole forward takes the serving
route (``models/ecapa.py:serving_tower``: eval, bf16, autograd off, no
tensor-parallel split), and rows × samples at or under :data:`CEILING`.
Above it a forward is bound by the card, where a graph saves nothing and
its private memory pool would double the activations.

A shape met for the first time runs eagerly (the caller's route), so that
traffic whose shapes do not repeat pays nothing for the graphs.  The second
call at a shape copies its input into static buffers (windows (rows,
samples) f32, lengths (rows,) int64), runs the forward once eagerly on a
side stream, captures it (span ``embed.capture``) and replays it.  Each
later call copies its input in, replays, and returns a clone of the static
output, so that the next call never overwrites rows a caller kept.  One
lock per engine is held from the copy in to the clone.  The graphs are
keyed on the (data_ptr, version) of the tower's parameters and buffers, as
the serving copies are: a change drops every graph, as does the model
leaving eval.  At most :data:`MAX_SHAPES` shapes are kept, the least
recently used dropped first, and its private pool with it; a dropped shape
runs eagerly once more before it is captured again.

A replay runs no Python, so each call adds what the capture counted
(``profiling.tape``): the counters (``tower.epilogues``,
``tower.fused_epilogues``) and each kernel wrapper's ``.launches``, once
per call (the call that captures counts its eager warm-up instead).  The
tape holds this thread's counts only, so a launch of another thread during
a capture is counted as that thread's.  Counters: ``embed.graph_rows``,
rows embedded by a replay; ``embed.graph_captures``, captures.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from itertools import chain

import torch

from ..models.ecapa import EcapaTdnn, serving_tower
from ..models.xvector import XVector
from ..utils import profiling
from ..utils.profiling import count, stage

# rows × samples at or under which a forward issues slower than the card
# runs it (the crossover, measured with tools/profile_issue.py; PERF.md §6)
CEILING = 1 << 22
MAX_SHAPES = 4
MAX_SEEN = 16  # shapes met once, remembered for their second call


class _Graph:
    """One forward captured at one shape: the static input buffers, the
    graph, its static output, and what one forward counts."""

    def __init__(self, rows: int, samples: int, device: torch.device):
        self.x = torch.zeros((rows, samples), dtype=torch.float32, device=device)
        self.lens = torch.zeros(rows, dtype=torch.int64, device=device)
        self.done = torch.cuda.Event()  # the last call's clone was issued
        self.graph = self.out = self.tape = None

    def load(self, x: torch.Tensor, lens: torch.Tensor) -> None:
        """Copy a call's input into the static buffers, on the current
        stream, after the last call (on any stream) has read them."""
        torch.cuda.current_stream(self.x.device).wait_event(self.done)
        self.x.copy_(x, non_blocking=True)
        self.lens.copy_(lens, non_blocking=True)

    def capture(self, forward) -> None:
        """Run ``forward`` on the static input once eagerly on a side
        stream, then capture it, taping its counts and launches (recorded,
        not run)."""
        side = torch.cuda.Stream(self.x.device)
        side.wait_stream(torch.cuda.current_stream(self.x.device))
        with torch.cuda.stream(side):
            forward(self.x, self.lens)
        torch.cuda.current_stream(self.x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with profiling.tape() as taped:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                out = forward(self.x, self.lens)
        self.graph, self.out, self.tape = graph, out, taped

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        out = self.out.clone()
        self.done.record(torch.cuda.current_stream(self.x.device))
        return out


class GraphRoute:
    """The graphs of one engine's ``forward(x, lens)`` on ``device``, by
    input shape."""

    def __init__(self, model: torch.nn.Module, device: torch.device, forward):
        self.model, self.device, self._forward = model, device, forward
        self._modules = list(model.modules())  # a tower's modules are fixed once built
        self._graphs: OrderedDict[tuple[int, int], _Graph] = OrderedDict()
        self._key: list[tuple[int, int]] | None = None
        self._seen: OrderedDict[tuple[int, int], None] = OrderedDict()
        self._lock = threading.Lock()  # GpuBackend's worker threads share one engine

    def engages(self, x: torch.Tensor) -> bool:
        """The call with (rows, samples) windows ``x`` may take the graph."""
        if self.device.type != "cuda" or not isinstance(self.model, (EcapaTdnn, XVector)):
            return False
        if self.model.training:
            with self._lock:
                self._graphs.clear()
            return False
        return (x.dim() == 2 and 0 < x.shape[0] * x.shape[1] <= CEILING
                and serving_tower(self._modules, self.device, self.model.cfg.compute_dtype))

    def __call__(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor | None:
        """(rows, samples) windows and (rows,) lengths, on any device →
        (rows, emb_dim) unit rows, a tensor of the caller's own; None at a
        shape met for the first time, which the caller runs eagerly."""
        with self._lock:
            key = [(t.data_ptr(), t._version) for m in self._modules
                   for t in chain(m._parameters.values(), m._buffers.values()) if t is not None]
            if key != self._key:
                self._graphs.clear()
                self._key = key
            shape = (x.shape[0], x.shape[1])
            g = self._graphs.get(shape)
            if g is None and shape not in self._seen:
                self._seen[shape] = None
                if len(self._seen) > MAX_SEEN:
                    self._seen.popitem(last=False)
                return None
            self._seen.pop(shape, None)
            with stage("embed.copy_in"):
                fresh = g is None
                if fresh:
                    g = _Graph(*shape, self.device)
                g.load(x, lens)
            with stage("embed.issue"):
                if fresh:
                    with stage("embed.capture"):
                        g.capture(self._forward)
                    count("embed.graph_captures")
                    self._graphs[shape] = g
                    if len(self._graphs) > MAX_SHAPES:
                        self._graphs.popitem(last=False)
                else:
                    self._graphs.move_to_end(shape)
                    g.tape.add()
                out = g.replay()
            count("embed.graph_rows", shape[0])
            return out
