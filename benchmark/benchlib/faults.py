"""Faults planted under the timed path, for showing that ``correct`` fails
where it must (``test_bench_faults.py`` on the CPU, ``calibrate.py --fault``
on the chip at a cell's own size).  Each takes a ``patch(target, name,
value)`` (pytest's ``monkeypatch.setattr``, or plain ``setattr`` in a process
that ends after it) and breaks the program's entry in place:

- ``stale``: every embed call returns the first call's output (a step that
  returns its state unchanged);
- ``half_batch``: only the first half of a batch is embedded; the rest get
  its mean;
- ``stale_labels``: the clustering returns its first call's answer;
- ``altered_label``: one window's label changed where it is produced;
- ``altered_labels``: the labels of the first eighth of the windows changed
  (for a cell whose partition rounding leaves undetermined on a few
  windows, so that one altered window lies within its limit).
"""

from __future__ import annotations

import numpy as np
import torch


def stale(patch):
    from sdtk_tpu_torch.backends.gpu import EmbedEngine

    real, first = EmbedEngine.embed, {}

    def embed(self, windows, lengths):
        out = real(self, windows, lengths)
        return first.setdefault(out.shape[0], out)
    patch(EmbedEngine, "embed", embed)


def half_batch(patch):
    from sdtk_tpu_torch.backends.gpu import EmbedEngine

    real = EmbedEngine.embed

    def embed(self, windows, lengths):
        h = max(1, len(windows) // 2)
        out = real(self, windows[:h], lengths[:h])
        mean = torch.nn.functional.normalize(out.mean(0, keepdim=True), dim=1)
        return torch.cat([out, mean.expand(len(windows) - h, -1)])
    patch(EmbedEngine, "embed", embed)


def _alter(patch, rows):
    """Labels of ``rows(n)`` windows moved to the next label, in both
    clustering entries the loops call."""
    from sdtk_tpu_torch.cluster import spectral

    fixed, counted = spectral.cluster_stage, spectral.spectral_cluster

    def cluster_stage(emb, max_speakers=8, use_subspace=False):
        labels = fixed(emb, max_speakers, use_subspace).clone()
        m = rows(len(labels))
        labels[:m] = (labels[:m] + 1) % max_speakers
        return labels

    def spectral_cluster(emb, *args, **kwargs):
        labels, count = counted(emb, *args, **kwargs)
        labels, count = np.array(labels), max(count, 2)
        m = rows(len(labels))
        labels[:m] = (labels[:m] + 1) % count
        return labels, count
    patch(spectral, "cluster_stage", cluster_stage)
    patch(spectral, "spectral_cluster", spectral_cluster)


def altered_label(patch):
    _alter(patch, lambda n: 1)


def altered_labels(patch):
    _alter(patch, lambda n: max(1, n // 8))


def stale_labels(patch):
    from sdtk_tpu_torch.cluster import spectral

    fixed, counted, first = spectral.cluster_stage, spectral.spectral_cluster, {}

    def cluster_stage(emb, max_speakers=8, use_subspace=False):
        return first.setdefault("fixed", fixed(emb, max_speakers, use_subspace))

    def spectral_cluster(emb, *args, **kwargs):
        return first.setdefault("counted", counted(emb, *args, **kwargs))
    patch(spectral, "cluster_stage", cluster_stage)
    patch(spectral, "spectral_cluster", spectral_cluster)


FAULTS = {f.__name__: f for f in (stale, half_batch, stale_labels, altered_label,
                                   altered_labels)}
