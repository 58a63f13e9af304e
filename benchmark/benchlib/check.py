"""The numbers that decide ``correct``, and how they are printed.

- ``emb_cos_gap``: over the windows compared, the largest 1 − cos between
  the program's embedding and the plain float32 reference's of the same
  audio (float64 arithmetic);
- ``label_mismatch``: windows whose program label differs from the plain
  clustering's of the program's own embeddings, after the best one-to-one
  matching of the two labelings (clusters have no names);
- ``label_mismatch_share``: the same as a share of the windows, for a cell
  whose partition rounding leaves undetermined on a few windows;
- ``count_diff``: |program's speaker count − the plain clustering's|.

Each number has a limit (``limits/<workload>.json``); a run is correct when
every number is at or under its limit.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def cos_gap(got: np.ndarray, want: np.ndarray) -> float:
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    cos = (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1),
                                      1e-300)
    return float(np.max(1.0 - cos)) if len(cos) else float("inf")


def label_mismatch(got: np.ndarray, want: np.ndarray) -> int:
    """Windows left unmatched by the best one-to-one map of labels."""
    from scipy.optimize import linear_sum_assignment

    got = np.asarray(got).astype(np.int64).ravel()
    want = np.asarray(want).astype(np.int64).ravel()
    if got.shape != want.shape:
        return max(len(got), len(want))
    if got.min(initial=0) < 0:
        return len(got)
    table = np.zeros((got.max(initial=0) + 1, want.max(initial=0) + 1), np.int64)
    np.add.at(table, (got, want), 1)
    rows, cols = linear_sum_assignment(-table)
    return int(len(got) - table[rows, cols].sum())


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) with a missing number failing."""
    table = {name: {"value": numbers.get(name, float("nan")), "limit": limit}
             for name, limit in limits.items()}
    ok = all(np.isfinite(row["value"]) and row["value"] <= row["limit"]
             for row in table.values())
    return bool(ok), table


def print_table(table: dict, out=sys.stderr) -> None:
    for name, row in table.items():
        print(f"check {name} {json.dumps(row['value'])} limit {json.dumps(row['limit'])}",
              file=out, flush=True)
