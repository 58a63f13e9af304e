"""The share of the tower's post-convolution epilogues (ReLU, BatchNorm, bf16,
mask) that ran as one fused kernel, in %, from the program's counters
``tower.fused_epilogues`` and ``tower.epilogues``; None where the program
counts no epilogue (a program without these counters)."""

from benchlib.spans import counters


def read(ctx):
    c = counters(ctx)
    if not c or not c.get("tower.epilogues"):
        return None
    return 100.0 * c.get("tower.fused_epilogues", 0) / c["tower.epilogues"]
