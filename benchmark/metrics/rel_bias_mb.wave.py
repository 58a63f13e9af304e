"""MB a step of gated relative-position bias that the encoder materialises
for its attention, from the program's counter ``wavlm.bias_bytes``; None
where the program counts none."""

from benchlib.spans import counters


def read(ctx):
    c = counters(ctx)
    if not c or not c.get("wavlm.bias_bytes"):
        return None
    return c["wavlm.bias_bytes"] / 1e6 / ctx.work["steps"]
