"""The share of the embed engine's rows that a CUDA graph's replay embedded,
in %, from the program's counters ``embed.graph_rows`` and ``embed.rows``;
None where the program counts no graph row (a program without the graph
route)."""

from benchlib.spans import counters


def read(ctx):
    c = counters(ctx)
    if not c or not c.get("embed.rows") or "embed.graph_rows" not in c:
        return None
    return 100.0 * c["embed.graph_rows"] / c["embed.rows"]
