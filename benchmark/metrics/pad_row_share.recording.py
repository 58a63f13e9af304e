"""Pad rows among the rows the embed engine ran, from the program's
counters ``embed.pad_rows`` and ``embed.rows`` (``spans.pad_row_share``)."""

from benchlib.spans import pad_row_share as read  # noqa: F401
