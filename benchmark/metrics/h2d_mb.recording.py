"""MB a recording copied from the host to the card by the embed engine, from
the program's counter ``embed.h2d_bytes`` (``spans.h2d_mb``)."""

from benchlib.spans import h2d_mb as read  # noqa: F401
