"""The tower's share of the bf16 peak, read in the batch cells (``readers.tower_mfu``)."""

from benchlib.readers import tower_mfu as read  # noqa: F401
