"""The whole step's share of the bf16 peak, read in the recording cell (``readers.step_mfu``)."""

from benchlib.readers import step_mfu as read  # noqa: F401
