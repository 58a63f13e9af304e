"""The device's idle share of the traced window, read in the waveform cell
(``readers.idle_share``)."""

from benchlib.readers import idle_share as read  # noqa: F401
