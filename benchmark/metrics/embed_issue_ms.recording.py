"""Host ms a recording of issuing the embed engine's device work: K1, the
input norm, the tower and L2 (``sdtk.embed.issue``, self time;
``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("embed.issue")
