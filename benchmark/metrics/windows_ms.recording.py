"""Host ms a recording of the diarizer cutting its windows into chunk
buffers (``sdtk.diarize.windows``, self time; ``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("diarize.windows")
