"""Device idle ms a step under the clustering's spans (``sdtk.cluster.*``):
the trace's idle gaps intersected with them (``spans.idle_ms_per_step``)."""

from benchlib.spans import idle_ms_per_step

read = idle_ms_per_step("cluster.")
