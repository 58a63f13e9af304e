"""Host ms a recording of the host's merge count
(``sdtk.cluster.merge_count``, self time; ``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("cluster.merge_count")
