"""Host ms a recording of the k-means runs (``sdtk.cluster.kmeans``, self
time; ``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("cluster.kmeans")
