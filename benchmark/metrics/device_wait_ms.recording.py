"""Host ms a recording of the copies back to the host, which wait for the
device first: each chunk's embeddings and the clustering's labels
(``sdtk.diarize.copy_out``, ``sdtk.cluster.copy_out``, self time;
``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("diarize.copy_out", "cluster.copy_out")
