"""Host ms a recording of the copies onto the card: the embed engine's
chunks and the clustering's embeddings (``sdtk.embed.copy_in``,
``sdtk.cluster.copy_in``, self time; ``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("embed.copy_in", "cluster.copy_in")
