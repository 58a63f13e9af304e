"""Host ms a step of issuing the WavLM encoder's device work: the position
embedding and the 24 layers (``sdtk.wavlm.encoder``, self time;
``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("wavlm.encoder")
