"""Host ms a recording of the affinity, its refinement and Laplacian, and the
eigensolve (``sdtk.cluster.affinity``, ``sdtk.cluster.eig``, self time;
``spans.ms_per_step``)."""

from benchlib.spans import ms_per_step

read = ms_per_step("cluster.affinity", "cluster.eig")
