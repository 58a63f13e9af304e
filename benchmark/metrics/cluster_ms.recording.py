"""Host ms a recording of the ``spectral_cluster`` call, which returns NumPy
labels, so its end is synchronized; the median over the window's recordings
(``readers.cluster_host_ms``)."""

from benchlib.readers import cluster_host_ms as read  # noqa: F401
