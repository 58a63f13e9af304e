"""Device ms a step of the operations launched in the benchmark's span around
``cluster_stage`` (``readers.cluster_device_ms``)."""

from benchlib.readers import cluster_device_ms as read  # noqa: F401
