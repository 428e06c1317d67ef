"""Observability (port of ``cluster_tools_tpu/obs/``): the counter and gauge
registry only (``obs.metrics``)."""
