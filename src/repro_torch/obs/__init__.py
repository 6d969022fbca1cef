"""Observability for the port: span tracing (``trace``) and the metrics
registry (``metrics``), copies of ``repro.obs.trace`` / ``repro.obs.metrics``
with the same span and metric names."""
