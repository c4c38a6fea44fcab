"""Observability of the port: phase timers, metrics, histograms and
sketches, the event writer, the span tracer and the device profiler's
capture, the readers and exports (``export``), dispatch scopes."""
