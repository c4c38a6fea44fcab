"""Observability of the port: phase timers, the metrics registry and
event writer, dispatch scopes and the null tracer."""
