"""Observability of the port: the AL loop's phase timer."""
