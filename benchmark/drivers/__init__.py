"""Traffic drivers, one module a ``kind`` named in a traffic file."""
