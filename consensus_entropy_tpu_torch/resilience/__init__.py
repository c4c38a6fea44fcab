"""Fault tolerance of the AL loop: fault injection at named boundaries
(``faults``), bounded retry (``retry``), the durable-write seam (``io``)
and clean preemption (``preemption``)."""
