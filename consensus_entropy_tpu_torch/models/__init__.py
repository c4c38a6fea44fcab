"""Committees of the port (counterparts of ``consensus_entropy_tpu.models``)."""
