"""Acquisition-scoring ops on tensors (counterparts of
``consensus_entropy_tpu.ops``)."""
