"""Small host helpers (counterpart of ``consensus_entropy_tpu/utils``)."""


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n`` (fixed-shape
    padding)."""
    return ((n + multiple - 1) // multiple) * multiple
