"""DEAM pre-training (committee construction)."""
