"""Active-learning drivers of the port."""
