"""Dataset loaders of the port (numpy and the standard library only)."""
