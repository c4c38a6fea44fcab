"""The plain reference the benchmark judges the system under test by.

Plain PyTorch and numpy: it imports neither JAX nor the JAX package nor
anything of the system under test, and works out from the benchmark's own
inputs whatever it compares (crops, permutations and dropout masks from
the seed's key stream, the split, the retrain).
"""
