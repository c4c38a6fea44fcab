"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain PyTorch
versions.  Importing this package builds nothing: a kernel is compiled
(:mod:`.build`) the first time its wrapper sees a CUDA tensor."""
