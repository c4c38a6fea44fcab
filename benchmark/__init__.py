"""The benchmark of the PyTorch and CUDA port: one cell run once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells; each cell's
configuration, traffic mix, limits and per-layer metric readers are files
of their own under this folder, found by name (``benchmark.spec``).
"""
