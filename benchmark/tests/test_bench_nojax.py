"""The check on loaded modules compares whole top-level names."""

import subprocess
import sys

from benchmark.run import foreign_modules
from benchmark.tests.conftest import REPO


def test_port_passes_and_jax_package_fails():
    assert foreign_modules(["consensus_entropy_tpu_torch.x", "numpy",
                            "jaxtyping", "torch.nn"]) == []
    assert foreign_modules(["consensus_entropy_tpu.x"]) == [
        "consensus_entropy_tpu.x"]
    assert foreign_modules(["jax.numpy", "jaxlib", "flax.linen",
                            "consensus_entropy_tpu"]) == [
        "consensus_entropy_tpu", "flax.linen", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax():
    """The harness and the parts of the port a run drives load neither
    JAX nor the JAX package (in a fresh process: the test process itself
    may hold JAX for other tests)."""
    code = ("import benchmark.run, benchmark.check, benchmark.faults, "
            "benchmark.drivers.cohort, benchmark.inputs, benchmark.trace\n"
            "import consensus_entropy_tpu_torch.fleet.scheduler\n"
            "import consensus_entropy_tpu_torch.models.committee\n"
            "import consensus_entropy_tpu_torch.models.gbdt\n"
            "print(benchmark.run.foreign_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
