"""``python -m consensus_entropy_tpu_torch.analysis``: see
:mod:`consensus_entropy_tpu_torch.analysis.cli`."""

from consensus_entropy_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
