"""consensus-entropy active learning in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of ``consensus_entropy_tpu`` (JAX on a TPU), which stays beside it
as the reference.  This package imports ``torch`` and never ``jax`` nor any
module of the JAX package.  Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see :func:`device.resolve_device`); on a CPU
tensor every kernel wrapper runs its plain PyTorch version instead.

Ported so far (mc acquisition over a committee of softmax-linear members):

- ``ops.entropy``, ``ops.topk``, ``ops.scoring`` — the selection step;
- ``ops.device_members.linear_softmax_probs`` — the plain member forward;
- ``kernels.linear_mc`` + ``csrc/linear_mc.cu`` — the fused
  consensus-entropy kernel;
- ``convert`` — carries JAX-layout weights across;
- ``al.linear_pool.LinearPoolScorer`` — the AL acquisition loop over a
  device-resident pool.
"""

from consensus_entropy_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
