"""consensus-entropy active learning in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of ``consensus_entropy_tpu`` (JAX on a TPU), which stays beside it
as the reference.  This package imports ``torch`` and never ``jax`` nor any
module of the JAX package.  Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see :func:`device.resolve_device`); on a CPU
tensor every kernel wrapper runs its plain PyTorch version instead.

Ported so far:

- ``ops.entropy``, ``ops.topk``, ``ops.scoring`` — the selection step of
  every acquisition mode (mc, hc, mix, rand, qbdc, wmc), fused and not;
- ``prng`` — threefry-2x32, bit-equal with ``jax.random``;
- ``ops.device_members``, ``models.committee`` — the closed-form members
  (GaussianNB, SGD-logistic, softmax-linear) and the device-member
  committee over a ``FramePool``;
- ``acquire`` and ``al.acquisition.Acquirer`` — the mode registry and the
  per-user acquisition state that maps selections to song ids;
- ``kernels.linear_mc`` + ``csrc/linear_mc.cu`` — the fused
  consensus-entropy kernel for softmax-linear members, and
  ``al.linear_pool.LinearPoolScorer``, the AL loop over it;
- ``models.members``, ``models.committee.Committee`` — GaussianNB and
  SGD-logistic members that train as scikit-learn does, and the host
  committee;
- ``data.amg``, ``labels`` — the AMG1608 loaders and label codecs;
- ``al`` (``loop``, ``state``, ``workspace``, ``reporting``) and
  ``fleet.session`` — the per-user AL loop with resume, and ``cli.amg_test``,
  its sequential CLI; ``resilience`` and ``obs`` — fault injection, retry,
  durable writes, preemption, phase timing;
- ``native`` + ``native/ce_gbdt.cpp``, ``models.gbdt`` — the boosted
  committee slot: gradient-boosted trees with continued boosting, their
  tree build and forest predict in C++ built with the host compiler;
- ``ops.mel``, ``data.audio``, ``models.short_cnn``, ``models.cnn_trainer``
  and the CNN half of ``models.committee`` — the vgg ShortChunkCNN members:
  log-mel frontend, device waveform store and crops, forward, qbdc's
  dropout committee and the retraining schedule;
- ``data.deam``, ``train.pretrain``, ``cli.deam_classifier`` — DEAM
  pre-training without pandas or scikit-learn: the frame join and its
  cache, grouped CV folds of every ported member kind and the CNN trunks;
  ``native/ce_sgd.cpp`` — the SGD member's epoch loop in the host core;
- ``al.evidence``, ``cli.evidence`` — the matched-budget mode sweep and the
  paper's paired t-tests;
- ``fleet`` and ``parallel`` — cohorts of users stacked into one dispatch,
  and pools split over a device mesh;
- ``serve``, ``workload`` and ``obs`` — serving (bucketed continuous
  admission, the admission journal, the watchdog, the breaker, the SLO
  planner; the multi-host fabric with lease failover, the elastic and
  self-healing planes, and its alerts), trace-driven load and its grader,
  the span tracer and its export;
- ``config``, ``utils``, ``convert`` — the configuration read here, helpers,
  and JAX-layout weights, members (CNN checkpoints included), workspaces
  and keys carried across;
- ``analysis`` — cetpu-lint's twelve rules over the port's tree (pure
  ``ast``: it imports none of the code it reads, nor torch);
  ``cli.race_check`` with ``native/ce_stress.cpp`` — the host core under
  ThreadSanitizer and oversubscribed OpenMP; ``cli.reproduce`` and
  ``data.synth`` — the paper's pipeline (pre-training, then every
  acquisition mode) and its pandas-free ``--smoke`` tree.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # resolve_device on first use: importing the package imports no torch,
    # so the static analysis (``analysis``), which reads the port's source
    # and imports none of it, starts without it
    if name == "resolve_device":
        from consensus_entropy_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
