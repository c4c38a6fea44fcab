"""Device meshes, pool-sharded selects, sequence parallelism and several
processes.

Counterpart of ``consensus_entropy_tpu/parallel/``: a :class:`Mesh` of
``torch.device`` entries whose ``pool`` axis splits the unlabeled pool
across devices (and whose ``member`` / ``dp`` axes split committee
training), row-sharded operands (:class:`ShardedRows`), and
``torch.distributed`` between processes (``parallel.multihost``).
"""

from consensus_entropy_tpu_torch.parallel.mesh import (  # noqa: F401
    DP_AXIS,
    MEMBER_AXIS,
    POOL_AXIS,
    SEQ_AXIS,
    Mesh,
    ShardedRows,
    make_pool_mesh,
    make_seq_mesh,
    make_training_mesh,
)
