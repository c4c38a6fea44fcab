"""Several processes over ``torch.distributed``.

Counterpart of ``consensus_entropy_tpu/parallel/multihost.py``.  The JAX
package joins processes with ``jax.distributed`` and one global mesh spans
every process's chips.  Here each process (rank) holds a mesh of its own
devices and the process group joins the ranks:

- :func:`initialize` joins the group at an explicit ``tcp://`` address,
  NCCL for CUDA and gloo for the CPU; with no arguments it does nothing,
  so every entry point may call it;
- rank ``r`` of ``R`` owns the contiguous rows :func:`host_pool_slice`
  gives it, split over its own mesh (:func:`distribute_along`): a
  :class:`ShardedRows` whose offsets are global and whose blocks are only
  this rank's, so no process holds the whole pool;
- a select's candidate merge :func:`gather_ranks` every rank's ``k``
  candidates (``all_gather``, rank order) before the stable top-k, and
  :func:`gather_to_host` brings a sharded result back whole on every rank.

In one process every function reduces to the single-controller path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.parallel.mesh import (
    POOL_AXIS,
    Mesh,
    ShardedRows,
    make_pool_mesh,
)

_initialized = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None) -> None:
    """Join (or skip joining) the process group.

    ``coordinator_address``: ``host:port`` (or ``tcp://host:port``) of
    rank 0.  ``device``: where this process computes (``None`` is the
    card): NCCL for CUDA, each rank on card ``process_id`` modulo the
    cards it sees; gloo for the CPU.  With no arguments this does nothing;
    a repeat call is ignored."""
    global _initialized
    if coordinator_address is None and num_processes is None:
        return
    if _initialized or dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _initialized = True


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that owns every filesystem write (reports,
    checkpoints, workspace changes); a single process is it."""
    return process_index() == 0


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync(name: str = "sync") -> None:
    """Barrier across processes (a no-op in one).  The ``multihost.sync``
    fault point fires on the way in: a kill there is a process lost at a
    barrier."""
    from consensus_entropy_tpu_torch.resilience import faults

    faults.fire("multihost.sync", barrier=name)
    if process_count() > 1:
        dist.barrier()


def broadcast_flag(value: bool) -> bool:
    """The coordinator's boolean, agreed by every process, so control flow
    (skip a user, stop at a boundary) stays in lockstep."""
    if process_count() == 1:
        return bool(value)
    t = torch.tensor([int(bool(value))], dtype=torch.int32,
                     device=_comm_device())
    dist.broadcast(t, src=0)
    return bool(t.item())


def gather_ranks(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    rank order, on ``t``'s device; ``t`` itself in one process."""
    if process_count() == 1:
        return t
    dev = _comm_device()
    src = t.to(dev).contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=dim).to(t.device)


def pool_shards(mesh: Mesh) -> int:
    """The global pool axis's shard count: this process's pool devices
    times the processes.  Every pool-sharded row count is a multiple of
    it, so each rank's rows (:func:`host_pool_slice`) split evenly over
    its own devices."""
    return mesh.shape[POOL_AXIS] * process_count()


def global_pool_mesh(devices=None) -> Mesh:
    """This rank's pool mesh (its share of the global pool axis; the
    process group holds the other ranks'): its CUDA card under NCCL, the
    CPU under gloo, or ``devices``."""
    if devices is None and process_count() > 1:
        devices = [_comm_device()]
    return make_pool_mesh(devices)


def host_pool_slice(n_rows: int) -> slice:
    """The contiguous rows this process feeds; ``n_rows`` must divide
    across the processes (the pool padding makes it a multiple of
    :func:`pool_shards`, hence of the process count)."""
    n_proc = process_count()
    if n_rows % n_proc:
        raise ValueError(f"n_rows {n_rows} not divisible by "
                         f"{n_proc} processes")
    per = n_rows // n_proc
    pid = process_index()
    return slice(pid * per, (pid + 1) * per)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def distribute_along(local_block, global_shape: tuple,
                     mesh: Mesh | None = None, axis: int = 0,
                     axis_name: str = POOL_AXIS) -> ShardedRows:
    """This process's block of a global array, split over its mesh's
    ``axis_name`` devices: a :class:`ShardedRows` with global offsets
    (this rank's rows) and length ``global_shape[axis]``."""
    mesh = mesh or global_pool_mesh()
    local = ShardedRows.split(_tensor(local_block),
                              mesh.axis_devices(axis_name), axis)
    base = host_pool_slice(int(global_shape[axis])).start
    return ShardedRows(local.blocks, local.axis,
                       tuple(o + base for o in local.offsets),
                       int(global_shape[axis]))


def distribute_pool(local_rows, n_global_rows: int,
                    mesh: Mesh | None = None) -> ShardedRows:
    """Leading-axis :func:`distribute_along`."""
    return distribute_along(
        local_rows, (n_global_rows,) + tuple(local_rows.shape[1:]), mesh, 0)


def feed_pool_axis(arr, mesh: Mesh, axis: int = 0) -> ShardedRows:
    """Cut this process's :func:`host_pool_slice` out of a host-complete
    array (numpy or a tensor) and split it over the pool axis: the feed of
    every pool-sharded input.  In one process: the whole array split."""
    return feed_axis(arr, mesh, POOL_AXIS, axis)


def feed_axis(arr, mesh: Mesh, axis_name: str, axis: int = 0
              ) -> ShardedRows:
    """:func:`feed_pool_axis` onto any 1-D axis of ``mesh``."""
    arr = _tensor(arr)
    axis = axis % arr.dim()
    sl = host_pool_slice(arr.shape[axis])
    block = arr.narrow(axis, sl.start, sl.stop - sl.start)
    return distribute_along(block, tuple(arr.shape), mesh, axis, axis_name)


def feed_replicated(tree, mesh: Mesh):
    """A tree (dict, list, tuple) of values every process holds alike, as
    tensors on the mesh's first device; a sharded call copies such an
    operand once per distinct device."""
    dev = mesh.device_list[0]
    if isinstance(tree, dict):
        return {k: feed_replicated(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(feed_replicated(v, mesh) for v in tree)
    return _tensor(tree).to(dev)


def gather_to_host(out) -> np.ndarray:
    """A (possibly sharded) result as a host-complete numpy array on
    every process."""
    if not isinstance(out, ShardedRows):
        return out.cpu().numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out)
    local = out.full()
    return gather_ranks(local, out.axis).cpu().numpy()


def broadcast_tensor(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every process (``t`` itself in one), on
    ``t``'s device; the other ranks' ``t`` gives only shape and dtype."""
    if process_count() == 1:
        return t
    # a copy: the broadcast writes into it on the receiving ranks
    buf = t.detach().to(_comm_device(), copy=True).contiguous()
    dist.broadcast(buf, src=src)
    return buf.to(t.device)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every process (``obj`` itself
    in one)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=_comm_device())
    return box[0]
