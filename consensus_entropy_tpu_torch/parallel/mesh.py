"""Device meshes and the row-sharded tensor they hold.

Counterpart of ``consensus_entropy_tpu/parallel/mesh.py``.  The axis
vocabulary is the JAX package's:

- ``pool``: the unlabeled-pool axis (N songs), split across devices for
  scoring; every reduction of a select is row-local, so only the ``k``
  candidates of each shard cross devices;
- ``member``: the committee axis, split for retraining;
- ``dp``: the batch data-parallel axis of training;
- ``seq``: the window axis of one long song (``parallel.sequence``).

A :class:`Mesh` is a grid of ``torch.device`` entries with named axes.  It
hashes by value, as ``jax.sharding.Mesh`` does, so families cached on it
hit across users.  ``devices=None`` is every visible CUDA device, once
each; there is no CPU fallback.  An explicit list may repeat a device: the
shards on it then run one after another there.  That is how the CPU tests
build a 2-, 4- or 8-way mesh (``["cpu"] * 4``, where the JAX tests force
host devices) and how one card holds a 4-way mesh (``["cuda:0"] * 4``).

A pool-sharded operand is a :class:`ShardedRows`: contiguous row blocks,
one per mesh device and on it, with their offsets and the global length.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from consensus_entropy_tpu_torch.device import resolve_device

POOL_AXIS = "pool"
MEMBER_AXIS = "member"
DP_AXIS = "dp"
SEQ_AXIS = "seq"


def _device(d) -> torch.device:
    """One mesh entry: a checked ``torch.device``, a bare ``cuda`` made
    ``cuda:<current>`` so equal meshes compare equal."""
    dev = resolve_device(d)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {index}: this process has "
                             f"{torch.cuda.device_count()}")
        dev = torch.device("cuda", index)
    return dev


def local_devices(devices=None) -> list[torch.device]:
    """``devices`` checked, or every visible CUDA device once each (raises
    when there is none)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible; give the mesh its devices "
                "explicitly (e.g. ['cpu'] * 4) to run it on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A row-major grid of devices with named axes (``axis_names``, one
    size each in ``axis_sizes``)."""

    device_list: tuple
    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes "
                             f"{self.axis_sizes}")
        if int(np.prod(self.axis_sizes)) != len(self.device_list):
            raise ValueError(f"mesh {dict(self.shape)} does not hold "
                             f"{len(self.device_list)} devices")

    @property
    def shape(self) -> dict:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.device_list)

    @property
    def devices(self) -> np.ndarray:
        """The device grid, ``axis_sizes``-shaped."""
        grid = np.empty(len(self.device_list), dtype=object)
        grid[:] = list(self.device_list)
        return grid.reshape(self.axis_sizes)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: the
        homes of the axis's shards."""
        grid = self.devices
        pos = self.axis_names.index(axis)
        index = [0] * grid.ndim
        index[pos] = slice(None)
        return list(grid[tuple(index)])


def _mesh(devices, names: tuple, sizes: tuple | None = None) -> Mesh:
    devices = tuple(local_devices(devices))
    return Mesh(devices, names, sizes or (len(devices),))


def make_pool_mesh(devices=None) -> Mesh:
    """1-D mesh, pool axis only: committee probs ``(M, N, C)`` split on N;
    the mean and the entropy are row-local, and only the top-k gathers
    ``k`` candidates a shard."""
    return _mesh(devices, (POOL_AXIS,))


def make_seq_mesh(devices=None) -> Mesh:
    """1-D mesh, sequence axis only: a long song's windows split
    contiguously, the overlap halo copied from the right neighbour."""
    return _mesh(devices, (SEQ_AXIS,))


def make_training_mesh(dp: int | None = None, member: int | None = None,
                       devices=None) -> Mesh:
    """2-D ``(dp, member)`` mesh for committee training.  By default as
    many devices as divide 4 go on ``member``, the rest on ``dp``."""
    devices = local_devices(devices)
    n = len(devices)
    if dp is None and member is None:
        member = _largest_divisor_at_most(n, 4)
        dp = n // member
    elif dp is None:
        dp = n // member  # type: ignore[operator]
    elif member is None:
        member = n // dp
    if dp * member != n:
        raise ValueError(f"dp*member = {dp}*{member} != {n} devices")
    return Mesh(tuple(devices), (DP_AXIS, MEMBER_AXIS), (dp, member))


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


@dataclasses.dataclass(eq=False)
class ShardedRows:
    """A tensor split on ``axis`` into contiguous blocks, block ``s`` on
    ``devices[s]`` holding global rows ``[offsets[s], offsets[s] +
    len_s)`` of ``n``.  A block's leading axes (a fleet's user axis) are
    whole on every device."""

    blocks: list
    axis: int
    offsets: tuple
    n: int

    @classmethod
    def split(cls, t: torch.Tensor, devices: Sequence,
              axis: int) -> "ShardedRows":
        """Copy ``t`` onto ``devices`` in equal row blocks along ``axis``
        (negative counts from the end); the row count must divide."""
        axis = axis % t.dim()
        n, d = t.shape[axis], len(devices)
        if n % d:
            raise ValueError(f"{n} rows do not divide across {d} shards; "
                             f"pad to a multiple of {d}")
        per = n // d
        blocks = [t.narrow(axis, s * per, per).to(dev, copy=True)
                  .contiguous() for s, dev in enumerate(devices)]
        return cls(blocks, axis, tuple(s * per for s in range(d)), n)

    @property
    def devices(self) -> list[torch.device]:
        return [b.device for b in self.blocks]

    @property
    def device(self) -> torch.device:
        """The first shard's device, where gathers land."""
        return self.blocks[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def shape(self) -> tuple:
        shape = list(self.blocks[0].shape)
        shape[self.axis] = self.n
        return tuple(shape)

    def block_len(self, s: int) -> int:
        return self.blocks[s].shape[self.axis]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, gathered onto ``device`` (default the first
        shard's)."""
        dev = self.device if device is None else device
        return torch.cat([b.to(dev) for b in self.blocks], dim=self.axis)

    def map(self, fn: Callable) -> "ShardedRows":
        """``fn`` on every block (a row-local function: it keeps the
        sharded axis where it is)."""
        return ShardedRows([fn(b) for b in self.blocks], self.axis,
                           self.offsets, self.n)

    def copy_(self, other: "ShardedRows") -> "ShardedRows":
        """Overwrite every block in place from ``other``'s."""
        for b, o in zip(self.blocks, other.blocks):
            b.copy_(o)
        return self

    def __getitem__(self, i: int) -> "ShardedRows":
        """Row ``i`` of the leading (unsharded) axis, as views."""
        if self.axis == 0:
            raise IndexError("the leading axis is the sharded one")
        return ShardedRows([b[i] for b in self.blocks], self.axis - 1,
                           self.offsets, self.n)

    @classmethod
    def stack(cls, items: Sequence["ShardedRows"]) -> "ShardedRows":
        """Stack equal layouts on a new leading axis, block by block."""
        first = items[0]
        for it in items[1:]:
            if (it.offsets, it.n, it.axis, it.devices) != (
                    first.offsets, first.n, first.axis, first.devices):
                raise ValueError("stacked operands differ in layout")
        return cls([torch.stack([it.blocks[s] for it in items])
                    for s in range(len(first.blocks))],
                   first.axis + 1, first.offsets, first.n)
