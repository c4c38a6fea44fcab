"""The filesystem seam for durable writes.

Counterpart of the write half of ``consensus_entropy_tpu/resilience/io.py``
(the WAL framing and repair wait for the serving layer).  Each call fires
the matching ``io.*`` fault point, so ``CETPU_FAULTS`` can drill the disk
failures a real run meets at the exact byte boundary.
"""

from __future__ import annotations

import errno
import os

from consensus_entropy_tpu_torch.resilience import faults


def write(f, data: bytes, *, path: str, member: str = "wal") -> None:
    """Write ``data`` to ``f`` through the short / ENOSPC / EIO points; a
    short write flushes half the payload before it fails."""
    try:
        faults.fire("io.write.short", member=member, path=path)
    except faults.InjectedKill:
        f.write(data[: len(data) // 2])
        f.flush()
        raise
    except faults.InjectedFault as e:
        f.write(data[: len(data) // 2])
        f.flush()
        raise OSError(errno.EIO, f"injected short write: {path}") from e
    try:
        faults.fire("io.write.enospc", member=member, path=path)
    except faults.InjectedFault as e:
        raise OSError(errno.ENOSPC,
                      f"injected ENOSPC (disk full): {path}") from e
    try:
        faults.fire("io.write.eio", member=member, path=path)
    except faults.InjectedFault as e:
        raise OSError(errno.EIO, f"injected EIO: {path}") from e
    f.write(data)


def fsync(f, *, path: str, member: str = "wal") -> None:
    """The durability barrier; an injected ``raise`` drops it silently
    (the lying disk)."""
    try:
        faults.fire("io.fsync", member=member, path=path)
    except faults.InjectedFault:
        return
    os.fsync(f.fileno())


def replace(src: str, dst: str, *, member: str = "wal") -> None:
    """Atomic rename through the ``io.rename`` point."""
    try:
        faults.fire("io.rename", member=member, path=dst)
    except faults.InjectedFault as e:
        raise OSError(errno.EIO, f"injected rename failure: {dst}") from e
    os.replace(src, dst)


def atomic_write(path: str, data: bytes, *, member: str = "wal") -> None:
    """Write a sibling, fsync it, rename it over ``path``: a reader sees
    the old content or the new.  A surfaced ``OSError`` removes the
    sibling first."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            write(f, data, path=tmp, member=member)
            f.flush()
            fsync(f, path=tmp, member=member)
        replace(tmp, path, member=member)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
