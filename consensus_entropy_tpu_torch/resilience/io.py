"""The filesystem seam for durable writes, and the WAL's record frames.

Counterpart of ``consensus_entropy_tpu/resilience/io.py`` (``:79-330``).

1. **The seam.**  Each call fires the matching ``io.*`` fault point, so
   ``CETPU_FAULTS`` can drill the disk failures a real run meets at the
   exact byte boundary: ``io.write.short`` lands half the payload, then
   the action fires; ``io.write.enospc`` / ``io.write.eio`` turn a
   ``raise`` into that ``OSError`` before any byte lands; ``io.fsync``
   drops the barrier on a ``raise`` (the lying disk); ``io.rename`` fails
   the atomic rename.  ``member=`` names the write family (``wal``,
   ``compact``, ``quarantine``, ``workspace``).
2. **Frames.**  One record a line::

       w1 <crc32 as 8 hex chars> <json payload>\\n

   The CRC covers the payload bytes exactly and the payload is
   ``json.dumps(rec)`` with its default separators and the record's own
   key order, so a frame is the same bytes whichever package wrote it and
   either package's reader replays the other's journal.  A fresh WAL
   opens with the framed header ``{"wal": 2}``; plain-JSON lines of older
   writers still parse (:func:`parse_frame`).  Corrupt lines go to a
   ``<path>.quarantine`` sidecar (offset, reason, raw bytes in base64),
   never silently away.

Listeners (:func:`add_listener`) are called as ``fn(kind, path)`` on every
injected io fault and every quarantined record; their errors are
swallowed, so telemetry never turns a survivable disk fault into a new
failure.
"""

from __future__ import annotations

import base64
import errno
import json
import os
import time
import zlib

from consensus_entropy_tpu_torch.resilience import faults

try:
    import fcntl
except ImportError:  # non-POSIX: repair falls back to a lock-less rewrite
    fcntl = None

#: frame version of the header record ``{"wal": 2}`` (version 1 is the
#: headerless plain-JSON format)
WAL_VERSION = 2
_MAGIC = b"w1 "
_CRC_LEN = 8  # crc32 as zero-padded hex

_listeners: list = []


def add_listener(fn) -> None:
    """Register ``fn(kind, path)`` for io-fault and quarantine events."""
    _listeners.append(fn)


def remove_listener(fn) -> None:
    try:
        _listeners.remove(fn)
    except ValueError:
        pass


def _notify(kind: str, path: str) -> None:
    for fn in list(_listeners):
        try:
            fn(kind, path)
        except Exception:
            pass  # observability must never amplify a disk fault


# -- the syscall seam ------------------------------------------------------


def open_append(path: str):
    """Open ``path`` for appending (the WAL writers' open)."""
    return open(path, "ab")  # cetpu: noqa[raw-durable-io] this IS the seam


def write(f, data: bytes, *, path: str, member: str = "wal") -> None:
    """Write ``data`` to ``f`` through the short / ENOSPC / EIO points; a
    short write flushes half the payload before it fails, so the torn
    bytes really are on disk for the recovery path to meet."""
    try:
        faults.fire("io.write.short", member=member, path=path)
    except faults.InjectedKill:
        f.write(data[: len(data) // 2])
        f.flush()
        _notify("io.write.short", path)
        raise
    except faults.InjectedFault as e:
        f.write(data[: len(data) // 2])
        f.flush()
        _notify("io.write.short", path)
        raise OSError(errno.EIO, f"injected short write: {path}") from e
    try:
        faults.fire("io.write.enospc", member=member, path=path)
    except faults.InjectedFault as e:
        _notify("io.write.enospc", path)
        raise OSError(errno.ENOSPC,
                      f"injected ENOSPC (disk full): {path}") from e
    try:
        faults.fire("io.write.eio", member=member, path=path)
    except faults.InjectedFault as e:
        _notify("io.write.eio", path)
        raise OSError(errno.EIO, f"injected EIO: {path}") from e
    f.write(data)


def fsync(f, *, path: str, member: str = "wal") -> None:
    """The durability barrier; an injected ``raise`` drops it silently
    (the lying disk)."""
    try:
        faults.fire("io.fsync", member=member, path=path)
    except faults.InjectedFault:
        _notify("io.fsync", path)
        return
    t0 = time.perf_counter()
    os.fsync(f.fileno())  # cetpu: noqa[raw-durable-io] this IS the seam
    faults.slow_hold("io.fsync", time.perf_counter() - t0)


def replace(src: str, dst: str, *, member: str = "wal") -> None:
    """Atomic rename through the ``io.rename`` point."""
    try:
        faults.fire("io.rename", member=member, path=dst)
    except faults.InjectedFault as e:
        _notify("io.rename", dst)
        raise OSError(errno.EIO, f"injected rename failure: {dst}") from e
    os.replace(src, dst)  # cetpu: noqa[raw-durable-io] this IS the seam


def atomic_write(path: str, data: bytes, *, member: str = "wal") -> None:
    """Write a sibling, fsync it, rename it over ``path``: a reader sees
    the old content or the new.  A surfaced ``OSError`` removes the
    sibling first; only a process death can leave one, and the journal's
    open-time sweep removes those."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:  # cetpu: noqa[raw-durable-io] this IS the seam
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


# -- record framing --------------------------------------------------------


def frame_record(rec: dict) -> bytes:
    """One framed line: ``w1 <crc32:08x> <json>\\n``."""
    payload = json.dumps(rec).encode("utf-8")
    crc = zlib.crc32(payload)
    return _MAGIC + f"{crc:08x}".encode("ascii") + b" " + payload + b"\n"


def frame_header() -> bytes:
    """The framed version header a fresh WAL opens with."""
    return frame_record({"wal": WAL_VERSION})


def is_header(rec) -> bool:
    """True for the ``{"wal": N}`` header record (no event; readers skip
    it)."""
    return isinstance(rec, dict) and "wal" in rec and "event" not in rec


def parse_frame(line: bytes):
    """One complete line -> ``(status, rec)``: ``("ok", rec)`` for a
    ``w1`` frame whose CRC matched, ``("legacy", rec)`` for a plain-JSON
    line, ``("corrupt", None)`` for a broken frame or a non-JSON line.
    The caller decides whether a line without its newline is a torn tail
    (a crash) or bit-rot."""
    body = line[:-1] if line.endswith(b"\n") else line
    if body.endswith(b"\r"):
        body = body[:-1]
    if body.startswith(_MAGIC):
        crc_end = len(_MAGIC) + _CRC_LEN
        if len(body) <= crc_end or body[crc_end:crc_end + 1] != b" ":
            return ("corrupt", None)
        try:
            crc = int(body[len(_MAGIC):crc_end], 16)
        except ValueError:
            return ("corrupt", None)
        payload = body[crc_end + 1:]
        if zlib.crc32(payload) != crc:
            return ("corrupt", None)
        try:
            return ("ok", json.loads(payload.decode("utf-8")))
        except (ValueError, UnicodeDecodeError):
            return ("corrupt", None)
    try:
        return ("legacy", json.loads(body.decode("utf-8")))
    except (ValueError, UnicodeDecodeError):
        return ("corrupt", None)


# -- quarantine sidecar ----------------------------------------------------


def quarantine_path(path: str) -> str:
    return path + ".quarantine"


def quarantine_append(path: str, *, off: int, raw: bytes,
                      reason: str) -> str:
    """Append one record (offset, reason, raw bytes in base64) to
    ``<path>.quarantine``, fsynced; returns the sidecar's path.  The
    sidecar is an audit trail and is never replayed."""
    qpath = quarantine_path(path)
    rec = {"off": int(off), "len": len(raw), "reason": reason,
           "raw_b64": base64.b64encode(raw).decode("ascii")}
    with open_append(qpath) as f:
        write(f, (json.dumps(rec) + "\n").encode("utf-8"),
              path=qpath, member="quarantine")
        f.flush()
        fsync(f, path=qpath, member="quarantine")
    _notify("record_quarantined", path)
    return qpath


# -- scan and repair -------------------------------------------------------


def scan_wal(path: str) -> dict:
    """Frame scan of one WAL: ``{"path", "lines", "ok", "legacy",
    "corrupt": [{"line", "off", "len", "reason"}, ...], "torn_tail"}``
    (1-based lines, byte offsets).  A last line without its newline is
    ``torn_tail``, not corruption."""
    out = {"path": path, "lines": 0, "ok": 0, "legacy": 0,
           "corrupt": [], "torn_tail": False}
    if not os.path.exists(path):
        return out
    with open(path, "rb") as f:
        raws = f.readlines()
    off = 0
    for i, raw in enumerate(raws, 1):
        out["lines"] += 1
        if not raw.endswith(b"\n"):
            out["torn_tail"] = True  # only the last line can lack it
            off += len(raw)
            continue
        status, _rec = parse_frame(raw)
        if status == "corrupt":
            out["corrupt"].append({"line": i, "off": off, "len": len(raw),
                                   "reason": "frame CRC/parse failure"})
        else:
            out[status if status == "legacy" else "ok"] += 1
        off += len(raw)
    return out


class WalLocked(RuntimeError):
    """A live writer holds the WAL's lock; repairing under it would break
    the single-writer discipline."""


def repair_wal(path: str) -> dict:
    """Move every corrupt line (and a torn tail) into the quarantine
    sidecar and rewrite the file atomically; refuses while a writer holds
    ``<path>.lock`` (:class:`WalLocked`).  Returns ``{"dropped": n,
    "quarantine": path or None}``."""
    lockf = None
    if fcntl is not None:
        lockf = open(path + ".lock", "ab")  # cetpu: noqa[raw-durable-io] zero-byte lock sibling, never fsynced
        try:
            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            lockf.close()
            raise WalLocked(
                f"{path}: a live writer holds this WAL's lock; stop the "
                "server before repairing")
    try:
        with open(path, "rb") as f:
            raws = f.readlines()
        kept, dropped, qpath, off = [], 0, None, 0
        for raw in raws:
            torn = not raw.endswith(b"\n")
            status = parse_frame(raw)[0] if not torn else "corrupt"
            if status == "corrupt":
                qpath = quarantine_append(
                    path, off=off, raw=raw,
                    reason="torn tail" if torn
                    else "frame CRC/parse failure")
                dropped += 1
            else:
                kept.append(raw)
            off += len(raw)
        if dropped:
            atomic_write(path, b"".join(kept), member="repair")
        return {"dropped": dropped, "quarantine": qpath}
    finally:
        if lockf is not None:
            lockf.close()
