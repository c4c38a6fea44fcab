"""``fsck``: offline integrity check of a users directory, of either
package.

Counterpart of ``consensus_entropy_tpu/cli/fsck.py:1-274``, with its scans,
report and exit codes, plus the port's own durable files, so one command
checks a tree either package wrote.  Host code only, no device:

- **journal and WALs** (``serve_journal.jsonl`` and its ``.ckpt``,
  ``serve_poison.jsonl``, ``fabric/events_*.jsonl`` and
  ``fabric/assign_*.jsonl``, whose frames both packages write alike):
  every complete line must be a valid CRC frame or legacy JSON; a torn
  last line, what a SIGKILL leaves, is reported but is no error.  The
  main journal also gets the structural replay check
  (``serve.journal.validate_journal_file``: known events, required
  fields, monotone seq).
- **CETPU1 checkpoints** (the JAX package's committee ``*.msgpack`` and
  state containers, sniffed by magic): header parse and payload CRC,
  from this module's own copy of the container format.
- **port member files** (every ``*.npz``: host, generic and CNN members,
  ``models/base.py::_write_npz``): the CRC32 trailer over the archive,
  then the archive's JSON header.
- **AL state** (``al_state.json`` and its ``.prev`` generation, as
  ``al/state.py::ALState.save`` writes them, the same in both packages):
  JSON that names the state's fields, each of its kind.
- **stale temporaries**: ``*.tmp`` files a killed writer left.

``--repair`` moves corrupt or torn WAL lines into each file's
``.quarantine`` sidecar under the writer's lock (a live writer makes the
file unrepairable, never racily rewritten), deletes stale temporaries and
verifies again.  Corrupt checkpoints, members and state files are never
"repaired": there is nothing to rebuild them from, and recovery rolls a
workspace back a generation (``al.state.rollback_workspace``).

Exit codes: 0 clean (or all repaired and verified again), 1 corruption
found (and left, or not repairable by design), 2 repair impossible (a
live writer holds a WAL's lock, or the filesystem refused)::

    python -m consensus_entropy_tpu_torch.cli.fsck models/users [--repair]
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import struct
import sys
import zipfile
import zlib

#: the JAX package's checkpoint container magic, matched byte-wise
_CKPT_MAGIC = b"CETPU1\n"
#: ``al/state.py::ALState``'s fields and their kinds (required, then the
#: ones a legacy state may lack)
STATE_FIELDS = {"next_epoch": "int", "trajectory": "list",
                "train_songs": "list", "test_songs": "list",
                "queried": "list", "key_data": "list", "key_dtype": "str",
                "mode": "str", "seed": "int"}
STATE_OPTIONAL = {"queries": "int", "train_size": "float",
                  "member_weights": "dict"}
STATE_NAMES = ("al_state.json", "al_state.json.prev")
_KINDS = {"int": lambda v: isinstance(v, int) and not isinstance(v, bool),
          "float": lambda v: (isinstance(v, (int, float))
                              and not isinstance(v, bool)),
          "str": lambda v: isinstance(v, str),
          "list": lambda v: isinstance(v, list),
          "dict": lambda v: v is None or isinstance(v, dict)}


def find_wals(users_dir: str) -> list[str]:
    """Every single-writer ledger file under ``users_dir``: the main
    journal and its compaction checkpoint, the poison list, and each
    worker's event and assignment WAL.  Telemetry streams (metrics, spans,
    logs) are left out: their readers tolerate damage by contract."""
    out = []
    for name in ("serve_journal.jsonl", "serve_journal.jsonl.ckpt",
                 "serve_poison.jsonl"):
        p = os.path.join(users_dir, name)
        if os.path.exists(p):
            out.append(p)
    fabric = os.path.join(users_dir, "fabric")
    out += sorted(glob.glob(os.path.join(fabric, "events_*.jsonl")))
    out += sorted(glob.glob(os.path.join(fabric, "assign_*.jsonl")))
    return out


def _walk(users_dir: str):
    """Every non-temporary file under the tree (files sorted within a
    directory, directories in ``os.walk``'s order, as the JAX scan)."""
    for root, _dirs, files in os.walk(users_dir):
        for name in sorted(files):
            if not name.endswith(".tmp"):
                yield os.path.join(root, name)


def find_checkpoints(users_dir: str) -> list[str]:
    """Every ``CETPU1`` container under the tree (sniffed by magic, not by
    extension)."""
    out = []
    for p in _walk(users_dir):
        try:
            with open(p, "rb") as f:
                if f.read(len(_CKPT_MAGIC)) == _CKPT_MAGIC:
                    out.append(p)
        except OSError:
            continue
    return out


def find_members(users_dir: str) -> list[str]:
    """Every port ``.npz`` file under the tree."""
    return [p for p in _walk(users_dir) if p.endswith(".npz")]


def find_states(users_dir: str) -> list[str]:
    """Every AL state file (either generation) under the tree."""
    return [p for p in _walk(users_dir)
            if os.path.basename(p) in STATE_NAMES]


def find_stale_tmps(users_dir: str) -> list[str]:
    out = []
    for root, _dirs, files in os.walk(users_dir):
        out += [os.path.join(root, n) for n in sorted(files)
                if n.endswith(".tmp")]
    return out


def verify_checkpoint(path: str) -> str | None:
    """None when the container verifies, else the reason (truncation and
    the payload CRC, without deserializing the payload)."""
    try:
        with open(path, "rb") as f:
            f.read(len(_CKPT_MAGIC))  # the caller matched the magic
            raw_len = f.read(4)
            if len(raw_len) != 4:
                return "truncated header"
            (hlen,) = struct.unpack("<I", raw_len)
            raw_meta = f.read(hlen)
            if len(raw_meta) != hlen:
                return "truncated meta"
            try:
                meta = json.loads(raw_meta.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                return "unparseable meta header"
            payload = f.read()
    except OSError as e:
        return f"unreadable: {e}"
    crc = meta.get("crc32") if isinstance(meta, dict) else None
    if crc is None:
        return None  # a checkpoint from before the CRC: loadable
    got = zlib.crc32(payload)
    if got != crc:
        return f"payload CRC mismatch (expected {crc}, got {got})"
    return None


def verify_member(path: str) -> str | None:
    """None when a port ``.npz`` verifies: its last 4 bytes are the CRC32
    of the rest (little endian), which is a zip archive holding a JSON
    ``meta`` entry."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        return f"unreadable: {e}"
    if len(data) < 4:
        return "truncated (no CRC32 trailer)"
    body, crc = data[:-4], int.from_bytes(data[-4:], "little")
    got = zlib.crc32(body)
    if got != crc:
        return f"CRC32 mismatch (trailer {crc}, archive {got})"
    try:
        with zipfile.ZipFile(io.BytesIO(body)) as z:
            if "meta.npy" not in z.namelist():
                return "archive lacks its meta header"
    except zipfile.BadZipFile as e:
        return f"not an npz archive: {e}"
    return None


def verify_state(path: str) -> str | None:
    """None when an AL state file parses and names ``ALState``'s fields,
    each of its kind; else the first fault."""
    try:
        with open(path, "rb") as f:
            rec = json.loads(f.read().decode("utf-8"))
    except OSError as e:
        return f"unreadable: {e}"
    except (ValueError, UnicodeDecodeError):
        return "unparseable JSON"
    if not isinstance(rec, dict):
        return "not a JSON object"
    for name, kind in STATE_FIELDS.items():
        if name not in rec:
            return f"lacks {name!r}"
        if not _KINDS[kind](rec[name]):
            return f"{name!r} must be {kind}, got {rec[name]!r}"
    for name in sorted(set(rec) - set(STATE_FIELDS)):
        if name not in STATE_OPTIONAL:
            return f"unknown field {name!r}"
        if not _KINDS[STATE_OPTIONAL[name]](rec[name]):
            return (f"{name!r} must be {STATE_OPTIONAL[name]}, got "
                    f"{rec[name]!r}")
    return None


def scan_users_dir(users_dir: str) -> dict:
    """The full report: per-WAL frame scans, the main journal's structural
    errors, checkpoint, member and state verdicts, stale temporaries."""
    from consensus_entropy_tpu_torch.resilience import io as dio
    from consensus_entropy_tpu_torch.serve.journal import (
        validate_journal_file,
    )

    report: dict = {"users_dir": users_dir, "wals": [], "checkpoints": [],
                    "stale_tmps": find_stale_tmps(users_dir),
                    "journal_errors": [], "members": [], "states": []}
    for path in find_wals(users_dir):
        report["wals"].append(dio.scan_wal(path))
    main = os.path.join(users_dir, "serve_journal.jsonl")
    if os.path.exists(main):
        report["journal_errors"] = validate_journal_file(main)
    for path in find_checkpoints(users_dir):
        report["checkpoints"].append(
            {"path": path, "error": verify_checkpoint(path)})
    for path in find_members(users_dir):
        report["members"].append({"path": path,
                                  "error": verify_member(path)})
    for path in find_states(users_dir):
        report["states"].append({"path": path, "error": verify_state(path)})
    return report


def _wal_bad(scan: dict) -> bool:
    return bool(scan["corrupt"]) or scan["torn_tail"]


def repair_users_dir(users_dir: str, report: dict) -> dict:
    """Quarantine corrupt and torn WAL lines and remove stale temporaries.
    Returns ``{"repaired": [...], "failed": [(path, why), ...]}``."""
    from consensus_entropy_tpu_torch.resilience import io as dio

    repaired, failed = [], []
    # temporaries first: repair_wal's atomic rewrite reuses the
    # ``<path>.tmp`` name a killed compaction may have left
    for tmp in report["stale_tmps"]:
        try:
            os.remove(tmp)
            repaired.append({"path": tmp, "removed": True})
        except FileNotFoundError:
            pass
        except OSError as e:
            failed.append((tmp, f"remove failed: {e}"))
    for scan in report["wals"]:
        if not _wal_bad(scan):
            continue
        try:
            res = dio.repair_wal(scan["path"])
        except dio.WalLocked:
            failed.append((scan["path"],
                           "a live writer holds the WAL lock — stop the "
                           "run (or let it finish) before repairing"))
        except OSError as e:
            failed.append((scan["path"], f"repair failed: {e}"))
        else:
            repaired.append({"path": scan["path"], **res})
    return {"repaired": repaired, "failed": failed}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fsck", description="Offline integrity check of a users "
        "directory of either package (WALs, checkpoints, member files, AL "
        "state, stale temporaries)")
    p.add_argument("users_dir",
                   help="the run's users directory (holds "
                        "serve_journal.jsonl and/or fabric/)")
    p.add_argument("--repair", action="store_true",
                   help="quarantine corrupt/torn WAL lines into "
                        "<file>.quarantine sidecars, delete stale .tmp "
                        "files, then re-verify")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable report on stdout")
    return p


def _bad_files(report: dict) -> int:
    """Checkpoints, member files and state files that fail to verify."""
    return sum(1 for key in ("checkpoints", "members", "states")
               for c in report[key] if c["error"])


def _print_report(report: dict) -> int:
    """Human summary; returns the number of integrity errors."""
    errors = 0
    for scan in report["wals"]:
        state = []
        if scan["corrupt"]:
            errors += len(scan["corrupt"])
            state.append(f"{len(scan['corrupt'])} corrupt")
        if scan["torn_tail"]:
            state.append("torn tail")
        label = ", ".join(state) if state else "ok"
        print(f"  wal  {scan['path']}: {scan['lines']} line(s), {label}")
        for c in scan["corrupt"]:
            print(f"         line {c['line']} (byte {c['off']}): "
                  f"{c['reason']}")
    for err in report["journal_errors"]:
        errors += 1
        print(f"  journal  {err}")
    for tag, key in (("ckpt", "checkpoints"), ("npz ", "members"),
                     ("state", "states")):
        for ck in report[key]:
            if ck["error"]:
                errors += 1
                print(f"  {tag} {ck['path']}: {ck['error']}")
            else:
                print(f"  {tag} {ck['path']}: ok")
    for tmp in report["stale_tmps"]:
        print(f"  tmp  {tmp}: stale temporary (a killed writer's "
              "leftover; --repair removes)")
    return errors


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.users_dir):
        print(f"cetpu-fsck: {args.users_dir}: not a directory",
              file=sys.stderr)
        return 2
    report = scan_users_dir(args.users_dir)
    errors = _print_report(report)
    dirty = errors or report["stale_tmps"]
    if not args.repair:
        if dirty:
            print(f"cetpu-fsck: {errors} integrity error(s), "
                  f"{len(report['stale_tmps'])} stale tmp(s) in "
                  f"{args.users_dir}")
        else:
            print(f"cetpu-fsck: clean — {args.users_dir}")
        if args.json:
            print(json.dumps(report, indent=2))
        return 1 if dirty else 0
    actions = repair_users_dir(args.users_dir, report)
    for r in actions["repaired"]:
        print(f"  repaired {r['path']}: "
              + (f"quarantined {r['dropped']} line(s) -> "
                 f"{r['quarantine']}" if "dropped" in r else "removed"))
    for path, why in actions["failed"]:
        print(f"  FAILED {path}: {why}")
    # verify again: the only trustworthy meaning of "repaired"
    after = scan_users_dir(args.users_dir)
    remaining = sum(len(s["corrupt"]) + (1 if s["torn_tail"] else 0)
                    for s in after["wals"])
    remaining += len(after["journal_errors"])
    ckpt_bad = _bad_files(after)
    if args.json:
        print(json.dumps({"before": report, "after": after,
                          "actions": {"repaired": actions["repaired"],
                                      "failed": actions["failed"]}},
                         indent=2))
    if actions["failed"]:
        print("cetpu-fsck: repair incomplete (see FAILED above)")
        return 2
    if remaining or ckpt_bad:
        # corrupt checkpoints, members or state files (nothing to rebuild
        # them from) and residual journal structure errors survive repair
        print(f"cetpu-fsck: {remaining} WAL/journal error(s) and "
              f"{ckpt_bad} corrupt checkpoint(s) remain after repair")
        return 1
    print(f"cetpu-fsck: repaired and re-verified — {args.users_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
