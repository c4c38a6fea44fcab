"""The admission journal: a durable WAL of the serve layer's user state.

Counterpart of ``consensus_entropy_tpu/serve/journal.py`` (``:125-964``),
``JsonlTail`` (the fabric's feed and event-WAL follower) included.
``FleetServer`` journals every admission transition to
``users/serve_journal.jsonl``:

- **append-fsync**: each transition (``enqueue`` / ``admit`` / ``finish``
  / ``fail`` / ``poison`` / ``unpoison``) is one CRC-framed line
  (``resilience.io.frame_record``), flushed and fsynced before the server
  acts on it.  ``finish`` is appended after the driver's ``on_result``
  persistence ran, so a finished user's workspace is final (a crash
  between the two re-finishes the user idempotently).
- **replay**: a restarted server builds a :class:`JournalState`; each
  user's last event decides its disposition, and a torn last line (the
  crash itself) counts as never written.  Finished users are skipped;
  in-flight users (last event ``admit`` or ``fail``) are re-admitted first
  and resume from their workspaces; queued users re-enter the queue in
  enqueue order; admission counts survive, so the failure budget does.
- **poison list**: a sibling append-fsync file (:class:`PoisonList`) of
  users past their failure budget; ``--unpoison`` appends removals.
- **fabric records** (``assign``, ``lease``, ``remedy``, ``epoch``, ...):
  the multi-host fabric (``serve.fabric``) writes them into the same
  journal, and :class:`JournalState` replays them whole, so a journal
  either package wrote replays in the other to an equal state.
- **compaction**: :meth:`AdmissionJournal.compact` checkpoints the state to
  ``<journal>.ckpt`` and truncates the journal, each by write-new-then-
  rename; every record carries a monotonic ``seq`` and the checkpoint the
  last one applied, so a crash between the two renames replays the stale
  tail idempotently.  ``compact_bytes`` compacts from ``append``.

Records carry user ids (as strings), never payloads: the committee and
AL state live in the workspaces, which the two-phase checkpoint already
makes durable.  One process writes one journal; the first append flocks
``<path>.lock`` for the writer's lifetime, so a second writer (say,
``--unpoison`` beside a live server) fails with
:class:`SingleWriterViolation` instead of interleaving seq numbers.
"""

from __future__ import annotations

import json
import os
import threading
import time

from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience import io as dio

#: admission transitions a journal line may carry (user-scoped).
#: ``assign`` and ``drop`` are fabric ROUTING records: they move a user
#: between hosts (or acknowledge a rebalance withdrawal) without touching
#: its admission disposition.  ``fence`` is the in-flight-migration
#: sibling of ``drop``: the source worker's ack that it released (or
#: refused to release) an IN-FLIGHT user at a checkpoint boundary —
#: disposition untouched, the follow-up assign commits the move.
EVENTS = ("enqueue", "admit", "finish", "fail", "poison", "unpoison",
          "assign", "drop", "fence")
#: host-membership records (fabric): no user field.  ``spawn`` journals
#: the elastic control plane's decision to add a host (autoscaler respawn
#: / scale-up / operator adoption), ``lease`` its process coming up,
#: ``join`` its first observed heartbeat (the rebalance trigger),
#: ``revoke`` its death — a coordinator restart replays the same fleet
#: shape from these records alone.  ``drain`` journals the scale-down
#: decision (the host stops admitting and sheds its users) and
#: ``drain_done`` its clean retirement: both take the host OUT of the
#: replayed fleet shape, so a coordinator SIGKILLed mid-drain restarts
#: at the post-drain size and simply re-routes the drained host's
#: remaining users (never respawns capacity it decided to shed).
HOST_EVENTS = ("lease", "revoke", "spawn", "join", "drain", "drain_done")
#: SLO-planner epoch records (no user field): ``edges`` (the derived
#: bucket edges in force) + ``sketch`` (the quantile-sketch state), so a
#: restarted server re-derives IDENTICAL routing from replay alone
PLANNER_EVENTS = ("planner",)
#: remediation-plane decisions (``serve.remedy`` / the coordinator's
#: remedy pump): ``host`` + ``action`` (``rebalance`` — drain-for-
#: rebalance on an overloaded host; ``fence_timeout`` — a checkpoint
#: fence unacked past the operator deadline fell back to evict+resume,
#: carrying the fenced ``user``).  A SEPARATE kind from ``HOST_EVENTS``
#: on purpose: a remedy record is an audit ledger entry — it changes no
#: membership (the host stays live and joined), no disposition and no
#: routing, so replay folds it into the cursor/seq only and the actions
#: it drove re-derive from the ack-gated records that follow it.
REMEDY_EVENTS = ("remedy",)
#: gray-failure ladder records (``serve.remedy`` ladder / the
#: coordinator's gray pump): ``probation`` carries ``host`` + ``on``
#: (bool).  UNLIKE a remedy record this one IS replayed: probation is
#: ROUTING state (placement stops handing NEW users to the host), so a
#: coordinator SIGKILLed mid-ladder must restart with the same hosts
#: still on probation — the set folds into ``JournalState.probation``
#: and survives compaction via the checkpoint.
PROBATION_EVENTS = ("probation",)
#: coordinator fencing-epoch records: ``epoch`` journals an incarnation's
#: claim (monotonic — each coordinator claims one greater than any the
#: journal has seen, so feed lines and acks are attributable to exactly
#: one incarnation), ``epoch_fenced`` the audit record of a STALE
#: incarnation being refused (a worker rejecting an old feed line, or
#: the coordinator discarding an old-epoch ack as cursor-only).  Neither
#: touches dispositions/membership/routing: replay folds the claim into
#: ``coordinator_epoch`` and the fence records into the cursor only.
EPOCH_EVENTS = ("epoch", "epoch_fenced")


class JournalState:
    """The replayed disposition of every user a journal has seen.

    ``last[user]`` is the user's final journaled event; :meth:`recovery_order`
    turns that into the restart admission order — in-flight users first
    (their workspaces hold the most sunk work), then still-queued users in
    their enqueue order, then users the journal never saw.

    Fabric bookkeeping rides along without touching dispositions:
    ``assigned[user]`` is the host a coordinator last routed the user to,
    ``hosts[host]`` the host's lease state (``lease``/``revoke``), and
    ``host_cursor[host]`` the durable transcription offset into that
    host's event file."""

    def __init__(self):
        self.last: dict[str, str] = {}
        self.admits: dict[str, int] = {}
        self.fails: dict[str, int] = {}
        self.assigned: dict[str, str] = {}
        self.hosts: dict[str, str] = {}
        self.host_cursor: dict[str, int] = {}
        #: SLO admission state (serve.planner): each user's priority
        #: class (from enqueue records) and admitted bucket width (from
        #: admit records) — restarts re-pin both; plus the last planner
        #: epoch's edges + sketch and the enqueue-time pool sizes
        #: journaled SINCE it (the bounded replay tail the restarted
        #: planner re-observes)
        self.classes: dict[str, str] = {}
        self.widths: dict[str, int] = {}
        #: each user's enqueue-time pool size (from ``enqueue`` records
        #: carrying ``pool``) — the bucket-aware placement policy's input,
        #: so a restarted coordinator places from replay alone
        self.pools: dict[str, int] = {}
        self.planner_edges: list | None = None
        self.planner_sketch: dict | None = None
        self.pool_obs: list[int] = []
        #: the highest coordinator fencing epoch the journal has seen —
        #: a new incarnation claims ``coordinator_epoch + 1``
        self.coordinator_epoch = 0
        #: hosts currently on gray-failure probation (``probation``
        #: records with ``on`` toggling membership): placement must not
        #: route NEW users to them, so the set is part of replayed state
        self.probation: set = set()
        self._enqueue_seq: dict[str, int] = {}
        self._admit_seq: dict[str, int] = {}
        self._seq = 0

    @property
    def seq(self) -> int:
        """The last applied record seq (the compaction watermark)."""
        return self._seq

    def apply(self, rec: dict) -> None:
        event = rec.get("event")
        if event not in EVENTS and event not in HOST_EVENTS \
                and event not in PLANNER_EVENTS \
                and event not in REMEDY_EVENTS \
                and event not in PROBATION_EVENTS \
                and event not in EPOCH_EVENTS:
            return  # foreign/corrupt line: disposition unchanged
        seq = rec.get("seq")
        if isinstance(seq, int):
            if seq <= self._seq:
                return  # pre-checkpoint duplicate (crash mid-compaction)
            self._seq = seq
        else:  # pre-seq journal line (older writers)
            self._seq += 1
        host = rec.get("host")
        if isinstance(host, str) and isinstance(rec.get("src_off"), int):
            self.host_cursor[host] = max(self.host_cursor.get(host, 0),
                                         rec["src_off"])
        if event in EPOCH_EVENTS:
            # the claim folds into the monotonic epoch watermark; an
            # ``epoch_fenced`` audit record is seq/cursor-only (the fold
            # above), like a remedy — no disposition, no routing
            if event == "epoch" and isinstance(rec.get("epoch"), int):
                self.coordinator_epoch = max(self.coordinator_epoch,
                                             rec["epoch"])
            return
        if event in REMEDY_EVENTS:
            # an audit ledger entry: no membership change (the host
            # stays live — this is what distinguishes a remedy from a
            # drain), no disposition, no routing.  The seq/cursor fold
            # above is all replay needs; the actions the decision drove
            # re-derive from the ack-gated records that follow it.
            return
        if event in PROBATION_EVENTS:
            # routing state, NOT membership: the host stays live and
            # joined, but placement must not hand it NEW users until a
            # lift record (``on: false``) clears it
            if isinstance(host, str):
                if rec.get("on") is False:
                    self.probation.discard(host)
                else:
                    self.probation.add(host)
            return
        if event in HOST_EVENTS:
            if isinstance(host, str):
                self.hosts[host] = event
            return
        if event in PLANNER_EVENTS:
            edges = rec.get("edges")
            if isinstance(edges, list):
                self.planner_edges = [int(e) for e in edges]
            sketch = rec.get("sketch")
            self.planner_sketch = sketch if isinstance(sketch, dict) \
                else None
            # the sketch covers everything observed so far: the replay
            # tail restarts empty
            self.pool_obs = []
            return
        user = rec.get("user")
        if not isinstance(user, str):
            return
        if event == "assign":
            # routing only: a (re)assignment never changes whether the
            # user is queued/in-flight — the worker's transcribed events do
            if isinstance(host, str):
                self.assigned[user] = host
            return
        if event in ("drop", "fence"):
            # rebalance/migration bookkeeping (a worker acknowledged
            # withdrawing a still-queued user, or releasing an in-flight
            # one at a checkpoint boundary): disposition unchanged — the
            # user stays enqueued/admitted at fabric level and the
            # follow-up assign re-routes it
            return
        self.last[user] = event
        if event == "enqueue":
            self._enqueue_seq[user] = self._seq
            if isinstance(rec.get("cls"), str):
                self.classes[user] = rec["cls"]
            if isinstance(rec.get("pool"), int):
                self.pool_obs.append(rec["pool"])
                self.pools[user] = rec["pool"]
        elif event == "admit":
            self.admits[user] = self.admits.get(user, 0) + 1
            self._admit_seq.setdefault(user, self._seq)
            if isinstance(rec.get("width"), int):
                self.widths[user] = rec["width"]
        elif event == "fail":
            self.fails[user] = self.fails.get(user, 0) + 1
        elif event == "unpoison":
            # the operator asked for a fresh start: the budget counters
            # must not instantly re-poison the user on its next failure
            self.admits.pop(user, None)
            self.fails.pop(user, None)

    @property
    def finished(self) -> set:
        return {u for u, e in self.last.items() if e == "finish"}

    @property
    def poisoned(self) -> set:
        return {u for u, e in self.last.items() if e == "poison"}

    @property
    def in_flight(self) -> list:
        """Users whose last event is ``admit`` or ``fail`` (admitted, never
        finished — the crash interrupted them), first-admit order."""
        live = [u for u, e in self.last.items() if e in ("admit", "fail")]
        return sorted(live, key=lambda u: self._admit_seq.get(u, 0))

    @property
    def queued(self) -> list:
        """Users whose last event is ``enqueue`` (waiting when the server
        died, or re-queued by backoff), enqueue order."""
        q = [u for u, e in self.last.items() if e == "enqueue"]
        return sorted(q, key=lambda u: self._enqueue_seq.get(u, 0))

    @property
    def pending(self) -> list:
        return self.in_flight + self.queued

    def live_hosts(self) -> list:
        """Hosts whose last membership record says they are up (a lease
        grant, or the elastic JOIN that follows the first heartbeat)."""
        return sorted(h for h, e in self.hosts.items()
                      if e in ("lease", "join"))

    def fleet_hosts(self) -> list:
        """The replayed fleet SHAPE: every host whose last membership
        record is not a revoke or a drain — including ``spawn`` records
        whose process never published a lease (the restart must still
        stand that capacity up).  A ``drain`` record without its
        ``drain_done`` counts as OUT too: the scale-down decision is
        durable the moment it journals, so a coordinator SIGKILLed
        mid-drain restarts at the post-drain size and re-routes the
        drained host's users instead of respawning shed capacity.  A
        restarted elastic coordinator respawns exactly these ids, so the
        fleet shape is a pure function of the journal."""
        return sorted(h for h, e in self.hosts.items()
                      if e not in ("revoke", "drain", "drain_done"))

    def draining_hosts(self) -> list:
        """Hosts whose last membership record is ``drain`` — a drain the
        coordinator never journaled ``drain_done`` for (it was killed
        mid-drain).  The restart retires them (their workers orphan-exit
        with the dead coordinator) and re-routes their users."""
        return sorted(h for h, e in self.hosts.items() if e == "drain")

    def assigned_to(self, host: str) -> list:
        """This host's unresolved users, in-flight first (first-admit
        order) then queued (enqueue order) — the failover re-admission
        order for a revoked host."""
        mine = {u for u, h in self.assigned.items() if h == host}
        return ([u for u in self.in_flight if u in mine]
                + [u for u in self.queued if u in mine])

    def recovery_order(self, user_ids) -> list:
        """Reorder ``user_ids`` for a restarted submit pass: in-flight
        first, then journal-queued in enqueue order, then unseen users in
        their given order, then finished users last (they cost one skip
        check each — keeping them lets the driver surface its normal
        "skipping" message).  Poisoned users are dropped outright."""
        by_key = {}
        for u in user_ids:
            by_key.setdefault(str(u), u)
        out = []
        for key in self.pending:
            if key in by_key:
                out.append(by_key.pop(key))
        done, poisoned = self.finished, self.poisoned
        out.extend(u for k, u in by_key.items()
                   if k not in done and k not in poisoned)
        out.extend(u for k, u in by_key.items() if k in done)
        return out

    # -- checkpoint serialization (compaction) -----------------------------

    def to_dict(self) -> dict:
        return {"seq": self._seq, "last": dict(self.last),
                "admits": dict(self.admits), "fails": dict(self.fails),
                "assigned": dict(self.assigned), "hosts": dict(self.hosts),
                "host_cursor": dict(self.host_cursor),
                "classes": dict(self.classes), "widths": dict(self.widths),
                "pools": dict(self.pools),
                "planner_edges": self.planner_edges,
                "planner_sketch": self.planner_sketch,
                "pool_obs": list(self.pool_obs),
                "coordinator_epoch": self.coordinator_epoch,
                "probation": sorted(self.probation),
                "enqueue_seq": dict(self._enqueue_seq),
                "admit_seq": dict(self._admit_seq)}

    @classmethod
    def from_dict(cls, d: dict) -> "JournalState":
        st = cls()
        st._seq = int(d.get("seq", 0))
        st.last = dict(d.get("last", {}))
        st.admits = {k: int(v) for k, v in d.get("admits", {}).items()}
        st.fails = {k: int(v) for k, v in d.get("fails", {}).items()}
        st.assigned = dict(d.get("assigned", {}))
        st.hosts = dict(d.get("hosts", {}))
        st.host_cursor = {k: int(v)
                          for k, v in d.get("host_cursor", {}).items()}
        st.classes = dict(d.get("classes", {}))
        st.widths = {k: int(v) for k, v in d.get("widths", {}).items()}
        st.pools = {k: int(v) for k, v in d.get("pools", {}).items()}
        edges = d.get("planner_edges")
        st.planner_edges = [int(e) for e in edges] \
            if isinstance(edges, list) else None
        sketch = d.get("planner_sketch")
        st.planner_sketch = sketch if isinstance(sketch, dict) else None
        st.pool_obs = [int(p) for p in d.get("pool_obs", [])]
        st.coordinator_epoch = int(d.get("coordinator_epoch", 0))
        st.probation = {str(h) for h in d.get("probation", [])}
        st._enqueue_seq = {k: int(v)
                           for k, v in d.get("enqueue_seq", {}).items()}
        st._admit_seq = {k: int(v)
                         for k, v in d.get("admit_seq", {}).items()}
        return st


def _ckpt_path(path: str) -> str:
    return path + ".ckpt"


class JournalCorruption(RuntimeError):
    """A durably-written journal/WAL line (newline-terminated, so NOT a
    crash's torn tail — every complete line was flushed and fsynced
    before the writer proceeded) failed its frame CRC or did not parse:
    bit-rot, a short write that a later writer papered over, or a
    foreign writer.  Replay HALTS instead of silently diverging from
    the state the lost record carried; ``resilience.io.scan_wal`` finds
    the line and ``resilience.io.repair_wal`` quarantines it, so replay
    can go on from the surviving records."""


def _replay(path: str) -> JournalState:
    state = JournalState()
    has_ckpt = False
    ckpt = _ckpt_path(path)
    if os.path.exists(ckpt):
        try:
            with open(ckpt, "rb") as f:
                state = JournalState.from_dict(json.loads(f.read()
                                                          .decode("utf-8")))
            has_ckpt = True
        except (ValueError, UnicodeDecodeError, TypeError):
            state = JournalState()  # unreadable ckpt: journal alone decides
    if not os.path.exists(path):
        return state
    with open(path, "rb") as f:
        off = 0
        for i, raw in enumerate(f.readlines(), 1):
            if not raw.endswith(b"\n"):
                # a half-written TAIL (no newline — only the last line
                # can lack one) IS the expected crash artifact: its
                # transition never happened as far as recovery cares
                off += len(raw)
                continue
            status, rec = dio.parse_frame(raw)
            if status == "corrupt":
                raise JournalCorruption(
                    f"{path}:{i} (byte {off}): corrupt record — the line "
                    "is newline-terminated, so it was durably written "
                    "and then damaged; refusing to replay around it "
                    "(resilience.io.repair_wal quarantines it)")
            off += len(raw)
            if not isinstance(rec, dict) or dio.is_header(rec):
                continue
            if has_ckpt and status == "legacy" \
                    and not isinstance(rec.get("seq"), int):
                # legacy pre-seq line surviving a crash between the two
                # compaction renames: only pre-upgrade writers omit seq
                # and only post-upgrade writers produce checkpoints, so
                # the checkpoint already covers it — re-applying would
                # overwrite newer seq'd dispositions and double-count
                # the failure budget
                continue
            state.apply(rec)
    return state


def validate_journal_file(path: str) -> list[str]:
    """Structural validation of a journal/event WAL; returns
    human-readable error
    strings (empty = valid).  Every line but a torn TAIL must parse to a
    dict naming a known event with its required user/host/edges field,
    and ``seq`` numbers must be non-decreasing (compaction replays dedupe
    at-or-below the checkpoint seq, so equal neighbours are legal in a
    post-crash tail, but a regression means interleaved writers)."""
    errors: list[str] = []
    if not os.path.exists(path):
        return [f"{path}: missing"]
    with open(path, "rb") as f:
        raws = f.readlines()
    last_seq = None
    for i, raw in enumerate(raws, 1):
        if not raw.endswith(b"\n") and i == len(raws):
            continue  # torn tail: the expected crash artifact
        status, rec = dio.parse_frame(raw)
        if status == "corrupt":
            errors.append(f"{path}:{i}: corrupt record (frame CRC/parse "
                          "failure on a durably-written line)")
            continue
        if not isinstance(rec, dict):
            errors.append(f"{path}:{i}: non-dict record")
            continue
        if dio.is_header(rec):
            continue  # the {"wal": N} version header carries no event
        ev = rec.get("event")
        if ev in HOST_EVENTS:
            if not isinstance(rec.get("host"), str):
                errors.append(f"{path}:{i}: {ev!r} lacks host")
        elif ev in REMEDY_EVENTS:
            if not isinstance(rec.get("host"), str) \
                    or not isinstance(rec.get("action"), str):
                errors.append(f"{path}:{i}: {ev!r} lacks host/action")
        elif ev in PROBATION_EVENTS:
            if not isinstance(rec.get("host"), str) \
                    or not isinstance(rec.get("on"), bool):
                errors.append(f"{path}:{i}: {ev!r} lacks host/on")
        elif ev in PLANNER_EVENTS:
            if not isinstance(rec.get("edges"), list):
                errors.append(f"{path}:{i}: {ev!r} lacks edges")
        elif ev in EPOCH_EVENTS:
            if not isinstance(rec.get("epoch"), int):
                errors.append(f"{path}:{i}: {ev!r} lacks epoch")
        elif ev in EVENTS:
            if not isinstance(rec.get("user"), str):
                errors.append(f"{path}:{i}: {ev!r} lacks user")
        else:
            errors.append(f"{path}:{i}: unknown event {ev!r}")
            continue
        seq = rec.get("seq")
        if isinstance(seq, int):
            if last_seq is not None and seq < last_seq:
                errors.append(f"{path}:{i}: seq regressed "
                              f"{last_seq} -> {seq}")
            last_seq = seq
    return errors


try:
    import fcntl
except ImportError:  # non-POSIX: single-writer stays a documented contract
    fcntl = None


class SingleWriterViolation(RuntimeError):
    """Another process already holds this WAL's write lock.  The
    append-fsync files are single-writer BY DESIGN (see module
    docstring); a second writer would interleave seq numbers (records
    silently deduped away on replay) and lose appends across a
    compaction rename.  Typical trigger: ``--unpoison`` while a server
    is still running against the same users dir."""


class _AppendFsyncFile:
    """One JSONL record per call, durable before return (flush + fsync).
    The handle is opened lazily and kept open — the fsync per append is
    the durability point, reopening per line would only add syscalls.
    Every write/fsync routes through the :mod:`resilience.io` seam, so
    disk-fault drills hit the real byte boundaries.

    ``frame=True`` (the default) writes CRC32-framed records
    (``w1 <crc> <json>``, see :func:`resilience.io.frame_record`) and
    opens a fresh file with the ``{"wal": 2}`` version header; a
    pre-frame file is appended to in place (mixed files read fine —
    framing is per-line).  ``frame=False`` keeps the legacy plain-JSON
    format.

    Opening REPAIRS a torn tail first: a file whose last line lacks its
    newline (the process died mid-append) has the torn bytes moved into
    the ``<path>.quarantine`` sidecar and truncated off, so the file
    stays fully parseable and a later complete-but-corrupt line can
    only mean bit-rot — which replay refuses to skip
    (:class:`JournalCorruption`) instead of mistaking it for a crash
    artifact.

    The single-writer discipline is ENFORCED, not assumed: the first
    append takes an exclusive ``flock`` on a sibling ``<path>.lock``
    file (held for the writer's lifetime — a separate file so
    compaction's rename-over of the data file never drops it, and the
    kernel releases it on any process death, SIGKILL included).  A
    second writer gets :class:`SingleWriterViolation` instead of
    silently corrupting the seq stream."""

    def __init__(self, path: str | None, *, frame: bool = True,
                 member: str = "wal"):
        self.path = path
        self.frame = frame
        self.member = member
        self._f = None
        self._lockf = None

    def _open(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if self._lockf is None and fcntl is not None:
            lockf = open(self.path + ".lock", "ab")  # cetpu: noqa[raw-durable-io] zero-byte lock sibling: carries no data, never fsynced
            try:
                fcntl.flock(lockf.fileno(),
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                lockf.close()
                raise SingleWriterViolation(
                    f"{self.path}: another process holds this journal's "
                    "write lock (append-fsync WALs are single-writer); "
                    "is a server still running against this users dir?")
            self._lockf = lockf
        self._f = dio.open_append(self.path)
        if self._f.tell() > 0:
            with open(self.path, "rb") as r:
                data = r.read()
            keep = data.rfind(b"\n") + 1
            if keep < len(data):
                dio.quarantine_append(self.path, off=keep,
                                      raw=data[keep:], reason="torn tail")
                self._f.truncate(keep)
                self._f.flush()
                dio.fsync(self._f, path=self.path, member=self.member)
        elif self.frame:
            dio.write(self._f, dio.frame_header(), path=self.path,
                      member=self.member)
            self._f.flush()
            dio.fsync(self._f, path=self.path, member=self.member)

    def append(self, rec: dict) -> None:
        if self.path is None:
            return
        if self._f is None:
            self._open()
        line = dio.frame_record(rec) if self.frame \
            else (json.dumps(rec) + "\n").encode("utf-8")
        dio.write(self._f, line, path=self.path, member=self.member)
        self._f.flush()
        dio.fsync(self._f, path=self.path, member=self.member)

    def size(self) -> int:
        """Bytes written so far (0 before the first append this run)."""
        return self._f.tell() if self._f is not None else 0

    def rotate(self) -> None:
        """Close the DATA handle only (the caller is about to rename a
        fresh file over the path — compaction); the write lock stays
        held so no second writer can slip in mid-rotation."""
        if self._f is not None:
            self._f.close()
            self._f = None

    def close(self) -> None:
        self.rotate()
        if self._lockf is not None:
            self._lockf.close()  # releases the flock
            self._lockf = None


class JsonlTail:
    """Partial-line-safe follower of an append-only JSONL file written by
    another process (the fabric coordinator tailing a worker's event WAL,
    a worker tailing its assignment feed); JAX ``serve/journal.py:636``.

    :meth:`poll` returns ``(record, offset_after)`` for every complete line
    appended since the last poll; a line still missing its newline (the
    writer is mid-append, or died there) is left unconsumed.  Framed and
    legacy lines both parse (``resilience.io.parse_frame``) and the
    ``{"wal": N}`` header is consumed silently.  A complete line that
    fails its frame is bit-rot, not a crash: it is counted on
    :attr:`corrupt`, quarantined into the sidecar and skipped.  ``seek``
    resumes from a durable cursor (the coordinator journals each
    transcription's ``offset_after``)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self.offset = 0
        #: complete-but-corrupt lines skipped so far (the coordinator
        #: surfaces deltas as ``record_quarantined`` events)
        self.corrupt = 0

    def seek(self, offset: int) -> None:
        self.offset = max(int(offset), 0)
        if self._f is not None:
            self._f.seek(self.offset)

    def poll(self) -> list:
        # the lagging-tail gray seam: ``serve.feed.poll:stall=S`` holds the
        # reader here, ``slow=F`` stretches the read below
        faults.fire("serve.feed.poll", path=self.path)
        t0 = time.perf_counter()
        if self._f is None:
            if not os.path.exists(self.path):
                return []
            self._f = open(self.path, "rb")
            self._f.seek(self.offset)
        out = []
        while True:
            line = self._f.readline()
            if not line.endswith(b"\n"):
                # incomplete tail: rewind so the next poll re-reads it
                self._f.seek(self.offset)
                break
            self.offset += len(line)
            status, rec = dio.parse_frame(line)
            if status == "corrupt":
                self.corrupt += 1
                try:
                    dio.quarantine_append(
                        self.path, off=self.offset - len(line), raw=line,
                        reason="corrupt frame (reader skip)")
                except OSError:
                    pass  # the quarantine is audit only
                continue
            if isinstance(rec, dict) and not dio.is_header(rec):
                out.append((rec, self.offset))
        faults.slow_hold("serve.feed.poll", time.perf_counter() - t0)
        return out

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class AdmissionJournal:
    """The serve layer's WAL (see module docstring).

    Construction replays any existing checkpoint + journal into
    :attr:`state`; the server consults it for skip/ordering/attempt
    decisions, then appends new transitions through :meth:`append`.
    ``path=None`` journals nothing (unit tests, embedded drivers) while
    keeping the interface.  ``compact_bytes`` bounds the journal file:
    once an append pushes it past the bound, the state is checkpointed
    and the journal truncated in place (crash-safe, see :meth:`compact`).
    ``frame=False`` writes the legacy plain-JSON record format (no CRC
    frame; replay reads both).

    Opening SWEEPS any ``*.tmp`` sibling a mid-compaction death left
    behind (the rename never happened, so the tmp is garbage and the
    live files are authoritative); a compaction that hits a surfaced
    disk error (ENOSPC/EIO) cleans up its own tmp and simply retries at
    the next append over the threshold.
    """

    def __init__(self, path: str | None, *, compact_bytes: int | None = None,
                 frame: bool = True):
        if compact_bytes is not None and compact_bytes <= 0:
            # a zero/negative bound would compact on EVERY append — pass
            # None to disable compaction instead
            raise ValueError(f"compact_bytes must be > 0 (or None to "
                             f"disable compaction), got {compact_bytes}")
        self.path = path
        self.compact_bytes = compact_bytes
        if path:
            for stale in (path + ".tmp", _ckpt_path(path) + ".tmp"):
                try:
                    os.remove(stale)
                except OSError:
                    pass
        self.state = _replay(path) if path else JournalState()
        self._file = _AppendFsyncFile(path, frame=frame)
        self.compactions = 0
        #: appends happen on the serve-loop thread, but ``FleetServer.
        #: submit`` (producer threads) both appends (enqueue) and reads
        #: the replayed state (finished-skip) — one lock covers the file
        #: handle and the state dicts
        self._lock = threading.Lock()

    @property
    def recovered(self) -> bool:
        """True when the journal held prior state to recover from."""
        return bool(self.state.last)

    @property
    def ckpt_path(self) -> str | None:
        return _ckpt_path(self.path) if self.path else None

    def append(self, event: str, user=None, **fields) -> dict:
        """Durably record one transition; thread-safe.  Returns the
        record as written — its ``seq`` is the decision's durable
        identity (the control-plane trace lane keys span ids on it).
        The ``serve.journal.append`` fault point fires BEFORE the write:
        an injected kill there models dying with the transition
        un-journaled, which recovery must treat as 'never happened' (the
        enclosing step is re-done on restart).  Host-membership records
        (``lease`` / ``revoke``) carry a ``host=`` field instead of a
        user."""
        if event in HOST_EVENTS:
            if not isinstance(fields.get("host"), str):
                raise ValueError(f"journal event {event!r} needs host=")
        elif event in REMEDY_EVENTS:
            if not isinstance(fields.get("host"), str) \
                    or not isinstance(fields.get("action"), str):
                raise ValueError(
                    f"journal event {event!r} needs host= and action=")
        elif event in PROBATION_EVENTS:
            if not isinstance(fields.get("host"), str) \
                    or not isinstance(fields.get("on"), bool):
                raise ValueError(
                    f"journal event {event!r} needs host= and on=")
        elif event in PLANNER_EVENTS:
            if not isinstance(fields.get("edges"), list):
                raise ValueError(f"journal event {event!r} needs edges=")
        elif event in EPOCH_EVENTS:
            # user= is optional (a worker's epoch_fenced names the line's
            # user when it carried one; a claim names nobody)
            if not isinstance(fields.get("epoch"), int):
                raise ValueError(f"journal event {event!r} needs epoch=")
        elif event not in EVENTS:
            raise ValueError(f"unknown journal event {event!r}")
        elif user is None:
            raise ValueError(f"journal event {event!r} needs a user")
        with self._lock:
            faults.fire("serve.journal.append", event=event,
                        user=None if user is None else str(user))
            rec = {"event": event, "seq": self.state.seq + 1,
                   "t": round(time.time(), 3), **fields}  # cetpu: noqa[replay-wallclock] operator wall-stamp; replay keys on seq, never t
            if user is not None:
                rec["user"] = str(user)
            self._file.append(rec)
            self.state.apply(rec)
            if (self.compact_bytes
                    and self._file.size() > self.compact_bytes):
                try:
                    self._compact_locked()
                except OSError:
                    # a surfaced disk error (ENOSPC/EIO) mid-compaction:
                    # atomic_write already removed its tmp, the append
                    # itself IS durable, and the journal is merely still
                    # long — the next over-threshold append retries
                    pass
            return rec

    def is_finished(self, user) -> bool:
        """Thread-safe finished-check for producer-side skip decisions
        (reading ``state`` directly is only safe on the serve-loop
        thread)."""
        with self._lock:
            return self.state.last.get(str(user)) == "finish"

    def class_of(self, user) -> str | None:
        """The user's journaled priority class (thread-safe — ``submit``
        runs on producer threads): a re-submitted user keeps the class
        its first enqueue recorded, across restarts."""
        with self._lock:
            return self.state.classes.get(str(user))

    def width_of(self, user) -> int | None:
        """The user's journaled admission bucket width: a restart
        re-admits at exactly this pad even if the planner's edges have
        since moved (per-RUN pad pinning survives the process)."""
        with self._lock:
            return self.state.widths.get(str(user))

    def planner_state(self) -> tuple:
        """``(edges, sketch_dict, pool_obs)`` — the planner-restore
        snapshot: the last journaled epoch plus the enqueue pool sizes
        journaled after it."""
        with self._lock:
            st = self.state
            return (list(st.planner_edges) if st.planner_edges else None,
                    st.planner_sketch, list(st.pool_obs))

    def compact(self) -> None:
        """Checkpoint the replayed state and truncate the journal.

        Two atomic renames, each preceded by a ``fabric.compact`` fault
        point so drills can die in every window:

        1. ``<journal>.ckpt.tmp`` ← ``state.to_dict()`` (fsync), renamed
           over ``<journal>.ckpt``.
        2. An empty ``<journal>.tmp`` (fsync), renamed over the journal.

        A crash before (1) leaves the old ckpt + full journal (nothing
        lost); between (1) and (2), replay loads the new ckpt and skips
        every stale journal record by seq (idempotent); after (2) the
        journal is empty and the ckpt is the state.  Requires the
        single-writer discipline in the module docstring — no other
        process may hold an append handle to the journal being renamed
        over."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        if self.path is None:
            return
        faults.fire("fabric.compact", stage="checkpoint",
                    seq=self.state.seq)
        dio.atomic_write(_ckpt_path(self.path),
                         json.dumps(self.state.to_dict()).encode("utf-8"),
                         member="compact")
        faults.fire("fabric.compact", stage="truncate", seq=self.state.seq)
        self._file.rotate()  # keep the write lock across the rename
        # the truncated journal opens with the frame header right away,
        # so the rotated file self-describes even before its next append
        dio.atomic_write(self.path,
                         dio.frame_header() if self._file.frame else b"",
                         member="compact")
        self.compactions += 1

    def close(self) -> None:
        with self._lock:
            self._file.close()

    def __enter__(self) -> "AdmissionJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PoisonList:
    """Users that exhausted their failure budget, persisted append-fsync
    (``users/serve_poison.jsonl``): a poisoned user is skipped on every
    future submit instead of re-burning admission slots.  ``path=None``
    keeps the list in memory only (single-run semantics).

    The file is itself a tiny journal: :meth:`remove` (the ``--unpoison``
    operator command) appends an ``unpoison`` record instead of rewriting
    the file, so removals are as crash-durable and audit-traceable as the
    additions, and replay (including across a torn tail line) simply
    applies both record kinds in order."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._users: dict[str, dict] = {}
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                for raw in f:
                    if not raw.endswith(b"\n"):
                        continue  # half-written tail from a crash
                    rec = dio.parse_frame(raw)[1]
                    if not isinstance(rec, dict) or "user" not in rec:
                        continue
                    if rec.get("event") == "unpoison":
                        self._users.pop(str(rec["user"]), None)
                    else:
                        self._users[str(rec["user"])] = rec
        self._file = _AppendFsyncFile(path)
        # adds run on the serve-loop thread; membership checks also run
        # on producer threads (FleetServer.submit skip path)
        self._lock = threading.Lock()

    def add(self, user, *, error: str, attempts: int) -> None:
        rec = {"user": str(user), "error": error, "attempts": attempts,
               "t": round(time.time(), 3)}  # cetpu: noqa[replay-wallclock] operator wall-stamp; replay keys on membership, never t
        with self._lock:
            self._users[str(user)] = rec
            self._file.append(rec)

    def remove(self, user) -> bool:
        """Journal an ``unpoison`` record for ``user`` (the operator
        surface — never hand-edit the jsonl).  Returns False when the
        user was not on the list (nothing appended)."""
        with self._lock:
            if str(user) not in self._users:
                return False
            self._file.append({"event": "unpoison", "user": str(user),
                               "t": round(time.time(), 3)})  # cetpu: noqa[replay-wallclock] operator wall-stamp; replay keys on record order, never t
            del self._users[str(user)]
            return True

    def __contains__(self, user) -> bool:
        with self._lock:
            return str(user) in self._users

    def __len__(self) -> int:
        with self._lock:
            return len(self._users)

    def record(self, user) -> dict | None:
        with self._lock:
            return self._users.get(str(user))

    def close(self) -> None:
        with self._lock:
            self._file.close()
