"""The port's admission journal and WAL against the JAX package's, on the
CPU.

Frames are byte-equal (the same JSON, the same CRC); a journal the JAX
package wrote, compaction included, replays in the port to an equal
``JournalState.to_dict()`` and the other way round; ``recovery_order``,
the poison list (read across the packages), a torn tail (quarantined on
open, never replayed), a corrupt durable line (replay halts), the scan and
repair of a WAL, the single-writer lock, and the ``serve.journal.append``
and ``fabric.compact`` fault points (a kill before the write leaves no
record; a kill between the compaction's two renames replays
idempotently).  Tolerance: none, every comparison is exact."""

import json
import os

import pytest
import torch

from consensus_entropy_tpu.resilience import io as jax_io
from consensus_entropy_tpu.serve import journal as jax_journal
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience import io as dio
from consensus_entropy_tpu_torch.resilience.faults import FaultRule
from consensus_entropy_tpu_torch.serve import journal

torch.set_num_threads(1)

RECORDS = [{"wal": 2}, {"event": "enqueue", "seq": 1, "t": 12.5,
                        "cls": "interactive", "pool": 30, "user": "u0"},
           {"event": "planner", "seq": 9, "edges": [16, 32],
            "sketch": {"n": 3, "samples": [1.5, 2.0, 30.0],
                       "buckets": {"1": 2, "19": 1}, "min": 1.5}},
           {"event": "fail", "seq": 4, "user": "ü", "error": "Err('x')",
            "final": True}, [1, 2], "s", 3.25, None]


def test_frames_are_byte_equal_with_jax():
    for rec in RECORDS:
        line = dio.frame_record(rec)
        assert line == jax_io.frame_record(rec)
        assert dio.parse_frame(line) == jax_io.parse_frame(line)
        assert dio.parse_frame(line) == ("ok", rec)
    assert dio.frame_header() == jax_io.frame_header()
    assert dio.is_header({"wal": 2}) and not dio.is_header(
        {"wal": 2, "event": "x"})
    broken = [b'w1 0000zzzz {"a": 1}\n', b"w1 00000000\n", b"{nope\n",
              b'{"event": "admit", "user": "u1"}\r\n',
              dio.frame_record({"a": 1}).replace(b'"a"', b'"b"')]
    for line in broken:
        assert dio.parse_frame(line) == jax_io.parse_frame(line)
    assert dio.parse_frame(broken[3])[0] == "legacy"
    assert dio.parse_frame(broken[4]) == ("corrupt", None)


def _script(mod, path, *, compact_at=None):
    """The same transitions through an ``AdmissionJournal`` of ``mod``;
    compacts after record ``compact_at``."""
    j = mod.AdmissionJournal(path)
    steps = [("enqueue", "u0", {"cls": "batch", "pool": 30}),
             ("enqueue", "u1", {"cls": "interactive", "pool": 60}),
             ("enqueue", "u2", {"cls": "batch", "pool": 12}),
             ("planner", None, {"edges": [16, 32, 64],
                                "sketch": {"n": 3, "samples": [30, 60, 12]}}),
             ("admit", "u1", {"width": 64}),
             ("admit", "u0", {"width": 32}),
             ("fail", "u1", {"error": "boom", "attempt": 1}),
             ("enqueue", "u3", {"cls": "batch", "pool": 200}),
             ("finish", "u0", {}),
             ("admit", "u1", {"width": 64}),
             ("poison", "u2", {"error": "bad", "attempts": 3}),
             ("assign", "u3", {"host": "h1"}),
             ("lease", None, {"host": "h1"}),
             ("epoch", None, {"epoch": 2}),
             ("probation", None, {"host": "h1", "on": True}),
             ("remedy", None, {"host": "h1", "action": "rebalance"}),
             ("unpoison", "u2", {})]
    for i, (event, user, fields) in enumerate(steps):
        j.append(event, user, **fields)
        if compact_at is not None and i == compact_at:
            j.compact()
    j.close()
    return j


@pytest.mark.parametrize("compact_at", [None, 6])
def test_journals_replay_across_the_packages(tmp_path, compact_at):
    for writer, tag in ((jax_journal, "jax"), (journal, "port")):
        path = str(tmp_path / f"{tag}.jsonl")
        _script(writer, path, compact_at=compact_at)
        ours = journal._replay(path)
        theirs = jax_journal._replay(path)
        assert ours.to_dict() == theirs.to_dict(), tag
        assert ours.seq == 17
        assert journal.validate_journal_file(path) == \
            jax_journal.validate_journal_file(path) == []
        if compact_at is not None:
            assert os.path.exists(path + ".ckpt")
        # a reopened journal continues the seq and the replayed state
        j = journal.AdmissionJournal(path)
        assert j.recovered and j.state.to_dict() == theirs.to_dict()
        assert j.width_of("u1") == 64 and j.class_of("u1") == "interactive"
        assert j.is_finished("u0") and not j.is_finished("u1")
        assert j.append("finish", "u1")["seq"] == 18
        j.close()
        assert jax_journal._replay(path).to_dict() == \
            journal._replay(path).to_dict()
    st = journal._replay(str(tmp_path / "port.jsonl"))
    assert st.finished == {"u0", "u1"} and st.classes["u3"] == "batch"
    assert st.planner_edges == [16, 32, 64] and st.pool_obs == [200]


def test_recovery_order(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal.AdmissionJournal(path)
    for uid in ("a", "b", "c", "d", "e"):
        j.append("enqueue", uid)
    j.append("admit", "c")
    j.append("admit", "a")
    j.append("finish", "b")
    j.append("poison", "e", error="x", attempts=3)
    j.close()
    st = journal._replay(path)
    order = st.recovery_order(["a", "b", "c", "d", "e", "f"])
    assert order == jax_journal._replay(path).recovery_order(
        ["a", "b", "c", "d", "e", "f"])
    assert order == ["c", "a", "d", "f", "b"]
    assert st.in_flight == ["c", "a"] and st.queued == ["d"]


def test_poison_list_reads_across_the_packages(tmp_path):
    path = str(tmp_path / "serve_poison.jsonl")
    theirs = jax_journal.PoisonList(path)
    theirs.add("u1", error="E1", attempts=3)
    theirs.add("u2", error="E2", attempts=3)
    assert theirs.remove("u1")
    theirs.close()
    ours = journal.PoisonList(path)
    assert "u2" in ours and "u1" not in ours and len(ours) == 1
    assert ours.record("u2")["error"] == "E2"
    ours.add("u3", error="E3", attempts=2)
    assert not ours.remove("zz")
    ours.close()
    with open(path, "ab") as f:
        f.write(b'w1 0000')  # a torn tail from a crash
    again = jax_journal.PoisonList(path)
    assert "u3" in again and "u2" in again and len(again) == 2
    again.close()
    assert len(journal.PoisonList(None)) == 0


def test_torn_tail_is_quarantined_and_never_replayed(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal.AdmissionJournal(path)
    j.append("enqueue", "u0")
    j.close()
    torn = dio.frame_record({"event": "admit", "seq": 2, "user": "u0"})
    with open(path, "ab") as f:
        f.write(torn[: len(torn) // 2])
    assert dio.scan_wal(path) == jax_io.scan_wal(path)
    assert dio.scan_wal(path)["torn_tail"]
    st = journal._replay(path)
    assert st.last == {"u0": "enqueue"}
    j = journal.AdmissionJournal(path)
    j.append("admit", "u0", width=8)  # opening repaired the tail first
    j.close()
    with open(dio.quarantine_path(path)) as f:
        (q,) = [json.loads(line) for line in f]
    assert q["reason"] == "torn tail"
    assert journal._replay(path).last == {"u0": "admit"}
    assert not dio.scan_wal(path)["torn_tail"]


def test_corrupt_durable_line_halts_replay_until_repaired(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal.AdmissionJournal(path)
    for uid in ("u0", "u1"):
        j.append("enqueue", uid)
    j.close()
    with open(path, "rb") as f:
        lines = f.readlines()
    lines[1] = lines[1].replace(b'"u0"', b'"uX"')  # bit-rot, CRC breaks
    with open(path, "wb") as f:
        f.writelines(lines)
    with pytest.raises(journal.JournalCorruption, match=":2"):
        journal._replay(path)
    with pytest.raises(jax_journal.JournalCorruption):
        jax_journal._replay(path)
    assert journal.validate_journal_file(path) == \
        jax_journal.validate_journal_file(path)
    assert dio.scan_wal(path)["corrupt"] == jax_io.scan_wal(path)["corrupt"]
    assert dio.repair_wal(path)["dropped"] == 1
    assert journal._replay(path).last == {"u1": "enqueue"}


def test_single_writer_lock(tmp_path):
    path = str(tmp_path / "j.jsonl")
    a = journal.AdmissionJournal(path)
    a.append("enqueue", "u0")
    b = journal.AdmissionJournal(path)
    with pytest.raises(journal.SingleWriterViolation):
        b.append("enqueue", "u1")
    with pytest.raises(dio.WalLocked):
        dio.repair_wal(path)
    a.close()
    b.append("enqueue", "u1")  # the lock is free again
    b.close()
    with pytest.raises(ValueError, match="compact_bytes"):
        journal.AdmissionJournal(path, compact_bytes=0)
    with pytest.raises(ValueError, match="needs a user"):
        journal.AdmissionJournal(None).append("admit")
    with pytest.raises(ValueError, match="unknown"):
        journal.AdmissionJournal(None).append("nope", "u0")


def test_journal_append_fault_point(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal.AdmissionJournal(path)
    j.append("enqueue", "u0")
    with faults.inject(FaultRule("serve.journal.append", "kill", at=1)) \
            as inj:
        with pytest.raises(faults.InjectedKill):
            j.append("admit", "u0", width=8)
    assert inj.fired[0]["event"] == "admit"
    j.close()
    # the killed transition never happened: u0 is still queued
    assert journal._replay(path).last == {"u0": "enqueue"}
    assert jax_journal._replay(path).last == {"u0": "enqueue"}


@pytest.mark.parametrize("stage_hit", [1, 2])
def test_kill_inside_compaction_replays_idempotently(tmp_path, stage_hit):
    """A kill at the checkpoint stage leaves the old files; one at the
    truncate stage leaves the new checkpoint beside the stale journal,
    whose records at or below its seq are skipped."""
    path = str(tmp_path / "j.jsonl")
    j = journal.AdmissionJournal(path, compact_bytes=300)
    j.append("enqueue", "u0")
    before = journal._replay(path).to_dict()
    with faults.inject(FaultRule("fabric.compact", "kill", at=stage_hit)):
        with pytest.raises(faults.InjectedKill):
            for uid in ("u1", "u2", "u3", "u4"):
                j.append("enqueue", uid)
    j.close()
    st = journal._replay(path)
    assert st.to_dict() == jax_journal._replay(path).to_dict()
    assert st.queued[0] == "u0" and st.seq > before["seq"]
    assert os.path.exists(path + ".ckpt") == (stage_hit == 2)
    j = journal.AdmissionJournal(path, compact_bytes=300)
    for uid in ("u5", "u6", "u7"):
        j.append("enqueue", uid)
    assert j.compactions >= 1
    j.close()
    st = journal._replay(path)
    assert st.to_dict() == jax_journal._replay(path).to_dict()
    assert st.queued[-1] == "u7" and len(set(st.queued)) == len(st.queued)
    assert not os.path.exists(path + ".tmp")
