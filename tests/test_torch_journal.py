"""The port's queue journal (``swarm_tpu_torch/server/journal.py``)
against the JAX package's (``swarm_tpu/server/journal.py``), on the CPU.

Each case runs once through each package's ``QueueJournal`` on a blob
store of its own; then

- what the case observed (snapshots, records, sequence numbers,
  generations, error texts) is equal;
- the two stores hold the same keys with the same bytes;
- the ``swarm_journal_*`` samples moved alike (counter deltas, the
  segment gauge's value);
- each package's journal replays the store the other wrote, to what
  the writer's own journal replays.

The cases are the journal-only cases of ``tests/test_journal.py``, the
three fault points (``journal.append``, ``journal.replay``,
``journal.compact``) and seeded sequences of appends, checkpoints,
generation bumps and writer restarts over ``Job`` wires. The cases that
go through the queue service wait for the port's queue.

Everything compared is bytes, strings or numbers: tolerance 0.
"""

import inspect
import json
import re
from types import SimpleNamespace

import numpy as np
import pytest

import swarm_tpu.datamodel as j_dm
import swarm_tpu.resilience.faults as j_faults
import swarm_tpu.server.journal as j_journal
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.datamodel as t_dm
import swarm_tpu_torch.resilience.faults as t_faults
import swarm_tpu_torch.server.journal as t_journal
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.metrics as t_metrics

PKG = {
    "jax": SimpleNamespace(journal=j_journal, stores=j_stores, faults=j_faults,
                           metrics=j_metrics, dm=j_dm),
    "torch": SimpleNamespace(journal=t_journal, stores=t_stores, faults=t_faults,
                             metrics=t_metrics, dm=t_dm),
}
SIDES = ("jax", "torch")


def test_copy_matches_its_original():
    """Every function and class of the journal is the reference's source
    with the package name changed."""
    def own(module):
        return {name: obj for name, obj in vars(module).items()
                if (inspect.isfunction(obj) or inspect.isclass(obj))
                and obj.__module__ == module.__name__}

    mine, theirs = own(t_journal), own(j_journal)
    assert set(theirs) == set(mine) == {"JournalError", "QueueJournal"}
    for name, obj in theirs.items():
        want = re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))
        assert inspect.getsource(mine[name]) == want, name
    assert t_journal._SEQ_DIGITS == j_journal._SEQ_DIGITS


# ---------------------------------------------------------------------------
# the cases: each takes a package and an empty blob store, returns what it saw


def case_append_replay_roundtrip_in_order(p, blobs):
    j = p.journal.QueueJournal(blobs)
    j.append({"op": "tenant", "tenant": "a"})
    j.append_many([{"op": "job", "job": {"job_id": f"s_1_{i}"}} for i in range(3)])
    snapshot, records = j.replay()
    assert snapshot is None
    got = list(records)
    assert [r.get("tenant") or r["job"]["job_id"] for r in got] == [
        "a", "s_1_0", "s_1_1", "s_1_2"]
    return [snapshot, got, j.segments_pending, j.has_state()]


def case_checkpoint_prunes_segments_and_seeds_replay(p, blobs):
    j = p.journal.QueueJournal(blobs)
    j.append({"op": "job", "job": {"job_id": "s_1_0"}})
    seq = j.checkpoint({"jobs": {"s_1_0": {"job_id": "s_1_0"}}})
    assert blobs.list("_journal/seg/") == []
    j.append({"op": "job", "job": {"job_id": "s_1_1"}})
    snapshot, records = j.replay()
    got = list(records)
    assert set(snapshot["jobs"]) == {"s_1_0"}
    assert [r["job"]["job_id"] for r in got] == ["s_1_1"]
    return [seq, snapshot, got, j.segments_pending]


def case_crashed_compaction_leftover_segments_are_skipped(p, blobs):
    j = p.journal.QueueJournal(blobs)
    j.append({"op": "job", "job": {"job_id": "s_1_0", "status": "queued"}})
    j.checkpoint({"jobs": {"s_1_0": {"job_id": "s_1_0", "status": "complete"}}})
    blobs.put("_journal/seg/000000000001.jsonl", json.dumps(
        {"op": "job", "job": {"job_id": "s_1_0", "status": "queued"}}).encode() + b"\n")
    snapshot, records = j.replay()
    got = list(records)
    assert got == [] and snapshot["jobs"]["s_1_0"]["status"] == "complete"
    return [snapshot, got]


def case_sequence_resumes_after_restart(p, blobs):
    j1 = p.journal.QueueJournal(blobs)
    j1.append({"op": "job", "job": {"job_id": "a"}})
    j2 = p.journal.QueueJournal(blobs)  # a restarted writer
    j2.append({"op": "job", "job": {"job_id": "b"}})
    _snap, records = p.journal.QueueJournal(blobs).replay()
    got = [r["job"]["job_id"] for r in records]
    assert got == ["a", "b"]
    return [got, j2.segments_pending]


def case_corrupt_records_skipped_and_counted(p, blobs):
    j = p.journal.QueueJournal(blobs)
    j.append({"op": "job", "job": {"job_id": "ok_1"}})
    blobs.put("_journal/seg/000000000999.jsonl", b"{not json\n")
    blobs.put("_journal/seg/000000001000.jsonl", b"[1, 2]\n\n")
    corrupt = p.metrics.REGISTRY.get("swarm_journal_corrupt_records_total").labels()
    before = corrupt.value
    _snap, records = p.journal.QueueJournal(blobs).replay()
    got = [r["job"]["job_id"] for r in records]
    assert got == ["ok_1"] and corrupt.value == before + 2
    # a damaged snapshot falls back to the segments that survive
    blobs.put("_journal/snap/000000000500.json", b"{damaged")
    snap, records = p.journal.QueueJournal(blobs).replay()
    return [got, snap, [r["job"]["job_id"] for r in records]]


def case_generation_monotonic_and_survives_clear(p, blobs):
    j = p.journal.QueueJournal(blobs)
    out = [j.generation(), j.bump_generation(), j.bump_generation()]
    assert out == [0, 1, 2]
    j.append({"op": "job", "job": {"job_id": "x"}})
    j.checkpoint({"jobs": {}})
    j.append({"op": "job", "job": {"job_id": "y"}})
    j.clear()
    assert not j.has_state()
    out.append(p.journal.QueueJournal(blobs).generation())
    assert out[-1] == 2
    blobs.put("_journal/generation", b"not a number")
    return out + [j.generation(), j.segments_pending]


def case_replay_fault_fails_loudly(p, blobs):
    """``journal.replay`` firing raises the plan's fault out of replay
    (a boot fails loudly); with the cause cleared the next replay
    recovers everything."""
    j = p.journal.QueueJournal(blobs)
    j.append({"op": "job", "job": {"job_id": "rf_1_0"}})
    p.faults.install_plan("journal.replay:1")
    try:
        with pytest.raises(p.faults.FaultInjected) as e:
            p.journal.QueueJournal(blobs).replay()
    finally:
        p.faults.clear_plan()
    _snap, records = p.journal.QueueJournal(blobs).replay()
    return [str(e.value), [r["job"]["job_id"] for r in records]]


def case_append_fault_journals_nothing(p, blobs):
    """``journal.append`` firing: a ``JournalError`` naming the cause,
    no segment written, and the sequence number it took is not reused."""
    j = p.journal.QueueJournal(blobs)
    j.append({"op": "job", "job": {"job_id": "a"}})
    p.faults.install_plan("journal.append/job:1")
    try:
        with pytest.raises(p.journal.JournalError) as e:
            j.append({"op": "job", "job": {"job_id": "lost"}})
        j.append({"op": "tenant", "tenant": "t"})  # another detail: no fault
    finally:
        p.faults.clear_plan()
    j.append_many([])
    j.append({"op": "job", "job": {"job_id": "b"}})
    _snap, records = j.replay()
    return [str(e.value), isinstance(e.value.__cause__, p.faults.FaultInjected),
            list(records), j.segments_pending]


def case_compact_fault_keeps_segments(p, blobs):
    """``journal.compact`` firing: a ``JournalError``, no snapshot, every
    segment kept; the next checkpoint folds them."""
    j = p.journal.QueueJournal(blobs, compact_segments=1)
    assert j.compact_segments == 2
    for i in range(3):
        j.append({"op": "job", "job": {"job_id": f"c_{i}"}})
    p.faults.install_plan("journal.compact:1")
    try:
        with pytest.raises(p.journal.JournalError) as e:
            j.checkpoint({"jobs": {"c_0": {}}})
    finally:
        p.faults.clear_plan()
    kept = [blobs.list("_journal/seg/"), blobs.list("_journal/snap/"), j.segments_pending]
    seq = j.checkpoint({"jobs": {"c_0": {}, "c_1": {}, "c_2": {}}})
    snap, records = j.replay()
    return [str(e.value), kept, seq, snap, list(records)]


def _job_wire(dm, rng, i: int) -> dict:
    job = dm.Job.create(f"scan{int(rng.integers(3))}_1700000000", i, "fingerprint",
                        tenant=[None, "acme"][int(rng.integers(2))])
    job.status = sorted(dm.JobStatus.ALL)[int(rng.integers(len(dm.JobStatus.ALL)))]
    job.attempts = int(rng.integers(0, 3))
    if rng.random() < 0.5:
        job.lease_expires_at = 1700000000.0 + float(rng.integers(0, 1000)) / 4
    return job.to_wire()


def _seeded_case(seed: int):
    def case(p, blobs):
        """Appends, batched appends, checkpoints of the folded state,
        generation bumps and writer restarts, drawn from ``seed``."""
        dm = p.dm
        rng = np.random.default_rng(seed)
        j = p.journal.QueueJournal(blobs, compact_segments=int(rng.integers(2, 6)))
        state: dict = {"jobs": {}, "tenants": []}
        seen = []
        for step in range(60):
            r = rng.random()
            if r < 0.45:
                rec = {"op": "job", "job": _job_wire(dm, rng, step)}
                j.append(rec)
                state["jobs"][rec["job"]["job_id"]] = rec["job"]
            elif r < 0.6:
                recs = [{"op": "job", "job": _job_wire(dm, rng, step * 100 + k)}
                        for k in range(int(rng.integers(1, 4)))]
                j.append_many(recs)
                for rec in recs:
                    state["jobs"][rec["job"]["job_id"]] = rec["job"]
            elif r < 0.7:
                t = f"tenant{int(rng.integers(4))}"
                j.append({"op": "tenant", "tenant": t})
                state["tenants"].append(t)
            elif r < 0.8 or j.segments_pending >= j.compact_segments:
                seen.append(("checkpoint", j.checkpoint(json.loads(json.dumps(state)))))
            elif r < 0.9:
                seen.append(("generation", j.bump_generation()))
            else:
                j = p.journal.QueueJournal(blobs, compact_segments=j.compact_segments)
                seen.append(("restart", j.segments_pending))
        snap, records = p.journal.QueueJournal(blobs).replay()
        folded = dict((snap or {}).get("jobs") or {})
        for rec in records:
            if rec.get("op") == "job":
                folded[rec["job"]["job_id"]] = rec["job"]
        assert folded == state["jobs"]
        return [seen, snap, j.segments_pending, j.generation()]

    case.__name__ = f"case_seeded_{seed}"
    return case


CASES = [case_append_replay_roundtrip_in_order,
         case_checkpoint_prunes_segments_and_seeds_replay,
         case_crashed_compaction_leftover_segments_are_skipped,
         case_sequence_resumes_after_restart, case_corrupt_records_skipped_and_counted,
         case_generation_monotonic_and_survives_clear, case_replay_fault_fails_loudly,
         case_append_fault_journals_nothing, case_compact_fault_keeps_segments,
         *(_seeded_case(s) for s in range(4))]


def _journal_samples(metrics) -> dict:
    return {(name, tuple(sorted(labels.items()))): value
            for name, labels, value in metrics.parse_exposition(metrics.REGISTRY.render())
            if name.startswith("swarm_journal_")}


def _moved(before: dict, after: dict) -> dict:
    """The segment gauge's value and every counter sample that moved
    (a registry may hold label values that earlier tests of the process
    created)."""
    out = {}
    for key, value in after.items():
        if key[0] == "swarm_journal_segments":
            out[key] = value
        elif value != before.get(key, 0.0):
            out[key] = value - before.get(key, 0.0)
    return out


def _contents(blobs) -> dict:
    return {key: blobs.get(key) for key in blobs.list("")}


def _replayed(journal) -> tuple:
    snapshot, records = journal.replay()
    return snapshot, list(records), journal.generation(), journal.has_state()


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_journal_case_equals_jax(case):
    seen, stores, moved = {}, {}, {}
    for side in SIDES:
        p = PKG[side]
        blobs = p.stores.MemoryBlobStore()
        before = _journal_samples(p.metrics)
        seen[side] = case(p, blobs)
        moved[side] = _moved(before, _journal_samples(p.metrics))
        stores[side] = blobs
    assert seen["torch"] == seen["jax"]
    assert _contents(stores["torch"]) == _contents(stores["jax"])
    assert moved["torch"] == moved["jax"] and moved["torch"]
    # each package's journal replays the other's store as its writer does
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        got = _replayed(PKG[reader].journal.QueueJournal(stores[writer]))
        assert got == _replayed(PKG[writer].journal.QueueJournal(stores[writer]))
