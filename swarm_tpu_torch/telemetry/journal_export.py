"""Always-registered ``swarm_journal_*`` / recovery metric families
(docs/DURABILITY.md).

The port's copy of ``swarm_tpu/telemetry/journal_export.py``: the
same names, kinds, help strings, labels and pre-seeded label values.

The durable queue journal (``swarm_tpu_torch/server/journal.py``) is the
control plane's write-ahead log: every queue mutation appends a record
before the state store is touched, and a restarting server replays the
log to recover its job table. These families register at telemetry
import time — not on first journal construction — so EVERY process's
``/metrics`` carries them with rendered samples
(``tools/check_metrics.py`` requires them on a server that has never
journaled a record). Label combinations are pre-seeded for the same
reason.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: journal records appended, by record kind (``job`` = a queue
#: mutation's full job record, ``tenant`` = tenant-registry add,
#: ``checkpoint`` = a compaction snapshot)
JOURNAL_APPENDS = REGISTRY.counter(
    "swarm_journal_appends_total",
    "Write-ahead journal records appended, by record kind",
    ("op",),
)
for _op in ("job", "tenant", "checkpoint"):
    JOURNAL_APPENDS.labels(op=_op)
del _op

#: records applied during boot-time recovery (snapshot entries + WAL
#: segment records)
JOURNAL_REPLAYED = REGISTRY.counter(
    "swarm_journal_replayed_total",
    "Journal records applied during boot-time recovery",
)

#: snapshot-compaction cycles (segments folded into a snapshot blob)
JOURNAL_COMPACTIONS = REGISTRY.counter(
    "swarm_journal_compactions_total",
    "Journal checkpoint compactions (segments folded into a snapshot)",
)

#: live WAL segment count (set at append/checkpoint/recovery time)
JOURNAL_SEGMENTS = REGISTRY.gauge(
    "swarm_journal_segments",
    "Write-ahead journal segments not yet folded into a snapshot",
)

#: records skipped during replay because they failed to parse — always
#: zero unless the journal was externally damaged (operator runbook:
#: docs/DURABILITY.md)
JOURNAL_CORRUPT = REGISTRY.counter(
    "swarm_journal_corrupt_records_total",
    "Journal records skipped at recovery because they failed to parse",
)

#: jobs materialized by recovery, by what recovery decided about them
#: (``queued`` = back on a dispatch list, ``leased`` = still leased
#: under the re-lease grace window, ``terminal`` = already finished,
#: ``completed_from_store`` = non-terminal in the journal but the
#: output blob exists, so the chunk store proves completion)
QUEUE_RECOVERED = REGISTRY.counter(
    "swarm_queue_recovered_jobs_total",
    "Jobs materialized by journal recovery, by recovery outcome",
    ("outcome",),
)
for _o in ("queued", "leased", "terminal", "completed_from_store"):
    QUEUE_RECOVERED.labels(outcome=_o)
del _o

#: monotonic server generation (bumped once per journal-enabled boot;
#: 0 = journal disabled). Workers read it from the X-Swarm-Generation
#: header to detect control-plane restarts.
QUEUE_GENERATION = REGISTRY.gauge(
    "swarm_queue_generation",
    "Monotonic control-plane generation (bumped per journal-enabled boot)",
)
