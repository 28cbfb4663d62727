"""Corpus-delta fan-out to monitor services (docs/MONITORING.md
§Out-of-cadence re-evaluation).

The port's copy of ``swarm_tpu/monitor/notify.py``: the same logic,
records, keys and bytes.

``MatchEngine.refresh_corpus`` calls :func:`notify_corpus_delta` after
re-binding the delta-compiled corpus; every registered
:class:`~swarm_tpu_torch.monitor.service.MonitorService` responds with a
JOURNALED due-now touch (``put_monitor`` with ``next_fire_at = 0.0``)
so its next normal ``tick()`` fires one immediate diff epoch per
standing spec — under the same admission, shed and journal discipline
as a cadence fire. Nothing fires from inside the notification itself:
the touch only makes specs DUE, which is the whole crash contract —
kill-9 between notify and fire recovers a journaled spec that is
merely due, fired once, late, by the next server's first tick.

The registry holds weak references so a stopped or garbage-collected
service just disappears; notification never keeps a server alive, and
an engine refreshing its corpus in a process with no monitor service
(a worker, a bench) notifies nobody at zero cost.
"""

from __future__ import annotations

import threading
import traceback
import weakref
from typing import Optional

_LOCK = threading.Lock()  # guards: _LISTENERS
_LISTENERS: list = []  # weakref.ref entries to on_corpus_delta carriers


def register(listener) -> None:
    """Idempotently register ``listener`` — any object exposing
    ``on_corpus_delta(digest)`` — by weak reference."""
    with _LOCK:
        alive = [r for r in _LISTENERS if r() is not None]
        if not any(r() is listener for r in alive):
            alive.append(weakref.ref(listener))
        _LISTENERS[:] = alive


def unregister(listener) -> None:
    with _LOCK:
        _LISTENERS[:] = [
            r for r in _LISTENERS
            if r() is not None and r() is not listener
        ]


def notify_corpus_delta(digest: Optional[str] = None) -> int:
    """Fan a corpus delta out to every live listener; returns the
    number notified. Per-listener errors are printed and swallowed — a
    broken monitor service must degrade that service, never the
    engine's corpus refresh."""
    with _LOCK:
        targets = [r() for r in _LISTENERS]
        _LISTENERS[:] = [r for r in _LISTENERS if r() is not None]
    notified = 0
    for target in targets:
        if target is None:
            continue
        try:
            target.on_corpus_delta(digest)
            notified += 1
        except Exception:
            traceback.print_exc()
    return notified
