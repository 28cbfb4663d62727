"""Server-push result streaming: ``GET /stream/<scan_id>`` (docs/GATEWAY.md).

The port's copy of ``swarm_tpu/gateway/streaming.py``: ``stream_scan``
is the reference's, line for line (``tests/test_torch_gateway.py``), and
takes any queue object with ``output_chunk``, ``chunk_status``,
``scan_chunk_states`` and ``stored_output_chunks``.

The reference client's only way to watch a running scan is polling
``cat`` (merged ``/raw``) — O(scan size) per poll and no ordering
story. The gateway serves incremental results instead: one NDJSON
record per output chunk, pushed over a chunked HTTP/1.1 response as
chunks land in the (idempotent) chunk store, IN INDEX ORDER so the
client's resume cursor is simply "last delivered chunk + 1".

Wire format, one JSON object per line:

- ``{"chunk": i, "data": "<chunk text>"}`` — chunk ``i``'s output
- ``{"chunk": i, "event": "skipped", "status": "..."}`` — chunk ``i``
  reached a terminal failure (dead letter) and will never produce
  output; the cursor advances past it
- ``{"event": "end", "next_chunk": n}`` — every chunk up to the scan's
  known extent has been delivered or skipped; the stream is complete
- ``{"event": "timeout", "next_chunk": n}`` — nothing new for the idle
  window; the server closes the stream (bounded handler lifetime) and
  the client reconnects with ``?from=n``

Resume across a server RESTART rides the idempotent chunk store:
output chunks are durable blobs, so a fresh server (empty in-memory job
table) still serves ``?from=n`` for every stored chunk and ends the
stream when the store holds nothing at or past the cursor.
"""

from __future__ import annotations

import json
import time
from typing import Iterator

from swarm_tpu_torch.datamodel import JobStatus
from swarm_tpu_torch.telemetry.gateway_export import GATEWAY_STREAM_BYTES


def _record(payload: dict) -> bytes:
    return json.dumps(payload, separators=(",", ":")).encode() + b"\n"


def stream_scan(
    queue,
    scan_id: str,
    from_chunk: int = 0,
    poll_s: float = 0.05,
    idle_timeout_s: float = 300.0,
    clock=time.monotonic,
    sleep=time.sleep,
) -> Iterator[bytes]:
    """Yield NDJSON records for ``scan_id`` starting at ``from_chunk``.

    Ordering contract: records for chunk ``i`` are only emitted after
    every chunk ``< i`` was delivered or skipped, so a consumer's ack
    cursor is a single integer. The generator polls the queue service
    (never holds its locks) and bounds its own lifetime with the idle
    timeout."""
    next_index = int(from_chunk)
    last_progress = clock()
    #: consecutive polls the cursor's index had NO job record while
    #: later records existed — a gap is only skipped once it persists
    #: (an in-flight multi-chunk submission writes records in order,
    #: so a transient snapshot race must not drop a chunk forever)
    gap_polls = 0
    while True:
        content = queue.output_chunk(scan_id, next_index)
        if content is not None:
            line = _record({"chunk": next_index, "data": content})
            GATEWAY_STREAM_BYTES.inc(len(line))
            yield line
            next_index += 1
            last_progress = clock()
            gap_polls = 0
            continue

        # hot path: ONE hget for the chunk the cursor is waiting on —
        # a live record that isn't terminal-failed just means "not
        # ready yet", no reason to render the whole job table
        status = queue.chunk_status(scan_id, next_index)
        if status is not None and status not in JobStatus.FAILED:
            if clock() - last_progress >= idle_timeout_s:
                yield _record({"event": "timeout", "next_chunk": next_index})
                return
            sleep(poll_s)
            continue

        states = queue.scan_chunk_states(scan_id)
        if not states:
            # no live job records (e.g. a restarted server streaming a
            # historical scan from the durable chunk store): serve
            # what the store holds, end when nothing remains at or
            # past the cursor
            stored = queue.stored_output_chunks(scan_id)
            ahead = sorted(i for i in stored if i >= next_index)
            if not ahead:
                yield _record({"event": "end", "next_chunk": next_index})
                return
            if ahead[0] > next_index:
                # a gap with no job record will never fill — skip it
                yield _record(
                    {"chunk": next_index, "event": "skipped", "status": "missing"}
                )
                next_index += 1
                last_progress = clock()
                continue
            # ahead[0] == next_index: the blob landed between the two
            # reads — loop back and serve it
            continue

        total = max(states) + 1
        status = states.get(next_index)
        if status is None and next_index < total:
            # a gap inside the known chunk-index space (explicit
            # chunk_index submissions can be sparse or out of order):
            # give it a few polls to appear — a submission racing this
            # snapshot writes records in index order — then skip it,
            # or the stream would idle to timeout forever with
            # delivered chunks waiting past the gap. An index skipped
            # here and submitted LATER is served by /raw, not the
            # stream (the in-order contract is what makes the resume
            # cursor a single integer).
            gap_polls += 1
            if gap_polls < 4:
                sleep(poll_s)
                continue
            yield _record(
                {"chunk": next_index, "event": "skipped", "status": "missing"}
            )
            next_index += 1
            last_progress = clock()
            gap_polls = 0
            continue
        if status in JobStatus.FAILED:
            # terminal failure (dead letter / cmd failed): no output is
            # coming for this chunk — advance the cursor past it
            yield _record(
                {"chunk": next_index, "event": "skipped", "status": status}
            )
            next_index += 1
            last_progress = clock()
            continue
        if next_index >= total and all(
            s in JobStatus.TERMINAL for s in states.values()
        ):
            yield _record({"event": "end", "next_chunk": next_index})
            return

        if clock() - last_progress >= idle_timeout_s:
            yield _record({"event": "timeout", "next_chunk": next_index})
            return
        sleep(poll_s)
