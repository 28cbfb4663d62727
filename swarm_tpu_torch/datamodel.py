"""Scan-id rule and job-status strings of the wire protocol.

The port's own copy of what the worker and the gateway need from
``swarm_tpu/datamodel.py`` (:data:`SCAN_ID_RE`, :class:`JobStatus`); the
strings are wire-identical.
"""

from __future__ import annotations

import re

# Scan ids flow into filesystem paths on server and worker alike.
SCAN_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")


class JobStatus:
    """Status taxonomy, wire-identical to the reference."""

    QUEUED = "queued"
    IN_PROGRESS = "in progress"
    STARTING = "starting"
    DOWNLOADING = "downloading"
    EXECUTING = "executing"
    UPLOADING = "uploading"
    COMPLETE = "complete"
    CMD_FAILED = "cmd failed"
    UPLOAD_FAILED_NOT_FOUND = "upload failed - file not found"
    UPLOAD_FAILED_CREDENTIALS = "upload failed - credentials"
    UPLOAD_FAILED_UNKNOWN = "upload failed - unknown"
    DEAD_LETTER = "dead letter"

    TERMINAL = frozenset(
        {
            COMPLETE,
            CMD_FAILED,
            UPLOAD_FAILED_NOT_FOUND,
            UPLOAD_FAILED_CREDENTIALS,
            UPLOAD_FAILED_UNKNOWN,
            DEAD_LETTER,
        }
    )
    # terminal and not complete: no output is coming (the result
    # stream skips such a chunk, ``gateway/streaming.py``)
    FAILED = frozenset(TERMINAL - {COMPLETE})
