"""MatchEngine: the exact template-fingerprint engine of the port.

The port of ``swarm_tpu/ops/engine.py``'s direct path (one device, no
scheduler): template corpus → CompiledDB (once) → responses in batches
→ :class:`~swarm_tpu_torch.ops.match.DeviceDB` on the card → exact
resolution on the host with the CPU oracle (``ops/cpu_ref.py``). The
result is identical to running the oracle on every (row, template)
pair, and to the JAX engine's.

Per batch of up to ``batch_rows`` rows:

- dead rows (no response observed) match nothing and never reach the
  device;
- rows are deduplicated by content, and the unique rows are encoded
  padded to a 256-row bucket (``build_all=False``, widths a multiple of
  512) and matched on the device;
- the host keeps the certain bits (``t_value & ~t_unc``), decides each
  uncertain (row, template) pair with ``cpu_ref.match_template``, and
  redoes a row in full when it overflowed the candidate budget or was
  truncated;
- templates that read beyond the response content (host, port,
  duration, ip) are decided per member row, not per content;
- extractions come from the oracle for every matched template that has
  extractors, and the host-always tail runs on every row.

Not ported yet (ROADMAP.md): the sparse matcher-level walk and native
regex, the verdict memo and the shared result tier, the scheduler, the
breaker, ``dbcache``.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from swarm_tpu_torch.fingerprints.compile import CompiledDB, compile_corpus
from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.ops import cpu_ref
from swarm_tpu_torch.ops.encoding import encode_batch, round_up
from swarm_tpu_torch.ops.match import DeviceDB

_ROWDEP_VAR_RE = re.compile(r"\b(host|hostname|port|duration|ip)\b")


@dataclasses.dataclass
class RowMatches:
    """Exact match set for one response row."""

    template_ids: list
    extractions: dict  # template_id -> list[str]
    # (row, template) pairs the host decided with the oracle; under
    # content dedup they count once, on the content's first row
    confirmed_on_host: int = 0


@dataclasses.dataclass
class PackedMatches:
    """Exact verdicts for one batch in wire form.

    ``bits[b, t >> 3] & (0x80 >> (t & 7))`` is template ``t``'s verdict
    for row ``b`` (np.packbits MSB-first); ``template_ids`` maps the
    column index to ids. ``extractions`` is sparse: ``(row,
    template_id) -> list[str]``; ``host_always_matches`` lists the
    (row, template_id) hits of the host-only tail."""

    bits: np.ndarray  # uint8 [B, ceil(NT/8)]
    template_ids: list
    extractions: dict
    host_always_matches: list
    confirms_per_row: dict


@dataclasses.dataclass
class EngineStats:
    rows: int = 0
    batches: int = 0
    unique_rows: int = 0
    encode_seconds: float = 0.0
    device_seconds: float = 0.0
    host_seconds: float = 0.0
    host_confirm_pairs: int = 0
    overflow_rows: int = 0


def _is_row_dependent(t: Template) -> bool:
    """Whether any matcher/extractor reads beyond response content
    (host/hostname/port/duration/ip dsl vars or the "host" part)."""
    for op in t.operations:
        for m in op.matchers:
            if (m.part or "") == "host":
                return True
            if any(_ROWDEP_VAR_RE.search(e) for e in m.dsl):
                return True
        for ex in op.extractors:
            if (ex.part or "") == "host":
                return True
    return False


def _content_key(r: Response) -> tuple:
    """Everything the device and the content-side host work read."""
    return (
        r.banner, r.body, r.header, r.status,
        r.oob_protocols, r.oob_requests, r.oob_ips,
    )


def _dedup_rows(rows: Sequence[Response]):
    """(uniq_indices, back): ``back[i]`` is row i's unique slot."""
    key_of: dict = {}
    uniq = []
    back = np.empty(len(rows), dtype=np.int64)
    for i, r in enumerate(rows):
        j = key_of.setdefault(_content_key(r), len(uniq))
        if j == len(uniq):
            uniq.append(i)
        back[i] = j
    return uniq, back


def _set_bits(row: np.ndarray, limit: int) -> list:
    """Indices < limit of the set bits of one packed (MSB-first) row."""
    if limit <= 0:
        return []
    return np.flatnonzero(np.unpackbits(row, count=limit)).tolist()


class MatchEngine:
    def __init__(
        self,
        templates: Sequence[Template],
        max_body: int = 4096,
        max_header: int = 1024,
        batch_rows: int = 1024,
        db: Optional[CompiledDB] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.templates = list(templates)
        self.db = db if db is not None else compile_corpus(self.templates)
        self.device = DeviceDB(self.db, device=device)
        self.max_body = max_body
        self.max_header = max_header
        self.batch_rows = batch_rows
        self.stats = EngineStats()
        db = self.db
        self._rowdep = frozenset(
            i for i, t in enumerate(db.templates) if _is_row_dependent(t)
        )
        self._has_extractors = [
            any(op.extractors for op in t.operations) for t in db.templates
        ]

    # ------------------------------------------------------------------
    def match(self, responses: Sequence[Response]) -> list[RowMatches]:
        """Per-row exact match sets: template ids ascending by template
        index, then the host-always tail; extractions by template id.
        Dead rows (no response observed) match nothing and are dropped
        before batching, so they never reach the device."""
        alive = [i for i, r in enumerate(responses) if r.alive]
        out = [RowMatches(template_ids=[], extractions={}) for _ in responses]
        live = [responses[i] for i in alive]
        done = 0
        for s in range(0, len(live), self.batch_rows):
            rows = live[s : s + self.batch_rows]
            packed = self.match_packed(rows)
            for j, rm in enumerate(self.rowmatches_from_packed(packed, len(rows))):
                out[alive[done + j]] = rm
            done += len(rows)
        self.stats.rows += len(responses) - len(live)
        return out

    def rowmatches_from_packed(self, packed: PackedMatches, n: int) -> list:
        """Per-row assembly of one PackedMatches: template ids ascending
        by template index, then the host-always tail."""
        NT = self.db.num_templates
        names = self.db.template_ids
        extr_by_row: dict = {}
        for (rb, tid), ext in packed.extractions.items():
            extr_by_row.setdefault(rb, {})[tid] = ext
        always_by_row: dict = {}
        for rb, tid in packed.host_always_matches:
            always_by_row.setdefault(rb, []).append(tid)
        out = []
        for b in range(n):
            tids = [names[t] for t in _set_bits(packed.bits[b], NT)]
            tids.extend(always_by_row.get(b, ()))
            out.append(RowMatches(
                template_ids=tids,
                extractions=extr_by_row.get(b, {}),
                confirmed_on_host=packed.confirms_per_row.get(b, 0),
            ))
        return out

    def encode(self, rows: Sequence[Response]):
        """Unique rows → the device batch, padded to a 256-row bucket."""
        return encode_batch(
            rows,
            max_body=self.max_body,
            max_header=self.max_header,
            pad_rows_to=round_up(max(len(rows), 1), 256),
            build_all=False,
            width_multiple=512,
        )

    def match_packed(self, all_rows: Sequence[Response]) -> PackedMatches:
        """Exact verdict bitsets for up to ``batch_rows`` responses."""
        db = self.db
        nbytes = max((db.num_templates + 7) >> 3, 1)
        alive = [i for i, r in enumerate(all_rows) if r.alive]
        if len(alive) < len(all_rows):
            # dead rows match nothing by contract
            bits = np.zeros((len(all_rows), nbytes), dtype=np.uint8)
            self.stats.rows += len(all_rows) - len(alive)
            if not alive:
                return PackedMatches(bits, db.template_ids, {}, [], {})
            live = self.match_packed([all_rows[i] for i in alive])
            bits[alive] = live.bits
            return PackedMatches(
                bits=bits,
                template_ids=db.template_ids,
                extractions={(alive[rb], tid): v for (rb, tid), v in live.extractions.items()},
                host_always_matches=[(alive[rb], tid) for rb, tid in live.host_always_matches],
                confirms_per_row={alive[rb]: c for rb, c in live.confirms_per_row.items()},
            )
        rows = list(all_rows)
        uniq, back = _dedup_rows(rows)
        nrows = [rows[u] for u in uniq]
        U = len(nrows)
        self.stats.rows += len(rows)
        self.stats.batches += 1
        self.stats.unique_rows += U

        t0 = time.perf_counter()
        with record_function("engine.encode"):
            batch = self.encode(nrows)
        t1 = time.perf_counter()
        planes = self.device.match(batch.streams, batch.lengths, batch.status)
        t2 = time.perf_counter()
        with record_function("engine.resolve"):
            packed = self._resolve(rows, nrows, uniq, back, planes, batch.truncated)
        t3 = time.perf_counter()
        self.stats.encode_seconds += t1 - t0
        self.stats.device_seconds += t2 - t1
        self.stats.host_seconds += t3 - t2
        return packed

    def _resolve(self, rows, nrows, uniq, back, planes, truncated) -> PackedMatches:
        """The device's planes of the unique rows → exact verdicts of
        every row, with the oracle deciding what the device did not."""
        db = self.db
        NT = db.num_templates
        U = len(nrows)
        pt_value, pt_unc, _opv, _opu, _mu, overflow, _wf = planes
        # certain bits stand; the host decides the rest
        ubits = np.array(pt_value[:U] & ~pt_unc[:U], order="C")
        redo = overflow[:U] | truncated[:U]
        self.stats.overflow_rows += int(redo.sum())
        confirms = np.zeros(U, dtype=np.int64)
        deferred: list = []  # (slot, t_idx): decided per member row
        memo: dict = {}  # (slot, t_idx) -> oracle result

        def oracle(u: int, t_idx: int):
            res = memo.get((u, t_idx))
            if res is None:
                res = memo[(u, t_idx)] = cpu_ref.match_template(
                    db.templates[t_idx], nrows[u]
                )
                confirms[u] += 1
            return res

        for u in range(U):
            # an overflowed or truncated row is redone in full
            todo = range(NT) if redo[u] else _set_bits(pt_unc[u], NT)
            for t_idx in todo:
                byte_i, mask = t_idx >> 3, 0x80 >> (t_idx & 7)
                if t_idx in self._rowdep:
                    deferred.append((u, t_idx))
                    ubits[u, byte_i] &= 0xFF ^ mask
                elif oracle(u, t_idx).matched:
                    ubits[u, byte_i] |= mask
                else:
                    ubits[u, byte_i] &= 0xFF ^ mask
        # extractions of the content-decided hits
        uext: dict = {}
        for u in range(U):
            for t_idx in _set_bits(ubits[u], NT):
                if self._has_extractors[t_idx] and t_idx not in self._rowdep:
                    res = oracle(u, t_idx)
                    if res.extractions:
                        uext[(u, t_idx)] = res.extractions

        # broadcast the unique plane to the member rows
        bits = ubits[back] if rows else ubits[:0]
        members: dict = {}
        for i, u in enumerate(back.tolist()):
            members.setdefault(u, []).append(i)
        names = db.template_ids
        extractions: dict = {}
        for (u, t_idx), vals in uext.items():
            for i in members[u]:
                extractions[(i, names[t_idx])] = vals
        conf = {uniq[u]: int(c) for u, c in enumerate(confirms) if c}

        # row-dependent templates: decided per member row; a certain hit
        # of one with extractors takes its values per member too
        for u, t_idx in deferred:
            for i in members[u]:
                res = cpu_ref.match_template(db.templates[t_idx], rows[i])
                conf[i] = conf.get(i, 0) + 1
                if res.matched:
                    bits[i, t_idx >> 3] |= 0x80 >> (t_idx & 7)
                    if res.extractions:
                        extractions[(i, names[t_idx])] = res.extractions
        for t_idx in sorted(self._rowdep):
            if not self._has_extractors[t_idx]:
                continue
            byte_i, mask = t_idx >> 3, 0x80 >> (t_idx & 7)
            for u in np.flatnonzero(ubits[:, byte_i] & mask).tolist():
                for i in members[u]:
                    res = cpu_ref.match_template(db.templates[t_idx], rows[i])
                    if res.matched and res.extractions:
                        extractions[(i, names[t_idx])] = res.extractions

        # the host-always tail runs exactly, per actual row
        host_always: list = []
        for i, row in enumerate(rows):
            for template in db.host_always:
                res = cpu_ref.match_template(template, row)
                if res.matched:
                    host_always.append((i, template.id))
                    if res.extractions:
                        extractions[(i, template.id)] = res.extractions
        self.stats.host_confirm_pairs += int(sum(conf.values()))
        return PackedMatches(
            bits=np.ascontiguousarray(bits),
            template_ids=names,
            extractions=extractions,
            host_always_matches=host_always,
            confirms_per_row=conf,
        )
