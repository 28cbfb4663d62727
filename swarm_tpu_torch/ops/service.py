"""Service/version classification — the ``nmap -sV`` capability (the
port of ``swarm_tpu/ops/service.py``).

Every match directive of an nmap-service-probes DB lowers into the same
device match infrastructure the template corpus uses (regex → required
literal → word table, ``fingerprints/compile.py``): the card prefilters
(row, match) candidate pairs over the whole banner batch, then the host
confirms only the candidates with the real regex to bind capture groups
for version extraction. First hard match in DB order wins; softmatches
name the service when nothing hard fires (nmap semantics).

The classifier's engine runs on the card unless ``device="cpu"`` (or
another torch device) is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from swarm_tpu_torch.fingerprints.model import Matcher, Operation, Response, Template
from swarm_tpu_torch.fingerprints.nmap_probes import (
    ServiceMatch,
    ServiceProbe,
    load_probes,
    substitute_version,
)


@dataclasses.dataclass
class ServiceInfo:
    host: str
    port: int
    open: bool = False
    service: Optional[str] = None
    product: Optional[str] = None
    version: Optional[str] = None
    info: Optional[str] = None
    cpe: list[str] = dataclasses.field(default_factory=list)
    soft: bool = False  # only a softmatch fired

    def line(self) -> str:
        """One output line: host:port state service product version."""
        state = "open" if self.open else "closed"
        fields = [f"{self.host}:{self.port}", state, self.service or "unknown"]
        desc = " ".join(x for x in (self.product, self.version) if x)
        if desc:
            fields.append(desc)
        if self.info:
            fields.append(f"({self.info})")
        return "\t".join(fields)


def _inline_flags(m: ServiceMatch) -> str:
    """Fold the directive's s/i flags into the pattern so every regex
    engine downstream (device required-literal lowering, CPU oracle,
    host confirm) sees identical semantics."""
    prefix = ""
    if "s" in m.flags:
        prefix += "(?s)"
    if "i" in m.flags:
        prefix += "(?i)"
    return prefix + m.pattern


class ServiceClassifier:
    """Compiled probes DB + the batched classify path."""

    def __init__(
        self,
        probes: Optional[list[ServiceProbe]] = None,
        db_path: Optional[str] = None,
        **engine_kwargs,
    ):
        file_backed = probes is None  # cacheable: identity = the DB file
        if probes is None:
            probes, self.skipped_matches = load_probes(db_path)
        else:
            self.skipped_matches = 0
        self.probes = probes
        self.probe_by_name = {p.name: p for p in probes}

        # Flatten matches in DB order; each becomes one network template
        # whose single regex matcher runs over the banner stream.
        self._matches: list[tuple[str, ServiceMatch]] = []  # (probe_name, match)
        templates = []
        for probe in probes:
            for match in probe.matches:
                tid = f"svc/{probe.name}/{len(self._matches)}"
                self._matches.append((probe.name, match))
                templates.append(
                    Template(
                        id=tid,
                        protocol="network",
                        operations=[
                            Operation(
                                matchers=[
                                    Matcher(
                                        type="regex",
                                        part="body",
                                        regex=[_inline_flags(match)],
                                    )
                                ]
                            )
                        ],
                    )
                )
        from swarm_tpu_torch.ops.engine import MatchEngine  # deferred: heavy import

        # bound the compile: 12k signatures cost ~18 s of lowering cold
        # (the production-scale DB) — key the CompiledDB on the match
        # population (post-inlining, so a flag-folding change can never
        # serve stale lowerings) and serve it from the disk cache warm.
        # Only file-backed DBs cache: the tag is the DB file's identity
        # so distinct DBs (bundled vs production) keep separate entries
        # instead of evicting each other.
        if "db" not in engine_kwargs and file_backed:
            from swarm_tpu_torch.fingerprints.compile import compile_corpus
            from swarm_tpu_torch.fingerprints.dbcache import (
                load_or_compile_keyed,
                path_tag,
            )

            key = "\x00".join(
                f"{p}|{m.service}|{int(m.soft)}|{_inline_flags(m)}"
                for p, m in self._matches
            ).encode("utf-8", "surrogateescape")
            tag = "svcdb-" + (path_tag(db_path) if db_path else "builtin")
            engine_kwargs["db"] = load_or_compile_keyed(
                tag, key, lambda: compile_corpus(templates)
            )
        self.engine = MatchEngine(templates, **engine_kwargs)
        self._compiled = [m.compile() for _probe, m in self._matches]
        self._by_probe: dict[str, list[int]] = {}
        for idx, (probe_name, _m) in enumerate(self._matches):
            self._by_probe.setdefault(probe_name, []).append(idx)
        self._port_probe_cache: dict[int, ServiceProbe] = {}
        # (banner, sent_probe) -> classified service fields; bounded
        self._classify_memo: dict = {}

    # ------------------------------------------------------------------
    def _probe_order(self, sent_probe: Optional[str]) -> Optional[list[str]]:
        """Probes whose matches apply to a response elicited by
        ``sent_probe``, in nmap evaluation order: the sent probe's own
        matches first, then its declared fallbacks, then NULL."""
        if sent_probe is None:
            return None  # no probe bookkeeping: every match applies
        order = [sent_probe]
        probe = self.probe_by_name.get(sent_probe)
        if probe:
            order.extend(f for f in probe.fallback if f not in order)
        if "NULL" not in order:
            order.append("NULL")
        return order

    def classify(
        self,
        rows: Sequence[Response],
        sent_probes: Optional[Sequence[Optional[str]]] = None,
    ) -> list[ServiceInfo]:
        results = self.engine.match(rows)
        out: list[ServiceInfo] = []
        for i, (row, hits) in enumerate(zip(rows, results)):
            info = ServiceInfo(host=row.host, port=row.port, open=row.alive)
            banner = row.part("body")
            if not row.alive or not banner:
                out.append(info)
                continue
            # fleet banners repeat heavily (every OpenSSH 8.9 host says
            # the same bytes): the whole verify/veto walk below is a
            # pure function of (banner, sent probe), so memo its
            # service fields across rows and batches
            sent = sent_probes[i] if sent_probes else None
            mkey = (banner, sent)
            memo = self._classify_memo.get(mkey)
            if memo is not None:
                (
                    info.service, info.product, info.version,
                    info.info, cpe, info.soft,
                ) = memo
                info.cpe = list(cpe)  # callers may mutate their copy
                out.append(info)
                continue
            cand = {
                int(tid.rsplit("/", 1)[1])
                for tid in hits.template_ids
                if tid.startswith("svc/")
            }
            probe_order = self._probe_order(sent)
            if probe_order is None:
                ordered = sorted(cand)
            else:
                ordered = [
                    idx
                    for pname in probe_order
                    for idx in self._by_probe.get(pname, [])
                    if idx in cand
                ]
            soft_hit: Optional[ServiceMatch] = None
            hard_done = False
            for idx in ordered:
                _probe_name, match = self._matches[idx]
                pattern = self._compiled[idx]
                mo = pattern.search(banner) if pattern else None
                if not mo:
                    continue  # device prefilter is a superset; host veto
                if match.soft:
                    soft_hit = soft_hit or match
                    continue
                # after a softmatch names a service, only hard matches for
                # that same service may win (nmap softmatch semantics)
                if soft_hit is not None and match.service != soft_hit.service:
                    continue
                info.service = match.service
                info.product = substitute_version(match.product, mo)
                info.version = substitute_version(match.version, mo)
                info.info = substitute_version(match.info, mo)
                info.cpe = [substitute_version(c, mo) for c in match.cpe]
                hard_done = True
                break
            if not hard_done and soft_hit:
                info.service = soft_hit.service
                info.soft = True
            # tuple-copy cpe: the caller owns (and may mutate) its list.
            # Bounding shares the engine's memo policy (_cache_put).
            self.engine._cache_put(
                self._classify_memo,
                mkey,
                (
                    info.service, info.product, info.version,
                    info.info, tuple(info.cpe), info.soft,
                ),
            )
            out.append(info)
        return out

    # ------------------------------------------------------------------
    def probe_for_port(self, port: int) -> ServiceProbe:
        """Payload selection: lowest-rarity TCP probe with a payload
        covering the port; NULL (listen-only) otherwise. Memoized —
        service scans call this per (host, port) on the probing hot
        path."""
        cached = self._port_probe_cache.get(port)
        if cached is not None:
            return cached
        best: Optional[ServiceProbe] = None
        for probe in self.probes:
            if probe.proto != "TCP" or not probe.payload:
                continue
            if probe.covers_port(port) and (best is None or probe.rarity < best.rarity):
                best = probe
        if best is None:
            best = self.probe_by_name.get("NULL") or ServiceProbe(
                proto="TCP", name="NULL"
            )
        self._port_probe_cache[port] = best
        return best

    def default_payload_probe(self) -> Optional[ServiceProbe]:
        """Second-round probe for silent-but-open ports: the lowest-
        rarity TCP payload probe regardless of port coverage (nmap keeps
        escalating probes by rarity when the NULL listen stays quiet)."""
        best: Optional[ServiceProbe] = None
        for probe in self.probes:
            if probe.proto != "TCP" or not probe.payload:
                continue
            if best is None or probe.rarity < best.rarity:
                best = probe
        return best
