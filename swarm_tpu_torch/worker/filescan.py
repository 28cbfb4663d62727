"""File-template scanning engine (nuclei ``file`` protocol) — a copy of
``swarm_tpu/worker/filescan.py`` whose engine runs on the worker's
torch device (``device=``, or an ``engine`` built on it).

The reference corpus carries 76 ``file``-protocol templates under
``worker/artifacts/templates/file/`` plus the standalone
``worker/artifacts/s3-bucket.yaml:7-18`` (regex extractors for S3 bucket
URLs); the reference executes them via the nuclei binary
(``worker/modules/nuclei.json``). Here they run on the device: every input
file's bytes become one response row, all matcher-bearing templates are
evaluated in one device batch by :class:`~swarm_tpu_torch.ops.engine.MatchEngine`
(exact, oracle-confirmed), and the corpus's extractor-only templates
(which nuclei treats as "fire if anything extracts") run host-side over
the extension-gated file subset.

Measured corpus surface (SURVEY.md §2.3): file matchers are word (43) +
regex (128) only, with per-entry ``extensions`` gates — word/regex is
exactly the device matcher's home turf.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.ops import cpu_ref

# nuclei's default max file size for the file protocol; larger files are
# truncated (matchers beyond the cap would need unbounded device shapes).
DEFAULT_MAX_FILE_SIZE = 5 << 20
DEFAULT_MAX_FILES = 100_000


@dataclasses.dataclass
class FileFinding:
    """One (template, file) hit."""

    template_id: str
    path: str
    severity: str = "info"
    extractions: list[str] = dataclasses.field(default_factory=list)


def _ext_of(path: Path) -> str:
    return path.suffix.lower().lstrip(".")


class FileScanner:
    """Scan local files against ``file``-protocol templates.

    ``templates`` may be a whole corpus — non-file protocols are
    ignored, so callers can pass a full templates dir's parse result.
    """

    def __init__(
        self,
        templates: Sequence[Template],
        max_file_size: int = DEFAULT_MAX_FILE_SIZE,
        max_files: int = DEFAULT_MAX_FILES,
        engine=None,
        scan_root: Optional[str] = None,
        device=None,
    ):
        # optional confinement: when set, input paths outside this root
        # are ignored — job chunks come over the wire, and a scan job
        # must not be able to read arbitrary worker files
        self.scan_root = (
            Path(scan_root).resolve() if scan_root else None
        )
        file_templates = [t for t in templates if t.protocol == "file"]
        self.templates = file_templates
        self.matcher_templates = [
            t for t in file_templates
            if any(op.matchers for op in t.operations)
        ]
        # nuclei semantics: a file template with only extractors fires
        # when any extractor yields output (the engine itself treats
        # no-matcher templates as never-match, compile.py "no matchers
        # anywhere"); these run host-side on the extension-gated subset.
        self.extractor_only = [
            t for t in file_templates
            if not any(op.matchers for op in t.operations)
            and any(op.extractors for op in t.operations)
        ]
        self.max_file_size = max_file_size
        self.max_files = max_files
        # Extension gate per template: union over its operations;
        # an entry with no extensions list is treated as "all".
        self._ext_gate: dict[str, set] = {}
        for t in file_templates:
            exts: set = set()
            for op in t.operations:
                exts.update(op.extensions or ["all"])
            self._ext_gate[t.id] = exts
        self._severity = {t.id: t.severity for t in file_templates}
        if engine is not None:
            self.engine = engine
        elif self.matcher_templates:
            from swarm_tpu_torch.ops.engine import MatchEngine

            self.engine = MatchEngine(self.matcher_templates, device=device)
        else:
            self.engine = None

    # ------------------------------------------------------------------
    def _applicable(self, template_id: str, ext: str) -> bool:
        gate = self._ext_gate.get(template_id)
        if not gate:
            return True
        return "all" in gate or ext in gate

    def expand_paths(self, paths: Sequence[str]) -> list[Path]:
        """Files from a mixed list of file/directory paths (recursive),
        de-duplicated, bounded by ``max_files``."""
        out: list[Path] = []
        seen: set = set()
        def is_file(q: Path) -> bool:
            # pathlib only swallows ENOENT-class errors; EACCES (e.g. an
            # unreadable /proc symlink) would abort the whole walk
            try:
                if not q.is_file():
                    return False
            except OSError:
                return False
            if self.scan_root is not None:
                # confinement holds for every candidate, not just the
                # input path: a symlink inside the root must not reach
                # files outside it
                try:
                    q.resolve().relative_to(self.scan_root)
                except (ValueError, OSError):
                    return False
            return True

        for raw in paths:
            raw = raw.strip()
            if not raw or raw.startswith("#"):
                continue  # blank line would be Path('.') — scan nothing
            p = Path(raw)
            if self.scan_root is not None:
                try:
                    p.resolve().relative_to(self.scan_root)
                except (ValueError, OSError):
                    continue  # outside the confinement root
            try:
                candidates = (
                    sorted(q for q in p.rglob("*") if is_file(q))
                    if p.is_dir()
                    else [p] if is_file(p) else []
                )
            except OSError:
                continue
            for q in candidates:
                if q in seen:
                    continue
                seen.add(q)
                out.append(q)
                if len(out) >= self.max_files:
                    return out
        return out

    # ------------------------------------------------------------------
    def scan_paths(
        self, paths: Sequence[str]
    ) -> tuple[list[FileFinding], dict]:
        files = self.expand_paths(paths)
        # corpus-wide extension gate: skip reading files no template
        # could apply to (unless some template accepts "all")
        all_exts: set = set()
        for gate in self._ext_gate.values():
            all_exts |= gate
        scan_everything = "all" in all_exts or not self._ext_gate
        rows: list[Response] = []
        kept: list[Path] = []
        for f in files:
            if not scan_everything and _ext_of(f) not in all_exts:
                continue
            try:
                with open(f, "rb") as fh:  # capped read, not whole-file
                    data = fh.read(self.max_file_size)
            except OSError:
                continue
            kept.append(f)
            # host carries the path so output/debug rows are attributable
            rows.append(Response(host=str(f), body=data))
        findings: list[FileFinding] = []
        # 1) matcher-bearing templates: one exact device batch
        if self.engine is not None and rows:
            for f, row, rm in zip(kept, rows, self.engine.match(rows)):
                ext = _ext_of(f)
                for tid in rm.template_ids:
                    if not self._applicable(tid, ext):
                        continue
                    findings.append(
                        FileFinding(
                            template_id=tid,
                            path=str(f),
                            severity=self._severity.get(tid, "info"),
                            extractions=rm.extractions.get(tid, []),
                        )
                    )
        # 2) extractor-only templates, host-side on the gated subset
        for f, row in zip(kept, rows):
            ext = _ext_of(f)
            for t in self.extractor_only:
                if not self._applicable(t.id, ext):
                    continue
                values: list[str] = []
                for op in t.operations:
                    values.extend(cpu_ref._extract(op, row))
                if values:
                    findings.append(
                        FileFinding(
                            template_id=t.id,
                            path=str(f),
                            severity=self._severity.get(t.id, "info"),
                            extractions=values,
                        )
                    )
        stats = {
            "files_scanned": len(kept),
            "templates": len(self.templates),
            "matcher_templates": len(self.matcher_templates),
            "extractor_only_templates": len(self.extractor_only),
            "hits": len(findings),
        }
        return findings, stats


def format_findings(findings: Sequence[FileFinding]) -> bytes:
    """nuclei-style output lines:
    ``[template-id] [file] [severity] path ["extracted",...]``."""
    lines = []
    for h in findings:
        extra = (
            " [" + ",".join(repr(v) for v in h.extractions) + "]"
            if h.extractions
            else ""
        )
        lines.append(f"[{h.template_id}] [file] [{h.severity}] {h.path}{extra}")
    return ("\n".join(lines) + "\n").encode() if lines else b""
