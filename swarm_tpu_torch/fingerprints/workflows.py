"""Workflow templates + wappalyzer tech→tags mapping.

The reference corpus chains templates conditionally (``workflows/*``,
e.g. ``workflows/74cms-workflow.yaml:8-13`` in the reference's
``worker/artifacts/templates/``): run a fingerprint template, and when it (or one
of its *named matchers*) fires, run the subtemplates selected by tag or
path. ``wappalyzer-mapping.yml`` additionally maps detected technology
names to template tags for nuclei's automatic-scan mode.

TPU-first execution model: the whole corpus is matched in ONE batched
device pass (``ops/engine.MatchEngine``); workflows then become pure
post-processing — trigger hits gate which subtemplate hits are
*reported*. Match verdicts are identical to running subtemplates
conditionally; only the request-side effect differs (we matched an
already-captured response batch, so there is nothing to skip).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from swarm_tpu_torch.fingerprints.model import Template


@dataclasses.dataclass
class SubtemplateRef:
    """Selects templates by tag set OR by corpus-relative path."""

    tags: list[str] = dataclasses.field(default_factory=list)
    template: Optional[str] = None
    # nested chaining: these refs apply only when the parent fired
    matchers: list["MatcherGate"] = dataclasses.field(default_factory=list)
    subtemplates: list["SubtemplateRef"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MatcherGate:
    """Gate on a *named matcher* of the trigger template having fired."""

    name: str
    subtemplates: list[SubtemplateRef] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class WorkflowStep:
    template: Optional[str] = None  # corpus-relative path of the trigger
    tags: list[str] = dataclasses.field(default_factory=list)  # tag-triggered
    matchers: list[MatcherGate] = dataclasses.field(default_factory=list)
    subtemplates: list[SubtemplateRef] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Workflow:
    id: str
    steps: list[WorkflowStep] = dataclasses.field(default_factory=list)
    source_path: Optional[str] = None


def _parse_tags(raw) -> list[str]:
    if raw is None:
        return []
    if isinstance(raw, str):
        return [t.strip() for t in raw.split(",") if t.strip()]
    return [str(t).strip() for t in raw]


def _parse_ref(raw: dict) -> SubtemplateRef:
    return SubtemplateRef(
        tags=_parse_tags(raw.get("tags")),
        template=raw.get("template"),
        matchers=[_parse_gate(m) for m in raw.get("matchers") or []],
        subtemplates=[_parse_ref(s) for s in raw.get("subtemplates") or []],
    )


def _parse_gate(raw: dict) -> MatcherGate:
    return MatcherGate(
        name=str(raw.get("name", "")),
        subtemplates=[_parse_ref(s) for s in raw.get("subtemplates") or []],
    )


def parse_workflow(template: Template) -> Workflow:
    """Lift a protocol='workflow' Template's raw block into the model."""
    steps = []
    for raw in template.extra.get("workflows") or []:
        if not isinstance(raw, dict):
            continue
        steps.append(
            WorkflowStep(
                template=raw.get("template"),
                tags=_parse_tags(raw.get("tags")),
                matchers=[_parse_gate(m) for m in raw.get("matchers") or []],
                subtemplates=[_parse_ref(s) for s in raw.get("subtemplates") or []],
            )
        )
    return Workflow(id=template.id, steps=steps, source_path=template.source_path)


# ---------------------------------------------------------------------------
# wappalyzer-mapping.yml — tech name → template tags
# ---------------------------------------------------------------------------


def parse_wappalyzer_mapping(text: str) -> dict[str, list[str]]:
    """The mapping file is intentionally trivial YAML (``tech: tags``
    lines — `wappalyzer-mapping.yml:5-6` in the reference corpus); a
    hand parser avoids depending on comment-preserving YAML quirks."""
    out: dict[str, list[str]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, value = line.partition(":")
        if not sep:
            continue
        tags = _parse_tags(value)
        if key.strip() and tags:
            out[key.strip().lower()] = tags
    return out


def load_wappalyzer_mapping(path: str | Path) -> dict[str, list[str]]:
    return parse_wappalyzer_mapping(Path(path).read_text())


# ---------------------------------------------------------------------------
# Template index for ref resolution
# ---------------------------------------------------------------------------


class TemplateIndex:
    """Resolve SubtemplateRefs against a loaded corpus: by tag, and by
    corpus-relative path suffix (workflow refs are written relative to
    the corpus root)."""

    def __init__(self, templates: Sequence[Template]):
        self.by_tag: dict[str, list[Template]] = {}
        self._paths: list[tuple[str, Template]] = []
        for t in templates:
            for tag in t.tags:
                self.by_tag.setdefault(tag.lower(), []).append(t)
            if t.source_path:
                self._paths.append((str(t.source_path).replace("\\", "/"), t))
        # refs are row-invariant: memoize so per-row workflow evaluation
        # never rescans the corpus path list
        self._by_path_cache: dict[str, Optional[Template]] = {}

    def by_path(self, ref: str) -> Optional[Template]:
        if ref in self._by_path_cache:
            return self._by_path_cache[ref]
        norm = ref.replace("\\", "/").lstrip("/")
        found = None
        for path, t in self._paths:
            if path.endswith("/" + norm) or path == norm:
                found = t
                break
        self._by_path_cache[ref] = found
        return found

    def resolve(self, ref: SubtemplateRef) -> list[Template]:
        out: list[Template] = []
        if ref.template:
            t = self.by_path(ref.template)
            if t:
                out.append(t)
        for tag in ref.tags:
            out.extend(self.by_tag.get(tag.lower(), []))
        return out
