"""Workflow execution over the one-pass batched match (the port of
``swarm_tpu/ops/workflows.py``).

Semantics mirror the reference corpus's workflow templates (SURVEY.md
§2.3): a trigger template (by path or tags) gates subtemplates (by tag
or path), optionally scoped to specific *named matchers* of the trigger;
subtemplates nest recursively. Plus nuclei's automatic-scan mode
(:meth:`WorkflowRunner.auto_scan`): detected technologies (named
matchers of tech templates) map through ``wappalyzer-mapping.yml`` to
tags whose templates are then selected.

Two execution paths produce bit-identical per-row results
(``docs/WORKFLOWS.md`` of the reference):

- **Device gate planes** (default): the compiler lowered each
  workflow's trigger→subtemplate DAG into per-condition / per-emit
  Kleene planes (``fingerprints.compile.lower_workflows``); the verdict
  tail ships them per row and this module decodes them — certain emits
  read straight off the plane, uncertain emits resolve at CONDITION
  granularity on the host (hit conds from the walked hit set, gate
  conds from a memoized named-matcher confirm). Workflows the lowering
  could not express (``plan.host_only_ids``) run through the twin loop.
- **Host-loop reference twin** (``device=False`` or
  ``SWARM_WORKFLOW_DEVICE=0``): the original per-row Python loop,
  retained as the oracle the device path is held to.

Per-content gating results additionally memoize in a runner L1 when
EVERY workflow is content-pure (no reachable template reads
host/port/duration), and behind it in the engine's fleet result tier
(the ``"w"`` family of ``swarm_tpu_torch/cache``, keyed by the tier's
``row_digest``), so a rescan of trigger content that any worker has
gated completes without any device dispatch. The ``active`` backend's batched gate
re-confirm (:meth:`WorkflowRunner.resolve_gate_names`) reads the named
matchers it needs off the same planes. The ``swarm_workflow_*``
families count the steps lowered, the batches decoded through gate
planes, the step memo's hits (``l1`` and ``shared``) and misses and the
host-twin fallbacks.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import numpy as np

from swarm_tpu_torch.cache.tier import row_digest
from swarm_tpu_torch.fingerprints.compile import (
    WFC_HIT_DEV,
    WFC_HIT_HOST,
    WFC_MATCHER,
    WFC_OP,
)
from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.fingerprints.workflows import (
    SubtemplateRef,
    TemplateIndex,
    Workflow,
    parse_workflow,
)
from swarm_tpu_torch.ops import cpu_ref
from swarm_tpu_torch.telemetry.workflow_export import (
    WORKFLOW_GATE_PLANE_BATCHES,
    WORKFLOW_HOST_TWIN_FALLBACKS,
    WORKFLOW_STEP_MEMO_HITS,
    WORKFLOW_STEP_MEMO_MISSES,
    WORKFLOW_STEPS_COMPILED,
)

#: runner-local per-content memo cap (FIFO, oldest half dropped)
_WF_MEMO_MAX = 4096


def _device_default() -> bool:
    return os.environ.get("SWARM_WORKFLOW_DEVICE", "1").lower() not in (
        "0", "false", "off",
    )


class WorkflowRunner:
    def __init__(
        self,
        templates: Sequence[Template],
        engine=None,
        wappalyzer: Optional[dict[str, list[str]]] = None,
        device=None,
        **engine_kwargs,
    ):
        # ``device`` is the reference's gate-plane decoding switch (a
        # bool; None reads SWARM_WORKFLOW_DEVICE). Anything else names
        # the torch device of the engine this runner builds ("cpu",
        # "cuda", a torch.device), and decoding follows the environment.
        if device is not None and not isinstance(device, bool):
            engine_kwargs["device"] = device
            device = None
        self.workflows: list[Workflow] = [
            parse_workflow(t) for t in templates if t.protocol == "workflow"
        ]
        self.matchable = [t for t in templates if t.protocol != "workflow"]
        self.index = TemplateIndex(self.matchable)
        self.by_id = {t.id: t for t in self.matchable}
        self.wappalyzer = {k.lower(): v for k, v in (wappalyzer or {}).items()}
        if engine is None:
            from swarm_tpu_torch.ops.engine import MatchEngine

            # the FULL list: compile_corpus skips workflow-protocol
            # templates from the match planes but lowers their DAGs
            # into db.wf — building over self.matchable would silently
            # drop the gate planes and pin every row to the twin
            engine = MatchEngine(list(templates), **engine_kwargs)
        self.engine = engine
        plan = getattr(getattr(engine, "db", None), "wf", None)
        if plan is not None and not plan.num_terms:
            plan = None
        self.plan = plan
        want = _device_default() if device is None else bool(device)
        #: device gate-plane decoding active (the host loop is still
        #: the path for plan-less rows and host-only workflows)
        self.device = bool(want and plan is not None)
        self._host_only_wfs = (
            [w for w in self.workflows if w.id in set(plan.host_only_ids)]
            if plan is not None
            else list(self.workflows)
        )
        # emit index → term rows targeting it (uncertain-emit host
        # resolution walks only these)
        self._terms_of_emit: dict[int, list[int]] = {}
        if plan is not None:
            for term, e in enumerate(plan.term_emit.tolist()):
                self._terms_of_emit.setdefault(int(e), []).append(term)
        # content-purity: the per-content memo is sound only when NO
        # workflow can reach a row-dependent template (host/port gates
        # would make content-identical rows disagree)
        from swarm_tpu_torch.ops.engine import _is_row_dependent

        self._memo_complete = all(
            not _is_row_dependent(self.by_id[tid])
            for wf in self.workflows
            for tid in self._wf_template_ids(wf)
            if tid in self.by_id
        )
        self._memo_lock = threading.Lock()  # guards: _wf_memo
        self._wf_memo: dict[str, dict] = {}
        # named-matcher gates the workflows actually query, per
        # template — the active scanner's batched gate re-confirm
        # resolves exactly these (anything else is never looked up)
        self._needed_names: dict[str, set] = self._collect_gate_names()
        self.gate_template_ids: set = set(self._needed_names)
        # (template, gate name) → cond rows in the plan whose value
        # decides it (one per lowered alternative; OR = name fired)
        self._plane_names: dict[str, dict[str, list[int]]] = {}
        if plan is not None:
            for ci in range(plan.num_conds):
                if int(plan.cond_kind[ci]) in (WFC_OP, WFC_MATCHER):
                    self._plane_names.setdefault(
                        plan.cond_template[ci], {}
                    ).setdefault(plan.cond_name[ci], []).append(ci)
        if plan is not None:
            WORKFLOW_STEPS_COMPILED.labels().set(
                float(plan.stats.get("steps_compiled", 0))
            )

    # ------------------------------------------------------------------
    def _wf_template_ids(self, wf: Workflow) -> set:
        """Every template id a workflow's evaluation can touch
        (triggers, gate subtemplates, nested refs) — the purity scan's
        domain."""
        ids: set = set()

        def walk_ref(ref: SubtemplateRef) -> None:
            for t in self.index.resolve(ref):
                ids.add(t.id)
            for gate in ref.matchers:
                for sub in gate.subtemplates:
                    walk_ref(sub)
            for sub in ref.subtemplates:
                walk_ref(sub)

        for step in wf.steps:
            if step.template:
                t = self.index.by_path(step.template)
                if t:
                    ids.add(t.id)
            for tag in step.tags:
                ids.update(t.id for t in self.index.by_tag.get(tag.lower(), []))
            for gate in step.matchers:
                for sub in gate.subtemplates:
                    walk_ref(sub)
            for sub in step.subtemplates:
                walk_ref(sub)
        return ids

    def _collect_gate_names(self) -> dict[str, set]:
        """template id → the gate names any workflow queries on it."""
        needed: dict[str, set] = {}

        def note(t: Template, gates) -> None:
            for g in gates:
                needed.setdefault(t.id, set()).add(g.name)

        def walk_ref(ref: SubtemplateRef) -> None:
            if ref.matchers:
                for t in self.index.resolve(ref):
                    note(t, ref.matchers)
                for g in ref.matchers:
                    for sub in g.subtemplates:
                        walk_ref(sub)
            for sub in ref.subtemplates:
                walk_ref(sub)

        for wf in self.workflows:
            for step in wf.steps:
                triggers: list[Template] = []
                if step.template:
                    t = self.index.by_path(step.template)
                    if t:
                        triggers.append(t)
                for tag in step.tags:
                    triggers.extend(self.index.by_tag.get(tag.lower(), []))
                if step.matchers:
                    for t in triggers:
                        note(t, step.matchers)
                    for g in step.matchers:
                        for sub in g.subtemplates:
                            walk_ref(sub)
                for sub in step.subtemplates:
                    walk_ref(sub)
        return needed

    # ------------------------------------------------------------------
    def resolve_gate_names(
        self, needs: Sequence[tuple]
    ) -> list[list[str]]:
        """Batched named-matcher gate re-confirm for the active
        scanner: ``[(template_id, row), ...]`` → the fired gate-name
        list per pair. The distinct rows ride ONE engine batch (the
        scheduler's QoS lanes / in-flight overlap / memo families all
        apply under pipeline mode); pairs whose every queried gate
        lowered to a certain device condition decode straight off the
        gate planes, the rest fall back to the exact per-row cpu_ref
        confirm — the same oracle ``_matcher_names`` uses, so the
        result is bit-identical to the serial path either way."""
        if not needs:
            return []
        rows_u: list = []
        slot: dict[int, int] = {}
        for _tid, row in needs:
            if id(row) not in slot:
                slot[id(row)] = len(rows_u)
                rows_u.append(row)
        results = self.engine.match(rows_u)
        if self.device and any(rm.wf is not None for rm in results):
            WORKFLOW_GATE_PLANE_BATCHES.labels().inc()
        out: list = []
        fb: dict = {}
        for tid, row in needs:
            s = slot[id(row)]
            names = self._names_from_planes(tid, results[s])
            if names is None:
                key = (s, tid)
                if key not in fb:
                    t = self.by_id.get(tid)
                    fb[key] = (
                        sorted(
                            set(
                                cpu_ref.match_template(t, row).matcher_names
                            )
                        )
                        if t is not None and row is not None
                        else []
                    )
                names = fb[key]
            out.append(names)
        return out

    def _names_from_planes(self, tid: str, rm) -> Optional[list]:
        """Fired gate names of ``tid`` for one row, decoded from its
        device cond planes — None when any queried gate is unlowered
        or uncertain (the caller re-confirms the row exactly)."""
        if not self.device or getattr(rm, "wf", None) is None:
            return None
        needed = self._needed_names.get(tid)
        if not needed:
            return []
        lanes = self._plane_names.get(tid, {})
        if not needed <= set(lanes):
            return None
        plan = self.plan
        cv = np.unpackbits(
            np.asarray(rm.wf[0], dtype=np.uint8), count=plan.num_conds
        )
        cu = np.unpackbits(
            np.asarray(rm.wf[1], dtype=np.uint8), count=plan.num_conds
        )
        fired: list = []
        for name in needed:
            cis = lanes[name]
            if any(cu[ci] for ci in cis):
                return None
            if any(cv[ci] for ci in cis):
                fired.append(name)
        return sorted(fired)

    # ------------------------------------------------------------------
    def run(self, rows: Sequence[Response]) -> list[dict[str, list[str]]]:
        """→ per row: {workflow_id: [matched template ids]} (workflows
        whose trigger didn't fire are absent)."""
        out: list = [None] * len(rows)
        pending: list[int] = []
        for i, row in enumerate(rows):
            if not getattr(row, "alive", True):
                out[i] = {}  # dead rows match nothing by contract
            else:
                pending.append(i)
        # step-memo front: L1 then the shared "w" family — a served row
        # never reaches the engine at all (the zero-dispatch rescan)
        if pending and self._memo_complete:
            digests = {i: row_digest(rows[i]) for i in pending}
            still: list[int] = []
            with self._memo_lock:
                for i in pending:
                    entry = self._wf_memo.get(digests[i])
                    if entry is None:
                        still.append(i)
                    else:
                        out[i] = {k: list(v) for k, v in entry.items()}
            if len(pending) - len(still):
                WORKFLOW_STEP_MEMO_HITS.labels(tier="l1").inc(
                    len(pending) - len(still)
                )
            client = getattr(self.engine, "_result_cache", None)
            if still and client is not None:
                got = client.lookup_workflows([rows[i] for i in still])
                if got:
                    WORKFLOW_STEP_MEMO_HITS.labels(tier="shared").inc(
                        len(got)
                    )
                served = []
                for pos, entry in got.items():
                    i = still[pos]
                    out[i] = {k: list(v) for k, v in entry.items()}
                    self._memo_put(digests[i], entry)
                    served.append(i)
                still = [i for i in still if i not in set(served)]
            if still:
                WORKFLOW_STEP_MEMO_MISSES.labels().inc(len(still))
            pending = still
        if pending:
            fresh = [rows[i] for i in pending]
            results = self.engine.match(fresh)
            if self.device and any(rm.wf is not None for rm in results):
                WORKFLOW_GATE_PLANE_BATCHES.labels().inc()
            writeback: list = []
            for i, rm in zip(pending, results):
                row = rows[i]
                per = self._gate_row(rm, lambda _tid, _r=row: [_r])
                out[i] = per
                if self._memo_complete:
                    self._memo_put(row_digest(row), per)
                    writeback.append((row, per))
            client = getattr(self.engine, "_result_cache", None)
            if writeback and client is not None:
                client.writeback_workflows(writeback)
        return out

    def _memo_put(self, digest: str, per: dict) -> None:
        with self._memo_lock:
            memo = self._wf_memo
            if len(memo) >= _WF_MEMO_MAX:
                for k in list(memo)[: _WF_MEMO_MAX // 2]:
                    memo.pop(k, None)
            memo[digest] = {k: list(v) for k, v in per.items()}

    # ------------------------------------------------------------------
    def _gate_row(self, rm, row_of) -> dict[str, list[str]]:
        """One matched row → {workflow_id: [template ids]}, via device
        planes when the row carries them, else the full twin loop."""
        hit_ids = set(rm.template_ids)
        cache: dict[str, list[str]] = {}
        wfp = getattr(rm, "wf", None)
        if self.device and wfp is not None:
            per = self._decode_planes(wfp, hit_ids, row_of, cache)
            for wf in self._host_only_wfs:
                matched = self._eval_workflow(wf, row_of, hit_ids, cache)
                if matched:
                    per[wf.id] = sorted(matched)
            return per
        if self.plan is not None:
            WORKFLOW_HOST_TWIN_FALLBACKS.labels().inc()
        per = {}
        for wf in self.workflows:
            matched = self._eval_workflow(wf, row_of, hit_ids, cache)
            if matched:
                per[wf.id] = sorted(matched)
        return per

    def _decode_planes(
        self, wfp: tuple, hit_ids: set, row_of, cache: dict
    ) -> dict[str, list[str]]:
        """Per-row Kleene planes → workflow results. Certain emits read
        off the plane; each uncertain emit re-walks its terms with
        certain conds from the plane and uncertain conds resolved
        exactly on the host."""
        plan = self.plan
        cond_v, cond_u, emit_v, emit_u = wfp
        ev = np.unpackbits(
            np.asarray(emit_v, dtype=np.uint8), count=plan.num_emits
        )
        eu = np.unpackbits(
            np.asarray(emit_u, dtype=np.uint8), count=plan.num_emits
        )
        cv = cu = None
        per: dict[str, set] = {}
        for e in np.flatnonzero(ev).tolist():
            wf_id, tid = plan.emits[e]
            per.setdefault(wf_id, set()).add(tid)
        for e in np.flatnonzero(eu).tolist():
            if cv is None:
                cv = np.unpackbits(
                    np.asarray(cond_v, dtype=np.uint8), count=plan.num_conds
                )
                cu = np.unpackbits(
                    np.asarray(cond_u, dtype=np.uint8), count=plan.num_conds
                )
            for term in self._terms_of_emit.get(e, ()):
                if self._term_true(term, cv, cu, hit_ids, row_of, cache):
                    wf_id, tid = plan.emits[e]
                    per.setdefault(wf_id, set()).add(tid)
                    break
        return {wf_id: sorted(s) for wf_id, s in per.items()}

    def _term_true(
        self, term: int, cv, cu, hit_ids: set, row_of, cache: dict
    ) -> bool:
        plan = self.plan
        for ci in plan.term_cond[term].tolist():
            if ci < 0:  # padding: vacuously true
                continue
            if not cu[ci]:
                if not cv[ci]:
                    return False
                continue
            if not self._cond_host(ci, hit_ids, row_of, cache):
                return False
        return True

    def _cond_host(
        self, ci: int, hit_ids: set, row_of, cache: dict
    ) -> bool:
        """Exact host value of one uncertain condition. Hit conds read
        the engine's walked hit set; gate conds (op/matcher/host) all
        reduce to "did gate NAME fire on TEMPLATE" — sound because the
        lowering duplicates terms per gate alternative, so the
        name-level OR can only re-derive an emit another alternative's
        term already owns."""
        plan = self.plan
        kind = int(plan.cond_kind[ci])
        tid = plan.cond_template[ci]
        if kind in (WFC_HIT_DEV, WFC_HIT_HOST):
            return tid in hit_ids
        t = self.by_id.get(tid)
        if t is None:
            return False
        return plan.cond_name[ci] in self._matcher_names(t, row_of, cache)

    # ------------------------------------------------------------------
    def evaluate_hits(
        self, hit_ids: set, row_of, known_names: Optional[dict] = None
    ) -> dict[str, list[str]]:
        """Workflow gating over an already-matched hit set.

        ``row_of(template_id)`` returns the Response list whose matches
        fired that template — named-matcher gates re-confirm against
        every one (a gate fires if its name fired on ANY of them). This
        is the production entry for the active scanner, where each
        template's hits came from its own requests' responses (no
        single row carries device planes for the joined set, so this
        path is always the host loop)."""
        # pre-seeded fired-name lists (e.g. the ssl scanner records its
        # own named-matcher verdicts) take precedence over re-confirming
        names_cache: dict[str, list[str]] = dict(known_names or {})
        per: dict[str, list[str]] = {}
        for wf in self.workflows:
            matched = self._eval_workflow(wf, row_of, hit_ids, names_cache)
            if matched:
                per[wf.id] = sorted(matched)
        return per

    # ------------------------------------------------------------------
    # host-loop reference twin (bit-identical oracle for the device
    # gate planes)
    # ------------------------------------------------------------------
    def _matcher_names(
        self, template: Template, row_of, cache: dict[str, list[str]]
    ) -> list[str]:
        """Named matchers of ``template`` that fired on any of its rows
        — host confirm on demand, once per template."""
        if template.id not in cache:
            names: list[str] = []
            for row in row_of(template.id) or []:
                if row is not None:
                    names.extend(
                        cpu_ref.match_template(template, row).matcher_names
                    )
            cache[template.id] = sorted(set(names))
        return cache[template.id]

    def _eval_workflow(
        self, wf: Workflow, row_of, hit_ids: set, cache: dict
    ) -> set:
        matched: set = set()
        for step in wf.steps:
            triggers: list[Template] = []
            if step.template:
                t = self.index.by_path(step.template)
                if t:
                    triggers.append(t)
            for tag in step.tags:
                triggers.extend(self.index.by_tag.get(tag.lower(), []))
            for trigger in triggers:
                if trigger.id not in hit_ids:
                    continue
                if step.matchers:
                    fired = self._matcher_names(trigger, row_of, cache)
                    for gate in step.matchers:
                        if gate.name in fired:
                            for ref in gate.subtemplates:
                                matched |= self._eval_ref(ref, row_of, hit_ids, cache)
                elif step.subtemplates:
                    for ref in step.subtemplates:
                        matched |= self._eval_ref(ref, row_of, hit_ids, cache)
                else:
                    matched.add(trigger.id)
        return matched

    def _eval_ref(
        self, ref: SubtemplateRef, row_of, hit_ids: set, cache: dict
    ) -> set:
        matched: set = set()
        for t in self.index.resolve(ref):
            if t.id not in hit_ids:
                continue
            if ref.matchers:
                fired = self._matcher_names(t, row_of, cache)
                for gate in ref.matchers:
                    if gate.name in fired:
                        for sub in gate.subtemplates:
                            matched |= self._eval_ref(sub, row_of, hit_ids, cache)
            elif ref.subtemplates:
                for sub in ref.subtemplates:
                    matched |= self._eval_ref(sub, row_of, hit_ids, cache)
            else:
                matched.add(t.id)
        return matched

    # ------------------------------------------------------------------
    # nuclei automatic-scan mode: tech detection → wappalyzer tags
    # ------------------------------------------------------------------
    def auto_scan(self, rows: Sequence[Response]) -> list[dict]:
        """Per row: detected technologies (fired named matchers of
        'tech'-tagged templates), their mapped tags, and the matched
        template ids those tags select."""
        results = self.engine.match(rows)
        tech_templates = self.index.by_tag.get("tech", [])
        out = []
        for row, rm in zip(rows, results):
            hit_ids = set(rm.template_ids)
            cache: dict[str, list[str]] = {}
            techs: set[str] = set()
            for t in tech_templates:
                if t.id in hit_ids:
                    techs.update(
                        n.lower()
                        for n in self._matcher_names(t, lambda _tid, _r=row: [_r], cache)
                    )
            tags: set[str] = set()
            for tech in techs:
                tags.update(tag.lower() for tag in self.wappalyzer.get(tech, []))
                tags.add(tech)  # a tech name is itself a usable tag
            selected = {
                t.id
                for tag in tags
                for t in self.index.by_tag.get(tag, [])
                if t.id in hit_ids
            }
            out.append(
                {
                    "technologies": sorted(techs),
                    "tags": sorted(tags),
                    "template_ids": sorted(selected),
                }
            )
        return out
