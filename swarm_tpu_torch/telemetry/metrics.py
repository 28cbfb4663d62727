"""Process-wide metrics registry with Prometheus text exposition, the
port of ``swarm_tpu/telemetry/metrics.py``.

The registry is the measurement substrate the port's layers report
through: the worker's phase histograms and job counters, the
scheduler's feed families, the resilience counters, and the match
engine's counters (registered as a *collector*, so a scrape never
touches the engine's hot path). The JAX server and its scrapers read
the families by name, so names, kinds, help strings, label names and
buckets are the reference's.

Implemented against the stdlib only: three metric kinds —
:class:`Counter`, :class:`Gauge`, :class:`Histogram` (fixed buckets) —
all labeled, all thread-safe, rendered in the Prometheus text format
0.0.4 that scrapers parse.

Usage::

    from swarm_tpu_torch.telemetry import REGISTRY

    REQS = REGISTRY.counter("swarm_http_requests_total",
                            "HTTP requests", ("route", "code"))
    REQS.labels(route="/queue", code="200").inc()
    print(REGISTRY.render())
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default histogram buckets — tuned for request/phase latencies in
#: seconds (5 ms … 60 s); callers with other shapes pass their own.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0,
)

#: Exemplar rendering gate. Histograms
#: can carry the trace ID of their worst recent observation, rendered
#: in the OpenMetrics-style ``# {trace_id="..."} <value>`` suffix on
#: the ``+Inf`` bucket line — but ONLY when this env var is truthy,
#: because the strict 0.0.4 text format (and this module's own
#: ``parse_exposition``) rejects exemplar suffixes. Default off keeps
#: every existing scraper green; opt in for OpenMetrics-aware backends.
EXEMPLARS_ENV = "SWARM_METRICS_EXEMPLARS"

#: Exemplar replacement policy: a stored exemplar survives until a
#: worse (larger) observation arrives or it ages past this horizon —
#: "worst RECENT observation", so a single historic spike doesn't pin
#: the exemplar forever.
EXEMPLAR_MAX_AGE_S = 60.0


def exemplars_enabled() -> bool:
    return os.environ.get(EXEMPLARS_ENV, "").strip().lower() in (
        "1", "true", "yes", "on"
    )


def escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    """Render a sample value: integers without the trailing .0 (cosmetic
    but matches common exporters), +Inf/NaN spelled the Prometheus way."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    """Shared labeled-family plumbing. Child state lives in ``_data``
    keyed by the label-value tuple; subclasses define what a child's
    state is and how it renders."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        # writes only — the unlabeled () child is created here and read
        # lock-free (the key is never removed)
        self._data: dict[tuple, object] = {}  # guarded-by: _lock
        if not self.labelnames:
            self._data[()] = self._new_child()

    # -- subclass surface ---------------------------------------------
    def _new_child(self):
        raise NotImplementedError

    def _render_child(self, label_values: tuple, child) -> Iterable[str]:
        raise NotImplementedError

    def _observe_exemplar(self, child, label_values, value, trace_id) -> None:
        # only histograms keep exemplars; for other kinds this defers
        # to _observe, which raises the usual kind mismatch
        self._observe(child, value)

    # -----------------------------------------------------------------
    def labels(self, *values, **kw) -> "_Handle":
        if kw:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            try:
                values = tuple(str(kw[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e.args[0]!r} for {self.name}")
            if len(kw) != len(self.labelnames):
                raise ValueError(f"unexpected labels for {self.name}: {kw}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {values}"
            )
        with self._lock:
            child = self._data.get(values)
            if child is None:
                child = self._data[values] = self._new_child()
        return _Handle(self, values, child)

    def _unlabeled(self) -> "_Handle":
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        return _Handle(self, (), self._data[()])

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        # child STATE is copied under the lock, not just the item list:
        # a concurrent observe() racing a lock-free read of a live
        # histogram child could expose a torn (non-monotonic) series
        with self._lock:
            items = [(lv, list(child)) for lv, child in self._data.items()]
        for label_values, child in sorted(items, key=lambda kv: kv[0]):
            lines.extend(self._render_child(label_values, child))
        return lines

    def snapshot(self) -> dict:
        """JSON-able view (the CLI table)."""
        with self._lock:
            items = [(lv, list(child)) for lv, child in self._data.items()]
        samples = []
        for label_values, child in sorted(items, key=lambda kv: kv[0]):
            samples.append(
                {
                    "labels": dict(zip(self.labelnames, label_values)),
                    "value": self._child_value(child),
                }
            )
        return {
            "name": self.name,
            "type": self.kind,
            "help": self.help,
            "samples": samples,
        }

    def _child_value(self, child):
        raise NotImplementedError


class _Handle:
    """A (metric, label-values) pair — what callers inc/set/observe on."""

    __slots__ = ("_metric", "_label_values", "_child")

    def __init__(self, metric: _Metric, label_values: tuple, child):
        self._metric = metric
        self._label_values = label_values
        self._child = child

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._child, amount)

    def set(self, value: float) -> None:
        self._metric._set(self._child, value)

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        if trace_id is None:
            self._metric._observe(self._child, value)
        else:
            self._metric._observe_exemplar(
                self._child, self._label_values, value, trace_id
            )

    @property
    def value(self):
        return self._metric._child_value(self._child)


class Counter(_Metric):
    """Monotonically increasing count. ``inc()`` only."""

    kind = "counter"

    def _new_child(self):
        return [0.0]

    def _inc(self, child, amount: float) -> None:
        if amount < 0:
            raise ValueError("counters cannot decrease")
        with self._lock:
            child[0] += amount

    def _set(self, child, value) -> None:
        raise TypeError(f"{self.name} is a counter; use inc()")

    _observe = _set

    def _child_value(self, child):
        return child[0]

    def _render_child(self, label_values, child):
        yield (
            f"{self.name}{_labels_str(self.labelnames, label_values)} "
            f"{_fmt_value(child[0])}"
        )

    # convenience for the unlabeled family
    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)


class Gauge(_Metric):
    """A value that goes up and down. ``set()`` / ``inc()``."""

    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def _inc(self, child, amount: float) -> None:
        with self._lock:
            child[0] += amount

    def _set(self, child, value: float) -> None:
        with self._lock:
            child[0] = float(value)

    def _observe(self, child, value) -> None:
        raise TypeError(f"{self.name} is a gauge; use set()/inc()")

    def _child_value(self, child):
        return child[0]

    def _render_child(self, label_values, child):
        yield (
            f"{self.name}{_labels_str(self.labelnames, label_values)} "
            f"{_fmt_value(child[0])}"
        )

    def set(self, value: float) -> None:
        self._unlabeled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative ``_bucket{le=...}`` counts
    plus ``_sum`` and ``_count``, the shape Prometheus quantile queries
    expect. ``observe()`` only."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        if bounds != sorted(set(bounds)):
            raise ValueError("duplicate histogram buckets")
        self.buckets = tuple(bounds)
        super().__init__(name, help_text, labelnames)
        # label-values → (observed value, trace_id, wall ts): the worst
        # recent observation per series, rendered as an exemplar suffix
        # when SWARM_METRICS_EXEMPLARS is set
        self._exemplars: dict[tuple, tuple] = {}  # guarded-by: _lock

    def _new_child(self):
        # [per-bucket counts..., count, sum]
        return [0] * len(self.buckets) + [0, 0.0]

    def _observe(self, child, value: float) -> None:
        value = float(value)
        with self._lock:
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child[i] += 1
                    break
            child[-2] += 1
            child[-1] += value

    def _observe_exemplar(self, child, label_values, value, trace_id) -> None:
        value = float(value)
        now = time.time()
        with self._lock:
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child[i] += 1
                    break
            child[-2] += 1
            child[-1] += value
            cur = self._exemplars.get(label_values)
            if (
                cur is None
                or value >= cur[0]
                or now - cur[2] > EXEMPLAR_MAX_AGE_S
            ):
                self._exemplars[label_values] = (value, str(trace_id), now)

    def _inc(self, child, amount) -> None:
        raise TypeError(f"{self.name} is a histogram; use observe()")

    _set = _inc

    def _child_value(self, child):
        n = child[-2]
        return {
            "count": n,
            "sum": child[-1],
            "buckets": {
                _fmt_value(b): int(sum(child[: i + 1]))
                for i, b in enumerate(self.buckets)
            },
        }

    def _render_child(self, label_values, child):
        cumulative = 0
        for i, bound in enumerate(self.buckets):
            cumulative += child[i]
            lv = label_values + (_fmt_value(bound),)
            ln = self.labelnames + ("le",)
            yield f"{self.name}_bucket{_labels_str(ln, lv)} {cumulative}"
        lv = label_values + ("+Inf",)
        ln = self.labelnames + ("le",)
        inf_line = f"{self.name}_bucket{_labels_str(ln, lv)} {child[-2]}"
        if exemplars_enabled():
            # render() calls this OUTSIDE self._lock (child is a copy),
            # so a brief re-acquire for the exemplar read is safe
            with self._lock:
                ex = self._exemplars.get(label_values)
            if ex is not None:
                inf_line += (
                    f' # {{trace_id="{escape_label_value(ex[1])}"}}'
                    f" {_fmt_value(ex[0])}"
                )
        yield inf_line
        base = _labels_str(self.labelnames, label_values)
        yield f"{self.name}_sum{base} {_fmt_value(child[-1])}"
        yield f"{self.name}_count{base} {child[-2]}"


class MetricsRegistry:
    """Thread-safe name → metric table plus scrape-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create: the second
    caller with the same name gets the SAME family (so the server and a
    test can both reach ``swarm_queue_depth``), and a kind/label
    mismatch on an existing name raises instead of silently forking.

    Collectors are callables run at the top of every ``render()`` /
    ``snapshot()`` — the hook scrape-time state flows through (queue
    depth read from the state store, engine stats copied from
    ``EngineStats``) without any cost on the instrumented hot paths.
    """

    def __init__(self):
        self._lock = threading.RLock()  # guards: _metrics (reads), _collectors (reads)
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    # -- factories ----------------------------------------------------
    def _get_or_create(self, cls, name, help_text, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}"
                    )
                return existing
            metric = cls(name, help_text, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help_text: str = "", labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(
        self, name: str, help_text: str = "", labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, labelnames, buckets=buckets
        )

    # -- collectors ---------------------------------------------------
    def add_collector(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Register a scrape-time callback (returns it, decorator-style)."""
        with self._lock:
            self._collectors.append(fn)
        return fn

    def remove_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                # a broken collector must never take down the scrape
                pass

    # -- exposition ---------------------------------------------------
    def render(self) -> str:
        """Prometheus text format 0.0.4 (the ``/metrics`` body)."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.render())
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        """JSON-able {name: family snapshot} (what the CLI renders as a
        table)."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {m.name: m.snapshot() for m in metrics}

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)


# ---------------------------------------------------------------------------
# Exposition parsing — the scrape side (``swarm metrics``).
# Strict: a malformed line raises ValueError
# with its line number, which is exactly what the preflight check wants.
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>-?[0-9]+))?$"
)
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"\s*(?:,|$)'
)


def _unescape_label_value(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """Parse Prometheus text format into ``(name, labels, value)`` rows.

    Raises ``ValueError`` (with the offending line number) on any line
    that is neither a comment, blank, nor a well-formed sample — the
    contract a preflight check of an exposition wants.
    """
    samples: list[tuple[str, dict, float]] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                if len(parts) < 3:
                    raise ValueError(f"line {lineno}: malformed {parts[1]} comment")
                if parts[1] == "TYPE" and (
                    len(parts) < 4
                    or parts[3] not in (
                        "counter", "gauge", "histogram", "summary", "untyped"
                    )
                ):
                    raise ValueError(f"line {lineno}: bad TYPE: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        labels: dict = {}
        raw = m.group("labels")
        if raw:
            pos = 0
            while pos < len(raw):
                lm = _LABEL_PAIR_RE.match(raw, pos)
                if not lm:
                    raise ValueError(
                        f"line {lineno}: malformed labels: {raw!r}"
                    )
                labels[lm.group("name")] = _unescape_label_value(
                    lm.group("value")
                )
                pos = lm.end()
        val = m.group("value")
        try:
            value = float(
                {"+Inf": "inf", "-Inf": "-inf", "NaN": "nan"}.get(val, val)
            )
        except ValueError:
            raise ValueError(f"line {lineno}: bad value {val!r}")
        samples.append((m.group("name"), labels, value))
    return samples


#: The process-wide default registry every layer instruments against.
REGISTRY = MetricsRegistry()

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
