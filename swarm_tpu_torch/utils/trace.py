"""Phase timing and device profiling of a job, the port of
``swarm_tpu/utils/trace.py``.

- :class:`PhaseTimer` — wall-clock per pipeline phase
  (download/execute/upload), reported to the server inside the job's
  ``perf`` field on completion and aggregated into the per-scan rollup
  (``rows_per_second`` etc. in ``/get-statuses``).
- :func:`maybe_device_profile` — wraps a block in a ``torch.profiler``
  trace (a Chrome trace: the host's ``record_function`` spans and, on a
  CUDA device, the card's kernels and copies) when
  ``SWARM_PROFILE_DIR`` is set; free when it is not. On the card a
  trace that does not name every kernel the block launched is kept as
  lost and reported, never taken for the block's profile.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Iterator, Optional

PROFILE_ENV = "SWARM_PROFILE_DIR"


class PhaseTimer:
    """Accumulates named wall-clock phases → a flat perf dict.

    Thread-safe: worker sessions tick phases from the streaming thread
    while the telemetry scraper snapshots mid-job, so every mutation
    holds the lock and :meth:`snapshot` hands out copies.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()  # guards: seconds, counters
        self.seconds: dict[str, float] = {}
        self.counters: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt

    def count(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def snapshot(self) -> tuple[dict[str, float], dict[str, float]]:
        """Point-in-time ``(seconds, counters)`` copies — never mutates,
        safe to call from any thread mid-job."""
        with self._lock:
            return dict(self.seconds), dict(self.counters)

    def perf(self) -> dict:
        seconds, counters = self.snapshot()
        out: dict = {f"{k}_s": round(v, 6) for k, v in seconds.items()}
        for k, v in counters.items():
            out[k] = int(v) if float(v).is_integer() else v
        return out


class ProfileError(RuntimeError):
    """A device profile that does not hold the card's work of its block."""


def kernel_symbol(name: str) -> str:
    """A kernel event's function name without its namespaces, template
    arguments, parameters or return type
    (``(anonymous namespace)::match_regex_scan_kernel<3>(Variants, …)``
    → ``match_regex_scan_kernel``)."""
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0), default=len(name))
    return name[:cut].rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def profiled_symbols(trace_path: str) -> set:
    """The :func:`kernel_symbol` of each of the card's kernel events in
    a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return {
        kernel_symbol(e["name"])
        for e in events
        if e.get("cat") == "kernel" and e.get("name")
    }


def check_profile(trace_path: str, launched: dict, symbols: dict) -> None:
    """Raise :class:`ProfileError` unless the trace at ``trace_path``
    names every ``__global__`` function (``symbols[wrapper]``) of each
    wrapper that ``launched`` counts a launch of."""
    found = profiled_symbols(trace_path)
    missing = sorted(
        sym
        for name, n in launched.items()
        if n
        for sym in symbols[name]
        if sym not in found
    )
    if missing:
        raise ProfileError(
            f"the profile {trace_path} holds no device event of {missing}, "
            f"though the block launched {sorted(k for k, n in launched.items() if n)}"
        )


@contextlib.contextmanager
def maybe_device_profile(
    tag: str, profile_dir: Optional[str] = None, device=None,
    on_lost: Optional[Callable[[ProfileError], None]] = None,
) -> Iterator[bool]:
    """``torch.profiler`` trace around the block when profiling is on.

    ``profile_dir`` defaults to ``$SWARM_PROFILE_DIR``; yields whether a
    trace is recorded. The CPU activity is always traced, the CUDA
    activity when ``device`` is a CUDA device. On a clean exit the trace
    lands in ``<dir>/<tag>/trace_<ns>.json`` (Chrome trace format). A
    profiler that cannot start or export raises. A CUDA trace that lacks
    a kernel the block launched through ``ops.kernels`` is lost: it is
    kept as ``trace_<ns>.lost.json``, so that no reader takes it for the
    block's profile, and its :class:`ProfileError` goes to ``on_lost``,
    or is raised when ``on_lost`` is None. The block's own work stands
    either way: the loss is the profiler's."""
    root = profile_dir if profile_dir is not None else os.environ.get(PROFILE_ENV)
    if not root:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from swarm_tpu_torch.ops import kernels

    target = os.path.join(root, tag)
    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    before = dict(kernels.LAUNCHES)
    with profile(activities=activities) as prof:
        yield True
        if on_card:
            # the card's queued work belongs to the block's trace
            torch.cuda.synchronize(device)
    path = os.path.join(target, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    # a wrapper counts only its kernel's launches on the card: a block
    # on the CPU launched nothing, and its trace misses nothing
    launched = {k: n - before.get(k, 0) for k, n in kernels.LAUNCHES.items()}
    try:
        check_profile(path, launched, kernels.SYMBOLS)
    except ProfileError as e:
        lost = path[: -len(".json")] + ".lost.json"
        os.replace(path, lost)
        err = ProfileError(f"{e}; kept as {lost}")
        if on_lost is None:
            raise err from None
        on_lost(err)
