"""Streaming probe→device pipeline: double-buffered waves (the port of
``swarm_tpu/worker/streaming.py``).

BASELINE.json config #4 is a masscan-style stream — targets flow in,
banners flow to the device, verdicts flow out — where neither side may
idle: the native epoll front-end (which releases the GIL for the whole
scan call) probes wave *i+1* while the device matches wave *i*.

The unit of overlap is a **wave** of targets. A bounded queue provides
the double buffer: depth 1 means the producer is at most one wave
ahead, so memory stays at two waves of rows regardless of input size.
Results preserve input wave order (the consumer drains in FIFO), so the
streamed output is byte-identical to the sequential path.

The reference's analog is tool-internal concurrency plus unix pipes
(``dnsx | httpx`` in worker/modules/web.json — SURVEY.md §2.4
"pipeline parallelism"); here the pipe crosses the host/device boundary.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence


@dataclasses.dataclass
class StreamStats:
    waves: int = 0
    rows: int = 0
    probe_seconds: float = 0.0  # producer busy time
    match_seconds: float = 0.0  # consumer busy time
    wall_seconds: float = 0.0

    @property
    def overlap_seconds(self) -> float:
        """Time saved vs running the two stages back to back."""
        return max(0.0, self.probe_seconds + self.match_seconds - self.wall_seconds)


class StreamingPipeline:
    """Drive ``probe(wave) -> rows`` and ``consume(rows) -> out`` as a
    two-stage pipeline over waves of targets.

    ``probe`` runs on a producer thread (native scan I/O releases the
    GIL, so probing genuinely overlaps device work on the main thread).
    ``consume`` runs on the caller's thread and sees waves in submission
    order. Exceptions on either side propagate to the caller.

    Every torch call and kernel launch stays in ``consume``, on the
    caller's thread: torch keeps the current device and stream per
    thread, so a ``probe`` that ever touched the card would have to set
    both on the producer thread first.
    """

    def __init__(
        self,
        probe: Callable[[Sequence[str]], object],
        consume: Callable[[object], object],
        wave_targets: int = 1024,
        queue_depth: int = 1,
    ):
        self.probe = probe
        self.consume = consume
        self.wave_targets = max(1, int(wave_targets))
        self.queue_depth = max(1, int(queue_depth))
        self.stats = StreamStats()

    def run(self, target_lines: Sequence[str]) -> list[object]:
        return list(self.iter_results(target_lines))

    def iter_results(self, target_lines: Sequence[str]) -> Iterator[object]:
        lines = list(target_lines)
        waves = [
            lines[i : i + self.wave_targets]
            for i in range(0, len(lines), self.wave_targets)
        ] or [[]]
        q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        error: list[BaseException] = []
        stop = threading.Event()
        t_start = time.perf_counter()

        def put(item) -> None:
            # blocks at queue_depth (bounded lookahead) but stays
            # interruptible so a dead consumer can't strand the thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer() -> None:
            try:
                for wave in waves:
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    rows = self.probe(wave)
                    self.stats.probe_seconds += time.perf_counter() - t0
                    put(rows)
            except BaseException as e:  # propagate through the queue
                error.append(e)
            finally:
                put(_DONE)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                rows = q.get()
                if rows is _DONE:
                    break
                t0 = time.perf_counter()
                out = self.consume(rows)
                self.stats.match_seconds += time.perf_counter() - t0
                self.stats.waves += 1
                try:
                    self.stats.rows += len(rows)  # type: ignore[arg-type]
                except TypeError:
                    pass
                yield out
        finally:
            stop.set()
            thread.join()
            self.stats.wall_seconds = time.perf_counter() - t_start
        if error:
            raise error[0]


_DONE = object()


def stream_match(
    engine,
    target_lines: Sequence[str],
    probe_spec: Optional[dict] = None,
    wave_targets: int = 1024,
) -> tuple[list, list, StreamStats]:
    """targets → (rows, per-row match results, stats), streamed.

    The worker's targets-mode device path: ProbeExecutor waves feed
    MatchEngine batches with probe/match overlap. Output is identical
    to ``engine.match(executor.run(lines))`` run sequentially.
    """
    from swarm_tpu_torch.worker.executor import ProbeExecutor

    executor = ProbeExecutor(probe_spec)
    pipeline = StreamingPipeline(
        probe=executor.run,
        consume=lambda rows: (rows, engine.match(rows)),
        wave_targets=wave_targets,
    )
    all_rows: list = []
    all_results: list = []
    for rows, results in pipeline.run(target_lines):
        all_rows.extend(rows)
        all_results.extend(results)
    return all_rows, all_results, pipeline.stats
