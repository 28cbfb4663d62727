"""Benchmark sampler, the port's copy of ``swarm_tpu/benchmark.py``:
sample-size extrapolation for fleet A/B runs.

The math is the original swarm project's only measurement tool
(``experimental/benchmark.py:15-58``): given a target file and an
instance count, compute the per-instance batch size
(``total/instances/1.7``), a sample size, and the magnification factor,
then write a shuffled sample file, so a small scan's wall-clock can be
extrapolated to the full run (``sample_seconds × magnification``).

The sampler is importable (pure functions, deterministic with
``seed``), and the CLI also reports a device-throughput extrapolation
when given ``--rows-per-second`` (e.g. a scan's ``rows_per_second``
from ``/get-statuses``). It loads neither ``torch`` nor ``jax``. Run it
as ``python -m swarm_tpu_torch.benchmark <file> <instances>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
from typing import Optional, Sequence


@dataclasses.dataclass
class SamplePlan:
    total_lines: int
    instances: int
    batch_size: float
    sample_size: float
    magnification: float

    @property
    def lines_to_get(self) -> int:
        # the original samples 13× the sample size so per-chunk variance
        # averages out (benchmark.py:50)
        return int(self.sample_size * 13)

    def extrapolate(self, sample_seconds: float) -> float:
        """Full-run wall-clock estimate from a timed sample run."""
        return sample_seconds * self.magnification


def plan(total_lines: int, instances: int) -> SamplePlan:
    """The original math (benchmark.py:30-42), including its edge cases."""
    batch_size = int(total_lines / instances) / 1.7 if instances else 0.0
    if total_lines < instances:
        instances = total_lines
        batch_size = 1.0
        sample_size = 1.0
    elif batch_size > 1000:
        sample_size = batch_size / 150
    else:
        sample_size = batch_size / 7
    magnification = batch_size / sample_size if sample_size else 0.0
    return SamplePlan(
        total_lines=total_lines,
        instances=instances,
        batch_size=batch_size,
        sample_size=sample_size,
        magnification=magnification,
    )


def sample_lines(
    lines: Sequence[str], p: SamplePlan, seed: Optional[int] = None
) -> list[str]:
    shuffled = list(lines)
    random.Random(seed).shuffle(shuffled)
    return shuffled[: p.lines_to_get]


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="swarm-tpu benchmark sampler")
    parser.add_argument("input_file", help="input file containing targets")
    parser.add_argument("instances", type=int, help="number of instances")
    parser.add_argument("--out", default="sample.txt", help="sample output file")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--rows-per-second",
        type=float,
        default=None,
        help="measured pipeline throughput (rows_per_second from the scan "
        "rollup: rows / execute-phase wall-clock) for a full-run estimate",
    )
    args = parser.parse_args(argv)

    with open(args.input_file) as f:
        lines = f.readlines()
    p = plan(len(lines), args.instances)
    print(f"Total lines: {p.total_lines}")
    print(f"Batch size: {p.batch_size}")
    print(f"Sample size: {p.sample_size}")
    print(f"Magnification factor: {p.magnification}")
    with open(args.out, "w") as f:
        f.writelines(sample_lines(lines, p, seed=args.seed))
    print(f"Sample written to {args.out}")
    if args.rows_per_second:
        secs = p.total_lines / args.rows_per_second
        print(f"Estimated full-run execute time: {secs:.2f}s "
              f"at {args.rows_per_second:.0f} rows/s")


if __name__ == "__main__":
    main()
