"""The benchmark sampler of the port (``swarm_tpu_torch/benchmark.py``)
against the JAX package's (``swarm_tpu/benchmark.py``), on the CPU.

- the six cases of ``tests/test_benchmark_sampler.py`` on the port;
- ``plan`` over a spread of ``(total_lines, instances)``, the edge
  cases among them, equal field for field;
- ``sample_lines`` under one seed equal line for line;
- ``main``'s printed plan and its sample file equal byte for byte.

Everything compared is numbers or bytes: tolerance 0.
"""

import contextlib
import dataclasses
import io

import pytest

import swarm_tpu.benchmark as j_benchmark
from swarm_tpu_torch.benchmark import main, plan, sample_lines

from test_torch_server import one_torch_thread  # noqa: F401


def test_plan_reference_math_large():
    # 100k lines / 10 instances: batch = 10000/1.7, sample = batch/150
    p = plan(100_000, 10)
    assert p.batch_size == int(100_000 / 10) / 1.7
    assert p.batch_size > 1000
    assert p.sample_size == p.batch_size / 150
    assert p.magnification == p.batch_size / p.sample_size


def test_plan_reference_math_small():
    p = plan(1000, 10)  # batch ≈ 58.8 → sample = batch/7
    assert p.batch_size <= 1000
    assert p.sample_size == p.batch_size / 7
    assert abs(p.magnification - 7.0) < 1e-9


def test_plan_fewer_lines_than_instances():
    p = plan(3, 10)
    assert p.instances == 3
    assert p.batch_size == 1 and p.sample_size == 1
    assert p.magnification == 1.0


def test_sample_deterministic_with_seed():
    lines = [f"host{i}.example\n" for i in range(1000)]
    p = plan(len(lines), 10)
    s1 = sample_lines(lines, p, seed=42)
    s2 = sample_lines(lines, p, seed=42)
    assert s1 == s2
    assert len(s1) == p.lines_to_get
    assert set(s1) <= set(lines)


def test_extrapolation():
    p = plan(100_000, 10)
    assert abs(p.extrapolate(10.0) - 10.0 * p.magnification) < 1e-9


def test_cli_writes_sample(tmp_path, capsys):
    inp = tmp_path / "targets.txt"
    inp.write_text("".join(f"h{i}.example\n" for i in range(500)))
    out = tmp_path / "sample.txt"
    main([str(inp), "5", "--out", str(out), "--seed", "1", "--rows-per-second", "1000"])
    captured = capsys.readouterr().out
    assert "Magnification factor:" in captured
    assert "Estimated full-run execute time: 0.50s" in captured
    assert out.read_text().strip()


#: (total_lines, instances): zero, one and many instances, fewer lines
#: than instances, the batch of 1,000 either side, the smoke's 2,048 / 8
SPREAD = [(0, 0), (0, 3), (1, 1), (3, 10), (7, 7), (10, 0), (1000, 10), (1700, 1),
          (1701, 1), (2048, 8), (17_000, 10), (17_017, 10), (100_000, 10), (999_999, 7),
          (5_000_000, 64)]


@pytest.mark.parametrize("total, instances", SPREAD)
def test_plan_equals_jax(total, instances):
    mine, theirs = plan(total, instances), j_benchmark.plan(total, instances)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.lines_to_get == theirs.lines_to_get
    assert mine.extrapolate(12.5) == theirs.extrapolate(12.5)


@pytest.mark.parametrize("seed", [None, 0, 1, 42, 2**31 - 1])
def test_sample_lines_equal_jax(seed):
    lines = [f"10.{i // 65536}.{i // 256 % 256}.{i % 256}\n" for i in range(3000)]
    p = plan(len(lines), 4)
    if seed is None:  # an unseeded shuffle: the size and the set
        a, b = sample_lines(lines, p), j_benchmark.sample_lines(lines, p)
        assert len(a) == len(b) == p.lines_to_get and set(a) <= set(lines)
        return
    assert sample_lines(lines, p, seed=seed) == j_benchmark.sample_lines(lines, p, seed=seed)


@pytest.mark.parametrize("argv", [["8"], ["8", "--seed", "5", "--rows-per-second", "1234.5"],
                                  ["3000", "--seed", "2"], ["1", "--seed", "9"]])
def test_main_equals_jax(argv, tmp_path):
    """The printed plan (with the sample file's path written the same)
    and the sample file, byte for byte."""
    inp = tmp_path / "targets.txt"
    inp.write_text("".join(f"h{i}.example\n" for i in range(2048)))
    printed, written = {}, {}
    for name, fn in (("port", main), ("jax", j_benchmark.main)):
        out = tmp_path / f"{name}.txt"
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            fn([str(inp), argv[0], "--out", str(out)] + argv[1:])
        printed[name] = buf.getvalue().replace(str(out), "OUT")
        written[name] = out.read_bytes()
    assert printed["port"] == printed["jax"] and printed["port"].startswith(
        "Total lines: 2048\n")
    if "--seed" in argv:
        assert written["port"] == written["jax"]
    assert len(written["port"].splitlines()) == plan(2048, int(argv[0])).lines_to_get
