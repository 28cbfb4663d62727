"""The port's file scanner (swarm_tpu_torch.worker.filescan) against the
JAX package's.

The reference tests' inline templates (an extension-gated
extractor-only template, an ``and`` audit with a negative word) and a
cut of ``chip_smoke``'s file job (``file_corpus(0)``, files over the
engine's 4,096-byte ``max_body`` that take the whole-row host redo,
plants past byte 4,096) through both packages' ``FileScanner``, the
port's engine on the CPU: equal findings and equal output bytes;
``scan_root`` confinement with symlinks as the reference confines.
"""

import dataclasses
import os
from pathlib import Path

import pytest
import torch

from swarm_tpu.fingerprints.nuclei import load_template_file as j_load_file
from swarm_tpu.fingerprints.nuclei import parse_template as j_parse
from swarm_tpu.worker import filescan as j_filescan
from swarm_tpu_torch.fingerprints.nuclei import load_template_file as t_load_file
from swarm_tpu_torch.fingerprints.nuclei import parse_template as t_parse
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.worker import filescan as t_filescan
from test_file_templates import INLINE_CONF_AUDIT, INLINE_PERLISH, _write


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, and engines of both packages that walk
    inline (``SWARM_WALK_THREADS=1``) unless a test sets their walk: six
    test processes share the host, and no result depends on either."""
    saved = torch.get_num_threads(), os.environ.get("SWARM_WALK_THREADS")
    torch.set_num_threads(1)
    os.environ["SWARM_WALK_THREADS"] = "1"
    yield
    torch.set_num_threads(saved[0])
    if saved[1] is None:
        os.environ.pop("SWARM_WALK_THREADS", None)
    else:
        os.environ["SWARM_WALK_THREADS"] = saved[1]


def scan_both(j_templates, t_templates, paths: list, **kw) -> tuple:
    j_scan = j_filescan.FileScanner(j_templates, **kw)
    t_scan = t_filescan.FileScanner(t_templates, device="cpu", **kw)
    j_found, j_stats = j_scan.scan_paths(paths)
    t_found, t_stats = t_scan.scan_paths(paths)
    assert [dataclasses.asdict(f) for f in t_found] == [dataclasses.asdict(f) for f in j_found]
    assert t_stats == j_stats
    assert t_filescan.format_findings(t_found) == j_filescan.format_findings(j_found)
    return t_found, t_stats, t_scan


def inline(tmp_path: Path) -> tuple:
    files = [_write(tmp_path, "t/perlish.yaml", INLINE_PERLISH),
             _write(tmp_path, "t/conf.yaml", INLINE_CONF_AUDIT)]
    return [j_load_file(f) for f in files], [t_load_file(f) for f in files]


def test_inline_templates_equal(tmp_path):
    j_templates, t_templates = inline(tmp_path)
    scan = tmp_path / "scan"
    _write(scan, "a.pl", "while(1) { eval $x; syscall }\n")
    _write(scan, "b.txt", "eval eval eval\n")
    _write(scan, "c.pm", "nothing suspicious\n")
    _write(scan, "router.conf", "interface g0\nconfigure terminal\n")
    _write(scan, "safe.conf", "configure terminal\nsafety off\n")
    _write(scan, "router.txt", "configure terminal\n")
    _write(scan, "big.conf", "x" * 6000 + "\nconfigure terminal\n")
    found, stats, scanner = scan_both(j_templates, t_templates,
                                      [str(scan), "", "# comment", str(scan / "a.pl")])
    assert {(f.template_id, Path(f.path).name) for f in found} == {
        ("perlish-scanner", "a.pl"), ("conf-audit", "router.conf"), ("conf-audit", "big.conf")}
    assert scanner.engine.stats.overflow_rows == 1  # big.conf: the host redo
    assert stats["extractor_only_templates"] == 1


def test_extractor_only_needs_no_engine(tmp_path):
    j_templates, t_templates = inline(tmp_path)
    _found, _stats, scanner = scan_both(j_templates[:1], t_templates[:1], [str(tmp_path / "t")])
    assert scanner.engine is None


@pytest.mark.parametrize("symlinks", [False, True])
def test_scan_root_confinement_equal(tmp_path, symlinks):
    j_templates, t_templates = inline(tmp_path)
    inside = tmp_path / "allowed"
    _write(tmp_path, "allowed/a.pl", "eval $x\n")
    outside = _write(tmp_path, "outside.pl", "eval $x\n")
    secret = _write(tmp_path, "secret/creds.pl", "eval $x\n")
    if symlinks:
        (inside / "link.pl").symlink_to(secret)
        (inside / "dirlink").symlink_to(tmp_path / "secret")
    found, _stats, _scanner = scan_both(j_templates, t_templates, [str(inside), str(outside)],
                                        scan_root=str(inside))
    assert {Path(f.path).name for f in found} == {"a.pl"}


def test_file_corpus_cut_equal(tmp_path):
    """``chip_smoke``'s file job cut to 96 files: the corpus of the
    reference's recorded shape, long files and late plants."""
    from chip_smoke import file_corpus, write_file_tree

    docs, plants = file_corpus(0)
    counts = write_file_tree(tmp_path / "files", 96, plants)
    assert counts["long"] and counts["planted"]
    found, stats, scanner = scan_both([j_parse(d) for d in docs], [t_parse(d) for d in docs],
                                      [str(tmp_path / "files")],
                                      scan_root=str(tmp_path / "files"))
    assert stats["files_scanned"] == 96
    assert scanner.engine.stats.overflow_rows == counts["long"]
    assert {f.template_id for f in found} & {d["id"] for d in docs[:10]}  # extractor-only
    assert len({f.template_id for f in found}) >= 5


def test_engine_is_the_one_given(tmp_path):
    _j, t_templates = inline(tmp_path)
    engine = MatchEngine([t_templates[1]], device="cpu")
    assert t_filescan.FileScanner(t_templates, engine=engine).engine is engine
    assert t_filescan.DEFAULT_MAX_FILE_SIZE == j_filescan.DEFAULT_MAX_FILE_SIZE
