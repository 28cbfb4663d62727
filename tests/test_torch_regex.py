"""The device regex scan of the port (swarm_tpu_torch) against the JAX
package, and the staged scan that kernel ``match_regex_scan`` runs.

Every comparison is exact: the values are bools. The kernel
(``ops/csrc/match.cu``) stages, a piece of ``PIECE`` positions at a
time, everything of a position that does not depend on the shift-and
state (its class words A, its seed term S, its self-loop term T and its
end-rule mask E), and then runs the recurrence d' = (shift(d) & A) |
((d & T) | S), the closure rounds, and acc |= d & E. :func:`staged_scan`
walks that design in numpy, and is held here to the JAX
``regex_verify`` through the port's ``regex_verify`` (the walk put in
the kernel's place), beside the port's plain version.

The corpora (``chip_smoke.regex_docs``, which the card run shares) are
written by hand so that their sequences take 1, 2 and 3
state lanes and skip runs above 0 (``r_closure``), with anchors, ``$``
and ``\\Z`` (a trailing newline too) and a leading and trailing ``\\b`` at
the stream's start and end; the rows put matches and near misses at
lengths 0 and 1, across a piece's edge and at the stream's full width.
On the card the tests marked ``cuda`` hold the kernel to its plain
version on the same calls.
"""

import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import swarm_tpu.fingerprints.compile as j_compile
import swarm_tpu.fingerprints.nuclei as j_nuclei
from chip_smoke import REGEX_PIECE as PIECE
from chip_smoke import regex_docs, regex_pair_lengths, regex_rows
from swarm_tpu.ops.regexdev import regex_verify as j_regex_verify
from swarm_tpu_torch.fingerprints import compile as t_compile
from swarm_tpu_torch.fingerprints import nuclei as t_nuclei
from swarm_tpu_torch.fingerprints.regexlin import END_DOLLAR, END_NONE, END_Z
from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.ops import match as tm
from swarm_tpu_torch.ops import regexdev as t_regexdev
from test_torch_match import Corpus, jax_tree, phase_inputs, slot_bits


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


MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Corpora and rows


def corpus(lanes: int) -> Corpus:
    docs = regex_docs(lanes)
    return Corpus([j_nuclei.parse_template(d) for d in docs],
                  [t_nuclei.parse_template(d) for d in docs])


@pytest.fixture(scope="module")
def corpora():
    return {lanes: corpus(lanes) for lanes in (1, 2, 3)}


@pytest.fixture(scope="module")
def inputs(corpora):
    """Per corpus: the batch through both packages (phase_inputs) and
    its slot bits, the gate of the regex pairs."""
    out = {}
    for lanes, c in corpora.items():
        p = phase_inputs(c, regex_rows())
        out[lanes] = (p, slot_bits(c, p))
    return out


# ---------------------------------------------------------------------------
# The staged scan, walked in numpy


def staged_scan(variants: list, pair_b, pair_s, valid, rx: dict, word_tab, r_closure: int):
    """The kernel's design, vectorized over the pairs: per piece of
    PIECE positions, each position's A, S, T and E from its byte alone
    (and its neighbours' wordness), then the recurrence over the piece.
    Same contract as kernel ``match_regex_scan`` → matched bool [K]."""
    pair_b, pair_s = pair_b.numpy(), pair_s.numpy()
    valid = valid.numpy()
    K = len(pair_b)
    word = word_tab.numpy()
    lens = np.stack([v.lengths.numpy() for v in variants], 1).astype(np.int64)
    var = rx["var_of_seq"].numpy().astype(np.int64)[pair_s]
    n = lens[pair_b, var]  # [K]
    span = max([int(v.data.shape[1]) for v in variants] + [int(n.max(initial=0))])
    data = np.zeros((K, span), dtype=np.int64)
    for k in range(K):
        v = variants[var[k]]
        row = v.data[pair_b[k]].numpy().astype(np.int64)
        if v.lowered:
            row = np.where((row >= 65) & (row <= 90), row + 32, row)
        data[k, : len(row)] = row
    bytemap = rx["bytemap"].numpy().astype(np.int64) & MASK32  # [NSEQ, 256, L]
    L = bytemap.shape[2]

    def lanes_of(key):
        return rx[key].numpy().astype(np.int64)[pair_s] & MASK32  # [K, L]

    seed, skip, accept, sloop = (lanes_of(k) for k in ("seed", "skip", "accept", "self"))
    anchored = rx["anchored"].numpy()[pair_s][:, None]
    end_mode = rx["end_mode"].numpy()[pair_s]
    start_wb = rx["start_wb"].numpy()[pair_s][:, None]
    end_wb = rx["end_wb"].numpy()[pair_s][:, None]
    # position-only terms, as the warp stages them
    pos = np.arange(span)[None, :]
    w = word[data]
    w_prev = np.pad(w[:, :-1], ((0, 0), (1, 0)))
    w_next = np.pad(w[:, 1:], ((0, 0), (0, 1)))
    trail_nl = (n > 0) & (data[np.arange(K), np.clip(n - 1, 0, span - 1)] == 0x0A)
    end_lo = np.where(end_mode == END_NONE, 0,
                      np.where((end_mode == END_DOLLAR) & trail_nl, n - 2, n - 1))
    assert set(np.unique(end_mode)) <= {END_NONE, END_Z, END_DOLLAR}
    s_ok = (~anchored | (pos == 0)) & (~start_wb | (w != w_prev))
    e_ok = np.where(end_wb, np.where(pos + 1 < n[:, None], w != w_next, w),
                    pos >= end_lo[:, None])
    E = np.where((pos < n[:, None]) & e_ok, MASK32, 0)[:, :, None]  # [K, span, 1]
    A = bytemap[pair_s[:, None], data]  # [K, span, L]
    S = np.where(s_ok[:, :, None], seed[:, None, :] & A, 0)
    T = sloop[:, None, :] & A

    def shift(d):
        carry = np.pad(d[:, :-1] >> 31, ((0, 0), (1, 0)))
        return ((d << 1) & MASK32) | carry

    d = np.zeros((K, L), dtype=np.int64)
    acc = np.zeros((K, L), dtype=np.int64)
    for p0 in range(0, int(n.max(initial=0)), PIECE):
        for i in range(p0, min(p0 + PIECE, span)):
            d = (shift(d) & A[:, i]) | ((d & T[:, i]) | S[:, i])
            for _ in range(r_closure):
                d = d | (shift(d) & skip)
            acc = acc | (d & E[:, i])
    matched = ((acc & accept) != 0).any(1) & valid
    return torch.from_numpy(matched)


def recorded_scan(c: Corpus, p: dict, value, k: int):
    """The port's ``regex_verify`` on the batch, with its one
    ``match_regex_scan`` call recorded → (rx_value, rx_unc, args)."""
    rx_t = tm.to_device(t_compile.rx_arrays_np(c.t_db), torch.device("cpu"))
    word_tab = torch.from_numpy(tm._word_table())
    with kernels.record_calls() as calls:
        tv, tu = t_regexdev.regex_verify(c.t_db, p["ts"], p["tl"], value, k, rx_t, word_tab)
    (args,) = [a for name, a in calls if name == "match_regex_scan"]
    return tv, tu, args


_j_verify = {}


def jax_verify(c: Corpus, p: dict, value, k: int):
    key = (id(c.j_db), k)
    if key not in _j_verify:
        db = c.j_db
        _j_verify[key] = jax.jit(
            lambda s, ln, v, a: j_regex_verify(db, s, ln, v, k_pairs=k, arrays=a))
    jv, ju = _j_verify[key](p["js"], p["jl"], np.asarray(value),
                            jax_tree(j_compile.rx_arrays_np(c.j_db)))
    return np.asarray(jv), np.asarray(ju)


# ---------------------------------------------------------------------------
# Tests


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_corpus_takes_its_lanes_and_skip_runs(corpora, lanes):
    db = corpora[lanes].t_db
    # every pattern runs on the card, in the lanes it was written for
    assert len(db.rx_m_ids) == len(regex_docs(lanes))
    assert db.rx_bytemap.shape[2] == lanes
    assert db.rx_max_skip_run == 4
    assert db.rx_anchored.any() and db.rx_start_wb.any() and db.rx_end_wb.any()
    assert set(db.rx_end_mode.tolist()) == {END_NONE, END_Z, END_DOLLAR}
    assert db.rx_seq_ci.any() and not db.rx_seq_ci.all()
    assert np.array_equal(db.rx_bytemap, corpora[lanes].j_db.rx_bytemap)


@pytest.mark.parametrize("k_pairs", [None, 5])
@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_staged_scan_equals_jax_regex_verify(corpora, inputs, monkeypatch, lanes, k_pairs):
    c = corpora[lanes]
    p, value = inputs[lanes]
    k = k_pairs or c.t_db.rx_k_pairs(value.shape[0])
    tv, tu, args = recorded_scan(c, p, value, k)
    jv, ju = jax_verify(c, p, value.numpy(), k)
    assert np.array_equal(tv.numpy(), jv) and np.array_equal(tu.numpy(), ju)
    # the walk in the kernel's place: the same matches, pair for pair,
    # and the same planes through the rest of regex_verify
    assert torch.equal(staged_scan(*args), t_regexdev.regex_scan_plain(*args))
    monkeypatch.setattr(kernels, "match_regex_scan", staged_scan)
    rx_t = tm.to_device(t_compile.rx_arrays_np(c.t_db), torch.device("cpu"))
    wv, wu = t_regexdev.regex_verify(c.t_db, p["ts"], p["tl"], value, k, rx_t,
                                     torch.from_numpy(tm._word_table()))
    assert np.array_equal(wv.numpy(), jv) and np.array_equal(wu.numpy(), ju)
    assert jv.any() and not jv.all()
    assert ju.any() == (k_pairs is not None)


def test_rows_reach_the_scan_edges(corpora, inputs):
    """The batch holds pairs of every edge length, and every rule of the
    scan decides some row of it."""
    c = corpora[3]
    p, value = inputs[3]
    _tv, _tu, args = recorded_scan(c, p, value, c.t_db.rx_k_pairs(value.shape[0]))
    variants, _pair_b, pair_s, valid, rx = args[:5]
    n = torch.from_numpy(regex_pair_lengths(args))
    width = max(int(v.data.shape[1]) for v in variants)
    for edge in (0, 1, PIECE - 1, PIECE, PIECE + 1, width):
        assert (n == edge).any(), edge
    matched = t_regexdev.regex_scan_plain(*args)[valid]
    seqs = pair_s[valid]
    for key in ("anchored", "start_wb", "end_wb"):
        assert matched[rx[key][seqs]].any(), key
    for mode in (END_Z, END_DOLLAR):
        assert matched[rx["end_mode"][seqs] == mode].any(), mode
    assert matched[n == width].any() and matched[n == PIECE + 1].any()


def test_piece_matches_the_kernel_source():
    src = (Path(kernels.__file__).parent / "csrc" / "match.cu").read_text()
    assert int(re.search(r"constexpr int kRegexPiece = (\d+);", src).group(1)) == PIECE
    assert "const int mine = lane * (kRegexPiece / 32);" in src  # 8 bytes a lane


@pytest.mark.cuda
@pytest.mark.parametrize("k_pairs", [None, 5])
@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_regex_kernel_equals_plain_on_card(corpora, inputs, lanes, k_pairs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    c = corpora[lanes]
    p, value = inputs[lanes]
    _tv, _tu, args = recorded_scan(c, p, value, k_pairs or c.t_db.rx_k_pairs(value.shape[0]))
    variants, pair_b, pair_s, valid, rx, word_tab, r_closure = args
    cuda = (
        [kernels.StreamView(v.data.cuda(), v.lengths.cuda(), v.lowered) for v in variants],
        pair_b.cuda(), pair_s.cuda(), valid.cuda(), {k: t.cuda() for k, t in rx.items()
                                                     if isinstance(t, torch.Tensor)},
        word_tab.cuda(), r_closure,
    )
    got = kernels.match_regex_scan(*cuda)
    assert torch.equal(got, t_regexdev.regex_scan_plain(*cuda))
    assert torch.equal(got.cpu(), staged_scan(*args))
