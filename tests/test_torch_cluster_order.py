"""The parent search in density order (the glue the ``cluster_parent``
kernel runs behind) against the JAX package's, on the CPU.

``cluster.nearest_denser_in_order`` sorts the rows densest first,
gathers them, runs the ``cluster_parent`` kernel's wrapper
(``kernels.parent_in_order``) on them and scatters the results back; on
the CPU the wrapper runs the kernel's plain tile computation
(``cluster.parent_in_order_plain``). Inputs
are made with numpy from fixed seeds; tolerance is 0 throughout (integers
and integer-valued f32). The numpy models of the kernel's integer
threshold and of its two parent-key widths are checked here too.
"""

import os
import numpy as np
import pytest
import torch

from swarm_tpu.ops import cluster as jc
from swarm_tpu_torch.ops import cluster as tc
from swarm_tpu_torch.ops import kernels

from test_torch_cluster import KINDS, make_rows


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


NS = (1, 2, 15, 16, 17, 127, 128, 129, 300, 1000)
RADII = (0.0, 0.5, 40.0, 511.5, 512.0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("n", NS)
def test_parent_in_density_order_matches_jax(n, radius, kind):
    packed = make_rows(kind, n, seed=n + 11)
    labels_j, rho_j = jc.density_cluster(packed, radius)
    delta_j, parent_j = jc.nearest_denser(packed, rho_j)

    x = tc.carry_packed(packed, "cpu")
    rho = torch.from_numpy(rho_j.astype(np.int32))
    before = dict(kernels.LAUNCHES)
    delta, parent = tc.nearest_denser_in_order(x, rho)  # glue + plain tiles
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(delta.numpy(), delta_j)
    np.testing.assert_array_equal(parent.numpy(), parent_j)
    # the plain version of the whole function agrees
    delta_p, parent_p = tc.nearest_denser_plain(x, rho)
    assert torch.equal(delta, delta_p) and torch.equal(parent, parent_p)

    labels_t, rho_t = tc.density_cluster(packed, radius, device="cpu")
    np.testing.assert_array_equal(rho_t, rho_j)
    np.testing.assert_array_equal(labels_t, labels_j)


def test_glue_sorts_gathers_and_scatters_back():
    """The search sees the rows densest first (ties by index), with their
    original indices, and its results land on the original rows."""
    packed = make_rows("random", 9, seed=2)
    x = tc.carry_packed(packed, "cpu")
    rho = torch.tensor([3, 5, 3, 1, 5, 5, 0, 3, 1], dtype=torch.int32)
    seen = {}

    def spy(rows, order):
        seen["rows"], seen["order"] = rows, order
        n = rows.shape[0]
        return torch.arange(n, dtype=torch.float32), order.clone()

    delta, parent = tc.nearest_denser_in_order(x, rho, spy)
    want = [1, 4, 5, 0, 2, 7, 3, 8, 6]
    assert seen["order"].dtype == torch.int32
    assert seen["order"].tolist() == want
    assert torch.equal(seen["rows"], x[want])
    # position p's results go back to row want[p]
    assert parent.tolist() == list(range(9))
    assert delta.tolist() == [float(want.index(i)) for i in range(9)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", (1, 17, 129, 300))
def test_wide_key_matches_narrow_key(kind, n):
    """The 64-bit key (d << 32) | j that the kernel takes above 2^21 rows
    picks the same parents as the 32-bit (d << 21) | j."""
    packed = make_rows(kind, n, seed=n)
    x = tc.carry_packed(packed, "cpu")
    rho = tc.neighbor_counts_plain(x, 40.0)
    order = torch.argsort(-rho, stable=True)
    rows, order32 = x.index_select(0, order), order.to(torch.int32)
    narrow = tc.parent_in_order_plain(rows, order32, key_shift=21)
    wide = tc.parent_in_order_plain(rows, order32, key_shift=32)
    assert tc.parent_key_shift(n) == 21
    assert torch.equal(narrow[0], wide[0]) and torch.equal(narrow[1], wide[1])


@pytest.mark.parametrize("seed", range(4))
def test_key_model_orders_like_distance_then_index(seed):
    """numpy model of the key: the least of (d << 21) | j and of
    (d << 32) | j is the least distance, then the least index."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 513, size=(64, 200)).astype(np.uint64)
    d[:, 5] = d[:, 150]  # ties in distance
    j = rng.permutation(tc.KEY32_MAX_ROWS)[:200].astype(np.uint64)
    want_pos = np.lexsort((np.broadcast_to(j, d.shape), d), axis=1)[:, 0]
    for shift, dtype in ((21, np.uint32), (32, np.uint64)):
        key = ((d << np.uint64(shift)) | j).astype(dtype)
        assert key.max() < np.iinfo(dtype).max  # never the "none" sentinel
        best = key.min(axis=1).astype(np.uint64)
        np.testing.assert_array_equal(best >> np.uint64(shift), d[np.arange(64), want_pos])
        np.testing.assert_array_equal(best & np.uint64((1 << shift) - 1), j[want_pos])
    assert tc.parent_key_shift(tc.KEY32_MAX_ROWS) == 21
    assert tc.parent_key_shift(tc.KEY32_MAX_ROWS + 1) == 32


def test_parent_launcher_rejects_a_key_too_narrow():
    rows = torch.empty((tc.KEY32_MAX_ROWS + 1, 16), dtype=torch.int32)
    order = torch.empty(tc.KEY32_MAX_ROWS + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot hold"):
        kernels.parent_in_order(rows, order, key_shift=21)
    with pytest.raises(ValueError, match="cannot hold"):
        kernels.parent_in_order(rows[:8], order[:8], key_shift=7)


def kernel_threshold(radius: np.float32) -> int:
    """numpy model of the counts kernel's launcher: floor(radius) clamped
    to [-1, 1024], where fmaxf drops NaN to -1."""
    r = np.float32(np.floor(radius))
    r = np.float32(-1.0) if np.isnan(r) else max(r, np.float32(-1.0))
    return int(min(r, np.float32(1024.0)))


def test_integer_threshold_equals_float_comparison():
    """(float)d <= radius ⇔ d <= thr for every d in [0, 512] and every
    float radius, including halves, 512, negatives, ±inf and NaN."""
    d = np.arange(0, 513)
    rng = np.random.default_rng(0)
    radii = np.concatenate([
        np.array([0.0, 0.5, -0.5, -1.0, -1.5, -2.0, 511.5, 512.0, 512.5, 1023.9,
                  1024.0, 1e6, -1e6, np.inf, -np.inf, np.nan, 40.0, 39.999996,
                  np.nextafter(np.float32(40), np.float32(0)), 1e-30, -1e-30]),
        rng.uniform(-600, 1200, size=2000),
        np.arange(-3, 515, 0.25),
    ]).astype(np.float32)
    for r in radii:
        want = d.astype(np.float32) <= r
        np.testing.assert_array_equal(d <= kernel_threshold(r), want, err_msg=f"radius {r}")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__3ffcc972_10_cluster_cu_b52c2ba415mma_rate_kernelEjiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__3ffcc972_10_cluster_cu_b52c2ba415mma_rate_kernelEjiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__3ffcc972_10_cluster_cu_b52c2ba421cluster_parent_kernelIyEEvPK5uint4PKiiPfPi' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__3ffcc972_10_cluster_cu_b52c2ba421cluster_parent_kernelIyEEvPK5uint4PKiiPfPi
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 95 registers, used 1 barriers, 26112 bytes smem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__3ffcc972_10_cluster_cu_b52c2ba421cluster_counts_kernelEPK5uint4iiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__3ffcc972_10_cluster_cu_b52c2ba421cluster_counts_kernelEPK5uint4iiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 24576 bytes smem
"""


def test_ptxas_report_reads_registers_smem_and_spills():
    report = {k["kernel"]: k for k in kernels.ptxas_report(PTXAS_LOG)}
    assert set(report) == {
        "mma_rate_kernel", "cluster_parent_kernel<uint64>", "cluster_counts_kernel",
    }
    assert report["cluster_counts_kernel"] == {
        "kernel": "cluster_counts_kernel", "spill_stores": 0, "spill_loads": 0,
        "registers": 80, "smem_bytes": 24576,
    }
    assert report["cluster_parent_kernel<uint64>"]["spill_stores"] == 12
    assert report["cluster_parent_kernel<uint64>"]["spill_loads"] == 16
    assert report["mma_rate_kernel"]["smem_bytes"] == 0
