"""The port's clustering (swarm_tpu_torch.ops.cluster) against the JAX package's.

Inputs are made with numpy from fixed seeds and go through both
``swarm_tpu.ops.cluster`` (on the CPU its XLA twin, with the Pallas
kernels' semantics) and the port on ``device="cpu"`` (the kernels' plain
PyTorch versions). Tolerance is 0 throughout: rho, parent and labels are
integers and delta is an integer-valued f32.
"""

import os
import numpy as np
import pytest
import torch

from swarm_tpu.ops import cluster as jc
from swarm_tpu_torch.ops import cluster as tc
from swarm_tpu_torch.ops import kernels


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


NS = (0, 1, 7, 300, 1000)
RADII = (0.0, 8.0, 32.0, 64.0)
KINDS = ("random", "duplicate", "jarm")


def make_rows(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 2**32, size=(n, 16), dtype=np.uint64).astype(np.uint32)
    if kind == "duplicate":
        row = rng.integers(0, 2**32, size=(1, 16), dtype=np.uint64).astype(np.uint32)
        return np.repeat(row, n, axis=0)
    # JARM-like: a few base stacks, one jittered character per host
    alphabet = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    base = alphabet[rng.integers(0, 16, size=(8, 62))]
    picks = base[rng.integers(0, 8, size=n)].copy()
    jitter = rng.integers(0, 62, size=n)
    picks[np.arange(n), jitter] = alphabet[rng.integers(0, 16, size=n)]
    packed = jc.pack_strings([bytes(r) for r in picks])
    assert np.array_equal(packed, tc.pack_strings([bytes(r) for r in picks]))
    return packed


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("n", NS)
def test_cluster_matches_jax(n, radius, kind):
    packed = make_rows(kind, n, seed=n)
    labels_j, rho_j = jc.density_cluster(packed, radius)
    labels_t, rho_t = tc.density_cluster(packed, radius, device="cpu")
    np.testing.assert_array_equal(rho_t, rho_j)
    np.testing.assert_array_equal(labels_t, labels_j)
    assert rho_t.dtype == np.int32 and labels_t.dtype == np.int32

    np.testing.assert_array_equal(
        tc.neighbor_counts(packed, radius, device="cpu"),
        jc.neighbor_counts(packed, radius),
    )
    delta_j, parent_j = jc.nearest_denser(packed, rho_j)
    delta_t, parent_t = tc.nearest_denser(packed, rho_j, device="cpu")
    np.testing.assert_array_equal(delta_t, delta_j)
    np.testing.assert_array_equal(parent_t, parent_j)
    assert delta_t.dtype == np.float32 and parent_t.dtype == np.int32


def brute_force(packed: np.ndarray, radius: float):
    """Loop oracle over the numpy distance matrix."""
    d = tc.pairwise_hamming(packed, packed)
    n = packed.shape[0]
    rho = (d <= radius).sum(axis=1)
    delta = np.full(n, tc.NO_PARENT_DELTA, np.float32)
    parent = np.full(n, -1, np.int32)
    for i in range(n):
        for j in range(n):
            denser = rho[j] > rho[i] or (rho[j] == rho[i] and j < i)
            if j != i and denser and (parent[i] < 0 or d[i, j] < delta[i]):
                delta[i], parent[i] = d[i, j], j
    return rho, delta, parent


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius", (0.0, 40.0))
def test_kernels_plain_match_oracle(kind, radius):
    packed = make_rows(kind, 64, seed=3)
    rho, delta, parent = brute_force(packed, radius)
    x = tc.carry_packed(packed, "cpu")
    before = dict(kernels.LAUNCHES)
    rho_t = kernels.cluster_counts(x, radius)
    delta_t, parent_t = tc.nearest_denser_in_order(x, rho_t)
    np.testing.assert_array_equal(rho_t.numpy(), rho)
    np.testing.assert_array_equal(delta_t.numpy(), delta)
    np.testing.assert_array_equal(parent_t.numpy(), parent)
    # the CPU path is the plain version and launches nothing
    assert kernels.LAUNCHES == before


def test_pack_and_hamming_match_jax():
    strings = ["", "a", "0" * 62, "f" * 80, b"\xff" * 64, "07d14d16d21d21d07c42d41d00041d"]
    np.testing.assert_array_equal(tc.pack_strings(strings), jc.pack_strings(strings))
    p = tc.pack_strings(strings)
    np.testing.assert_array_equal(tc.pairwise_hamming(p, p), jc.pairwise_hamming(p, p))
    # bit 31 of a word survives the int32 unpack
    assert int(tc.unpack_bits(tc.carry_packed(p, "cpu"))[4].sum()) == 512


def test_carry_packed_round_trip():
    packed = make_rows("random", 33, seed=9)
    packed[0, :] = 0xFFFFFFFF
    x = tc.carry_packed(packed, "cpu")
    assert x.dtype == torch.int32 and tuple(x.shape) == (33, 16)
    np.testing.assert_array_equal(x.numpy().view(np.uint32), packed)
    with pytest.raises(ValueError):
        tc.carry_packed(packed[:, :8], "cpu")
    with pytest.raises(TypeError):
        tc.carry_packed(packed.astype(np.float32), "cpu")


def test_wrappers_reject_bad_input():
    x = tc.carry_packed(make_rows("random", 8), "cpu")
    with pytest.raises(TypeError):
        kernels.cluster_counts(x.to(torch.int64), 1.0)
    with pytest.raises(ValueError):
        kernels.cluster_counts(x[:, :8], 1.0)
    with pytest.raises(ValueError):
        kernels.cluster_counts(x.t().contiguous().t(), 1.0)
    with pytest.raises(ValueError):
        tc.nearest_denser_in_order(x, torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.parent_in_order(x, torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.parent_in_order(x, torch.zeros(8, dtype=torch.int64))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.density_cluster(make_rows("random", 4), 8.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (4097, 129))
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_plain_on_card(kind, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    packed = make_rows(kind, n, seed=5)
    x = tc.carry_packed(packed, "cuda")
    for radius in (0.0, 0.5, 32.0, 40.0, 512.0):
        rho = kernels.cluster_counts(x, radius)
        delta, parent = tc.nearest_denser_in_order(x, rho)
        rho_p = tc.neighbor_counts_plain(x, radius)
        delta_p, parent_p = tc.nearest_denser_plain(x, rho)
        torch.cuda.synchronize()
        assert torch.equal(rho, rho_p)
        assert torch.equal(delta, delta_p)
        assert torch.equal(parent, parent_p)
    labels_g, rho_g = tc.density_cluster(packed, 40.0, device="cuda")
    labels_c, rho_c = tc.density_cluster(packed, 40.0, device="cpu")
    np.testing.assert_array_equal(labels_g, labels_c)
    np.testing.assert_array_equal(rho_g, rho_c)
