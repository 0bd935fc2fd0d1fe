"""Distributed MSB shuffle sort on the virtual 8-device CPU mesh.

The reference tests its multi-threaded algorithms on the host's thread pool
(SURVEY.md §4); the JAX equivalent is shard_map over
xla_force_host_platform_device_count=8 so the psum/all_gather/
all_to_all collectives execute for real (XLA:CPU has no ragged_all_to_all;
tests/test_exchange_parity.py covers that branch).
"""
import numpy as np
import pytest

import jax

from rdst_tpu import keys as rkeys
from rdst_tpu.parallel import distributed_sort, gather_valid, make_mesh


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


def test_distributed_sort_u32(mesh, rng):
    n = 1 << 16
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    nk = rkeys.normalize(x)
    words, _, counts = distributed_sort(list(nk.words), mesh=mesh)
    assert int(np.asarray(counts).sum()) == n
    dense = gather_valid(words, counts)[0]
    np.testing.assert_array_equal(dense, np.sort(x))


def test_distributed_sort_u64_with_payload(mesh, rng):
    n = 1 << 14
    x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    nk = rkeys.normalize(x)
    payload = np.arange(n, dtype=np.uint32)
    words, payloads, counts = distributed_sort(
        list(nk.words), [payload], mesh=mesh, stable=True
    )
    dense = gather_valid(list(words) + list(payloads), counts)
    hi, lo, pv = dense
    order = np.argsort(x, kind="stable")
    want = np.sort(x)
    got = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pv, payload[order])


def test_distributed_sort_skewed(mesh, rng):
    """Zipfian-ish top bytes: one hot bucket; capacity must absorb it."""
    n = 1 << 14
    hot = np.full(n // 2, 0xAB000000, dtype=np.uint32) + rng.integers(
        0, 1000, n // 2
    ).astype(np.uint32)
    rest = rng.integers(0, 2**32, size=n // 2, dtype=np.uint32)
    x = np.concatenate([hot, rest])
    rng.shuffle(x)
    nk = rkeys.normalize(x)
    words, _, counts = distributed_sort(
        list(nk.words), mesh=mesh, capacity_factor=5.0
    )
    dense = gather_valid(words, counts)[0]
    np.testing.assert_array_equal(dense, np.sort(x))


def test_distributed_sort_all_equal_balanced(mesh):
    """Degenerate single-value keys: the single-key bucket is split by
    exact stable rank, so the load balances perfectly — no capacity
    headroom needed (previously this required capacity_factor=9)."""
    n = 1 << 13
    x = np.full(n, 7, dtype=np.uint32)
    nk = rkeys.normalize(x)
    words, _, counts = distributed_sort(
        list(nk.words), mesh=mesh, capacity_factor=1.05
    )
    counts = np.asarray(counts)
    assert counts.max() == n // 8  # perfect split across 8 devices
    dense = gather_valid(words, counts)[0]
    np.testing.assert_array_equal(dense, x)


def test_distributed_sort_hot_key_balanced(mesh, rng):
    """One key holds 75% of the rows (Zipf-style hot key). The hot key's
    bucket is single-keyed, so rank splitting spreads it across devices
    within modest capacity."""
    n = 1 << 14
    hot = np.full(3 * n // 4, 0xDEADBEEF, dtype=np.uint32)
    rest = rng.integers(0, 2**32, size=n // 4, dtype=np.uint32)
    x = np.concatenate([hot, rest])
    rng.shuffle(x)
    nk = rkeys.normalize(x)
    words, _, counts = distributed_sort(
        list(nk.words), mesh=mesh, capacity_factor=1.5
    )
    counts = np.asarray(counts)
    assert counts.max() <= int(1.5 * n / 8)
    dense = gather_valid(words, counts)[0]
    np.testing.assert_array_equal(dense, np.sort(x))


def test_distributed_sort_hot_key_stable_payload(mesh, rng):
    """Stability across a rank-split hot key: payloads of equal keys must
    arrive in original order even when the key's run spans devices."""
    n = 1 << 13
    x = np.where(
        rng.random(n) < 0.7,
        np.uint32(42),
        rng.integers(0, 100, n).astype(np.uint32),
    )
    payload = np.arange(n, dtype=np.uint32)
    nk = rkeys.normalize(x)
    words, payloads, counts = distributed_sort(
        list(nk.words), [payload], mesh=mesh, stable=True,
        capacity_factor=1.5,
    )
    dense = gather_valid(list(words) + list(payloads), counts)
    got_keys, got_payload = dense
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(got_keys, x[order])
    np.testing.assert_array_equal(got_payload, payload[order])
