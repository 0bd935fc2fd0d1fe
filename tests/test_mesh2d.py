"""Hierarchical (host, chip) 2-axis mesh: the multi-host code shape.

The hierarchical exchange (shuffle._hier_exchange_and_finish) sends each
destination HOST's rows as one contiguous block along the host axis
(traffic between hosts), then regroups along the chip axis (within a
host).  On the virtual CPU mesh this exercises the full two-stage
collective program — the same jitted code an (H hosts) x (C devices)
cluster runs.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rdst_tpu.parallel import (
    distributed_sort,
    distributed_group_aggregate,
    distributed_join,
    distributed_sort_table,
    gather_valid,
    make_mesh_2d,
)
from rdst_tpu.table import Table


@pytest.fixture(
    scope="module", params=[(2, 4), (4, 2), (1, 8), (8, 1)]
)
def mesh2(request):
    # (1, 8) and (8, 1) are the degenerate-axis shapes where the
    # dest % C routing and host-major flat-index math would break first
    H, C = request.param
    assert jax.device_count() >= H * C
    return make_mesh_2d(H, C)


def _u64_planes(x):
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return [hi, lo]


def test_hier_sort_u64(mesh2, rng):
    n = 1 << 13
    x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    words, _, counts = distributed_sort(
        _u64_planes(x), mesh=mesh2, axis=mesh2.axis_names
    )
    assert int(np.asarray(counts).sum()) == n
    dense = gather_valid(words, counts)
    got = (dense[0].astype(np.uint64) << np.uint64(32)) | dense[1].astype(
        np.uint64
    )
    np.testing.assert_array_equal(got, np.sort(x))


def test_hier_sort_stable_payload(mesh2, rng):
    n = 1 << 12
    x = rng.integers(0, 2**8, size=n, dtype=np.uint64)  # heavy duplicates
    pay = np.arange(n, dtype=np.uint32)
    words, payloads, counts = distributed_sort(
        _u64_planes(x), [pay], mesh=mesh2, axis=mesh2.axis_names,
        stable=True,
    )
    dense = gather_valid(list(words) + list(payloads), counts)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(dense[2], pay[order])


def test_hier_sort_all_equal_rank_split(mesh2):
    n = 1 << 12
    x = np.full(n, 42, dtype=np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    words, payloads, counts = distributed_sort(
        [x], [pay], mesh=mesh2, axis=mesh2.axis_names, stable=True
    )
    cnt = np.asarray(counts)
    D = mesh2.devices.size
    # single-key bucket must rank-split near-perfectly across all devices
    assert cnt.max() - cnt.min() <= 1
    dense = gather_valid(list(words) + list(payloads), counts)
    np.testing.assert_array_equal(dense[1], pay)


def test_hier_matches_flat(mesh2, rng):
    """Bitwise parity: the hierarchical exchange must produce exactly the
    flat 1-axis pipeline's output (same keys, same stable payloads)."""
    from rdst_tpu.parallel import make_mesh

    n = 1 << 12
    x = rng.integers(0, 2**16, size=n, dtype=np.uint64)
    pay = np.arange(n, dtype=np.uint32)
    w2, p2, c2 = distributed_sort(
        _u64_planes(x), [pay], mesh=mesh2, axis=mesh2.axis_names,
        stable=True,
    )
    d2 = gather_valid(list(w2) + list(p2), c2)
    mesh1 = make_mesh(mesh2.devices.size)
    w1, p1, c1 = distributed_sort(
        _u64_planes(x), [pay], mesh=mesh1, stable=True
    )
    d1 = gather_valid(list(w1) + list(p1), c1)
    for a, b in zip(d1, d2):
        np.testing.assert_array_equal(a, b)


def test_hier_overlap_parity(mesh2, rng):
    """Sender-host-half overlapped hierarchical exchange is bitwise
    identical to the sequential one (stable payloads included)."""
    n = 1 << 12
    x = rng.integers(0, 2**16, size=n, dtype=np.uint64)  # duplicates
    pay = np.arange(n, dtype=np.uint32)
    w1, p1, c1 = distributed_sort(
        _u64_planes(x), [pay], mesh=mesh2, axis=mesh2.axis_names,
        stable=True,
    )
    w2, p2, c2 = distributed_sort(
        _u64_planes(x), [pay], mesh=mesh2, axis=mesh2.axis_names,
        stable=True, overlap_exchange=True,
    )
    d1 = gather_valid(list(w1) + list(p1), c1)
    d2 = gather_valid(list(w2) + list(p2), c2)
    for a, b in zip(d1, d2):
        np.testing.assert_array_equal(a, b)


def test_hier_table_pipeline(mesh2, rng):
    """ORDER BY + GROUP BY + join over the 2-axis mesh (the dtable
    surface accepts any mesh/axis the shuffle accepts)."""
    n = 1 << 12
    t = Table(
        {
            "grp": rng.integers(0, 40, n).astype(np.uint32),
            "qty": rng.integers(1, 10, n).astype(np.uint32),
        }
    )
    axes = mesh2.axis_names
    ordered, counts = distributed_sort_table(
        t, "grp", mesh=mesh2, axis=axes
    )
    grp = np.asarray(t["grp"])
    dense = gather_valid(
        [jnp.asarray(np.asarray(ordered["grp"]))], counts
    )[0]
    np.testing.assert_array_equal(dense, np.sort(grp))

    agg, n_groups = distributed_group_aggregate(
        t, "grp", {"total": ("qty", "sum")}, mesh=mesh2, axis=axes
    )
    assert int(n_groups) == len(np.unique(grp))
    want = {
        g: int(np.asarray(t["qty"])[grp == g].sum())
        for g in np.unique(grp)
    }
    got = dict(
        zip(np.asarray(agg["grp"]).tolist(),
            np.asarray(agg["total"]).tolist())
    )
    assert got == want

    dim = Table(
        {
            "grp": np.arange(40, dtype=np.uint32),
            "name": (np.arange(40, dtype=np.uint32) * 3),
        }
    )
    # no right_capacity_factor: the 40-row dim table rides the
    # replication-aware full-table capacity floor (replicate_capacity_max)
    joined, n_matched = distributed_join(t, dim, "grp", mesh=mesh2, axis=axes)
    assert int(n_matched) == n
    np.testing.assert_array_equal(
        np.asarray(joined["name"]), np.asarray(joined["grp"]) * 3
    )
