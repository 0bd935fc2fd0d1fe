"""Distributed skew/overflow hardening.

The shuffle's static-capacity contract: extreme skew that a device's
buffer cannot absorb must be DETECTED (OverflowError from gather_valid's
demand-vs-capacity check), never silent row loss — the distributed analog
of the reference's uniform_threshold skew handling (reference:
src/sorts/scanning_sort.rs:109-126, a static plan with a detectable
escape).  Covered here:

* hot multi-distinct-key buckets overflowing a tight capacity_factor on
  BOTH the 1-axis and the 2-axis (host, chip) mesh,
* the 2-axis STAGE-1 intermediate overflow (column funneling) poisoning
  the reported count even when the final distribution fits,
* ``distributed_sort_auto`` doubling the factor until the exchange fits,
* ``config.hier_stage1_headroom`` absorbing the stage-1 funnel.
"""
import numpy as np
import pytest

from rdst_tpu import config
from rdst_tpu.parallel import (
    distributed_sort,
    distributed_sort_auto,
    gather_valid,
    make_mesh,
    make_mesh_2d,
)


def _u64_planes(x):
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return [hi, lo]


def _hot_bucket_input(rng, n):
    """~88% of rows in one multi-distinct-key bucket (256 distinct keys
    below 2^8 while 12% span the full u64 range, so the adaptive window
    collapses the hot mass into bucket 0).  Hot-bucket REFINEMENT
    (config.shuffle_refine_levels) balances this in 2 levels."""
    x = rng.integers(0, 1 << 8, size=n, dtype=np.uint64)
    x[: n // 8] = rng.integers(0, 2**64, size=n // 8, dtype=np.uint64)
    return x


def _deep_hot_input(rng, n):
    """Adversarial-beyond-refinement: concentration nested FOUR 16-bit
    fields deep (90% zero at each of the top three fields), so 2
    refinement levels still end on a huge multi-key bucket -> atomic
    assignment -> one device demands ~0.73n rows."""

    def field():
        v = rng.integers(0, 1 << 16, size=n).astype(np.uint64)
        v[rng.random(n) < 0.9] = 0
        return v

    lo = rng.integers(0, 1 << 16, size=n).astype(np.uint64)
    return (
        (field() << np.uint64(48)) | (field() << np.uint64(32))
        | (field() << np.uint64(16)) | lo
    )


def test_overflow_1axis(rng):
    mesh = make_mesh(8)
    n = 1 << 12
    x = _deep_hot_input(rng, n)
    words, _, counts = distributed_sort(
        _u64_planes(x), mesh=mesh, capacity_factor=1.1
    )
    assert int(np.asarray(counts).max()) > words[0].shape[0] // 8
    with pytest.raises(OverflowError):
        gather_valid(words, counts)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_overflow_2axis(rng, shape):
    mesh2 = make_mesh_2d(*shape)
    n = 1 << 12
    x = _deep_hot_input(rng, n)
    words, _, counts = distributed_sort(
        _u64_planes(x), mesh=mesh2, axis=mesh2.axis_names,
        capacity_factor=1.1,
    )
    with pytest.raises(OverflowError):
        gather_valid(words, counts)


@pytest.mark.parametrize("overlap", [False, True])
def test_auto_retry_converges(rng, overlap):
    mesh = make_mesh(8)
    n = 1 << 12
    x = _deep_hot_input(rng, n)
    pay = np.arange(n, dtype=np.uint32)
    words, payloads, counts = distributed_sort_auto(
        _u64_planes(x), [pay], mesh=mesh, capacity_factor=1.1,
        stable=True, overlap_exchange=overlap,
    )
    dense = gather_valid(list(words) + list(payloads), counts)
    got = (dense[0].astype(np.uint64) << np.uint64(32)) | dense[1].astype(
        np.uint64
    )
    np.testing.assert_array_equal(got, np.sort(x))
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(dense[2], pay[order])


def test_auto_retry_2axis(rng):
    mesh2 = make_mesh_2d(2, 4)
    n = 1 << 12
    x = _deep_hot_input(rng, n)
    words, _, counts = distributed_sort_auto(
        _u64_planes(x), mesh=mesh2, axis=mesh2.axis_names,
        capacity_factor=1.1,
    )
    dense = gather_valid(words, counts)
    got = (dense[0].astype(np.uint64) << np.uint64(32)) | dense[1].astype(
        np.uint64
    )
    np.testing.assert_array_equal(got, np.sort(x))


# --- hot-bucket refinement: skewed distributions balance to ~fair share


def _demand(x, mesh, axis, stable=False, pay=None):
    payloads = [pay] if pay is not None else []
    words, pl, counts = distributed_sort(
        _u64_planes(x), payloads, mesh=mesh, axis=axis,
        capacity_factor=8.0, stable=stable,
    )
    c = np.asarray(counts)
    dense = gather_valid(list(words) + list(pl), counts)
    got = (dense[0].astype(np.uint64) << np.uint64(32)) | dense[1].astype(
        np.uint64
    )
    np.testing.assert_array_equal(got, np.sort(x))
    if pay is not None:
        order = np.argsort(x, kind="stable")
        np.testing.assert_array_equal(dense[2], pay[order])
    return float(c.max()) * mesh.devices.size / len(x)


@pytest.mark.parametrize("dist", ["bimodal", "zipf", "hot256"])
def test_refinement_balances_skew(rng, dist):
    """Multi-key hot buckets refine to ~fair share (pre-refinement these
    demanded 3.9-7.0x — scripts/capacity_study.py round-5 table)."""
    n = 1 << 13
    if dist == "bimodal":
        u = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        x = np.concatenate(
            [u[: n // 2] >> np.uint64(32), u[n // 2 :] << np.uint64(32)]
        )
        rng.shuffle(x)
    elif dist == "zipf":
        x = np.minimum(rng.zipf(1.2, size=n), 1 << 20).astype(np.uint64)
    else:
        x = _hot_bucket_input(rng, n)
    mesh = make_mesh(8)
    pay = np.arange(n, dtype=np.uint32)
    d = _demand(x, mesh, "shard", stable=True, pay=pay)
    assert d <= 1.35, f"{dist}: demand {d} after refinement"
    mesh2 = make_mesh_2d(2, 4)
    d2 = _demand(x, mesh2, mesh2.axis_names)
    assert d2 <= 1.35, f"{dist}: 2-axis demand {d2} after refinement"


def _column_funnel_input(rng, H, C, n_local):
    """Shard-major input where chip COLUMN 0 holds every row destined to
    the top-half hosts: stage 1 funnels ~half the data through column 0,
    so its stage-1 intermediate load is ~C x its final balanced load."""
    n = H * C * n_local
    lo = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    hi = rng.integers(1 << 31, 1 << 32, size=n, dtype=np.uint32).astype(
        np.uint32
    )
    x = np.empty(n, dtype=np.uint32)
    for h in range(H):
        for c in range(C):
            s = (h * C + c) * n_local
            # column 0 shards carry high keys (destined to the top-half
            # hosts), the rest carry low keys
            x[s : s + n_local] = (
                hi[s : s + n_local] if c == 0 else lo[s : s + n_local]
            )
    return x


def test_stage1_poisoning_and_headroom(rng):
    """Final distribution fits, but the stage-1 funnel exceeds the
    intermediate buffer -> poisoned count raises; enough
    hier_stage1_headroom absorbs it (same data, same factor)."""
    H, C = 2, 4
    mesh2 = make_mesh_2d(H, C)
    n_local = 1 << 9
    x = _column_funnel_input(rng, H, C, n_local)
    # high keys are 4/8 shards = half the data -> host 1's chips each
    # receive ~n_local rows finally (fits 1.3x), but chip (1, 0) sees
    # ALL of host 1's rows (~4 * n_local) in stage 1
    old = config.hier_stage1_headroom
    try:
        config.hier_stage1_headroom = 1.0
        words, _, counts = distributed_sort(
            [x], mesh=mesh2, axis=mesh2.axis_names, capacity_factor=1.3
        )
        with pytest.raises(OverflowError):
            gather_valid(words, counts)

        config.hier_stage1_headroom = float(C + 1)
        words, _, counts = distributed_sort(
            [x], mesh=mesh2, axis=mesh2.axis_names, capacity_factor=1.3
        )
        dense = gather_valid(words, counts)
        np.testing.assert_array_equal(dense[0], np.sort(x))
    finally:
        config.hier_stage1_headroom = old


def test_refinement_four_word_keys(rng):
    """Refinement walks ALL key words: 4-plane (u128-style) keys whose
    concentration sits in the SECOND word still balance and sort
    bit-exactly with stable payloads."""
    n = 1 << 12
    w0 = np.zeros(n, dtype=np.uint32)  # constant top word
    w1 = rng.integers(0, 1 << 8, size=n).astype(np.uint32)  # hot: 256 keys
    w1[: n // 8] = rng.integers(0, 1 << 32, size=n // 8).astype(np.uint32)
    w2 = rng.integers(0, 1 << 32, size=n).astype(np.uint32)
    w3 = rng.integers(0, 1 << 32, size=n).astype(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    mesh = make_mesh(8)
    words, payloads, counts = distributed_sort(
        [w0, w1, w2, w3], [pay], mesh=mesh, capacity_factor=2.0,
        stable=True,
    )
    c = np.asarray(counts)
    assert float(c.max()) * 8 / n <= 1.5, "4-word refinement demand"
    dense = gather_valid(list(words) + list(payloads), counts)
    order = np.lexsort((pay, w3, w2, w1, w0))
    for got, src in zip(dense, [w0, w1, w2, w3, pay]):
        np.testing.assert_array_equal(got, src[order])


def test_small_right_replication_floor(rng):
    """partition_exchange gives small tables full-table capacity: a
    32-row dim table co-partitions against a SKEWED fact partition with
    the default factor (no mesh-size-scaled right_capacity_factor)."""
    from rdst_tpu.parallel import partition_exchange

    mesh = make_mesh(8)
    n = 1 << 12
    # skewed fact: most rows hold key 7 -> its bucket (and the dim row
    # for key 7) lands on one device
    fact = np.full(n, 7, dtype=np.uint32)
    fact[: n // 4] = rng.integers(0, 32, size=n // 4).astype(np.uint32)
    _, _, counts, part = distributed_sort(
        [fact], mesh=mesh, split_uniform=False, return_partition=True,
        capacity_factor=2.0,
    )
    dim = np.arange(32, dtype=np.uint32).repeat(2)  # 64 rows, div by 8
    rwords, _, rcounts = partition_exchange(
        [dim], [], part, mesh=mesh, capacity_factor=2.0
    )
    dense = gather_valid(rwords, rcounts)
    assert sorted(dense[0].tolist()) == sorted(dim.tolist())


def test_refinement_hidden_word(rng):
    """Regression: a varying word whose SEGMENT-BOUNDARY rows coincide
    must not be treated as constant by the refined window.

    3-word keys, 87.5% hot mass at w0 in {0,1}; within the hot mass the
    w0==0 rows carry w1 in {77, 200} and the w0==1 rows w1 in {3, 77},
    so the chain segment's first row (w0=0, min w1=77) and last row
    (w0=1, max w1=77) read w1 == 77 while w1 varies inside. First/last
    extrema would allocate w1 ZERO window bits, the refined bucket id
    would go non-monotone in the sorted order, and the send segments
    would route rows to wrong devices (reproduced before the exact
    masked-extrema fix). w2 varies freely to carry the damage."""
    n = 1 << 12
    w0 = np.zeros(n, np.uint32)
    w1 = np.zeros(n, np.uint32)
    w2 = rng.integers(0, 2**32, n).astype(np.uint32)
    hot = np.ones(n, bool)
    hot[: n // 8] = False
    w0[~hot] = (
        rng.integers(0, 2**32, (~hot).sum()).astype(np.uint32)
        | np.uint32(1 << 31)
    )
    w0[hot] = rng.integers(0, 2, hot.sum()).astype(np.uint32)
    a = hot & (w0 == 0)
    b = hot & (w0 == 1)
    w1[a] = np.where(rng.random(a.sum()) < 0.5, 77, 200).astype(np.uint32)
    w1[b] = np.where(rng.random(b.sum()) < 0.5, 3, 77).astype(np.uint32)
    mesh = make_mesh(8)
    words, _, counts = distributed_sort(
        [w0, w1, w2], mesh=mesh, capacity_factor=8.0
    )
    dense = gather_valid(words, counts)
    order = np.lexsort((w2, w1, w0))
    for d, s in zip(dense, [w0, w1, w2]):
        np.testing.assert_array_equal(d, s[order])
