"""Bitonic merges (ops/merge.py) and the dense sort at sizes from 2^15 up.

``merge_sorted`` / ``merge_many`` carry the presorted, Regions and
overlapped-exchange paths; ``comparative_sort`` is the dense executor
behind every plan. Each is compared with numpy: stable results with
``np.argsort(kind="stable")``, unstable ones by keys and by (key, payload)
rows as multisets.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from rdst_tpu.ops.merge import merge_many, merge_sorted
from rdst_tpu.sorts.comparative import comparative_sort


def _run(rng, m, key_range=1 << 12):
    """One sorted run of m rows: (hi, lo) u32 key planes + u32 payload."""
    hi = rng.integers(0, 4, size=m).astype(np.uint32)
    lo = rng.integers(0, key_range, size=m).astype(np.uint32)
    order = np.lexsort((lo, hi))
    pay = rng.integers(0, 2**32, size=m, dtype=np.int64).astype(np.uint32)
    return [hi[order], lo[order], pay[order]]


def _expect(runs, stable):
    cat = [np.concatenate([r[i] for r in runs]) for i in range(3)]
    if stable:
        order = np.lexsort((cat[1], cat[0]))  # lexsort is stable
    else:
        order = np.lexsort((cat[2], cat[1], cat[0]))
    return [p[order] for p in cat]


def _compare(got, want, stable):
    got = [np.asarray(p)[: want[0].shape[0]] for p in got]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if stable:
        np.testing.assert_array_equal(got[2], want[2])
    else:
        rows = np.lexsort((got[2], got[1], got[0]))
        np.testing.assert_array_equal(got[2][rows], want[2])


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("log_total", [15, 16, 17])
def test_merge_sorted_with_payload(rng, log_total, stable):
    half = 1 << (log_total - 1)
    a, b = _run(rng, half), _run(rng, half)
    got = merge_sorted([jnp.asarray(p) for p in a],
                       [jnp.asarray(p) for p in b], 2, stable=stable)
    _compare(got, _expect([a, b], stable), stable)


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("k", [3, 5])
def test_merge_many_odd_runs(rng, k, stable):
    """An odd run count pads the last run with all-ones keys; the pads
    land at the tail and real rows keep their order."""
    m = 1 << 14
    runs = [_run(rng, m) for _ in range(k)]
    got = merge_many([[jnp.asarray(p) for p in r] for r in runs], 2,
                     stable=stable)
    _compare(got, _expect(runs, stable), stable)


def test_merge_sorted_all_ones_ties(rng):
    """Real all-ones keys tie with the merge's pad sentinel; stable mode
    keeps a-side rows first."""
    m = 1 << 15
    a = [np.full(m, 0xFFFFFFFF, np.uint32), np.full(m, 0xFFFFFFFF, np.uint32),
         np.arange(m, dtype=np.uint32)]
    b = [p.copy() for p in a]
    b[2] = b[2] + np.uint32(m)
    got = merge_sorted([jnp.asarray(p) for p in a],
                       [jnp.asarray(p) for p in b], 2, stable=True)
    np.testing.assert_array_equal(np.asarray(got[2]),
                                  np.arange(2 * m, dtype=np.uint32))


@pytest.mark.parametrize("stable", [True, False])
def test_comparative_sort_2_21(rng, stable):
    """The dense executor at 2^21 rows: two key planes and a payload."""
    n = 1 << 21
    hi = rng.integers(0, 64, size=n).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    (gh, gl), (gp,) = comparative_sort(
        [jnp.asarray(hi), jnp.asarray(lo)], [jnp.asarray(pay)], stable=stable
    )
    order = np.lexsort((lo, hi))
    np.testing.assert_array_equal(np.asarray(gh), hi[order])
    np.testing.assert_array_equal(np.asarray(gl), lo[order])
    gp = np.asarray(gp)
    if stable:
        np.testing.assert_array_equal(gp, pay[order])
    else:
        np.testing.assert_array_equal(np.sort(gp), pay)
        np.testing.assert_array_equal(hi[gp], hi[order])
        np.testing.assert_array_equal(lo[gp], lo[order])
