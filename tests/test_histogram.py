"""The planning histogram (ops/histogram.py) against a numpy reference.

Counts of every byte level, per-level sortedness, the sorted prefix of the
full key and the single-level device histogram, for every key family the
normalizer produces, at sizes around the partial-histogram row count
(``_ROWS``) and at 2^20.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from rdst_tpu import keys as rkeys
from rdst_tpu.ops import histogram as H

SIZES = [1, 127, 128, 2049, 1 << 20]
DTYPES = ["uint8", "uint16", "uint32", "uint64", "int32", "int64",
          "float32", "float64", "composite"]


def _keys(rng, dtype, n):
    if dtype == "composite":
        a = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
        b = rng.standard_normal(n).astype(np.float32)
        return (a, b)
    if dtype.startswith("float"):
        x = rng.standard_normal(n).astype(dtype)
        x[: min(n, 4)] = [np.nan, -0.0, 0.0, -np.inf][: min(n, 4)]
        return x
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, size=n, endpoint=True, dtype=dtype)
    if n > 4:
        x[n // 2:] = np.sort(x[n // 2:])  # a sorted tail keeps levels varied
    return x


def _reference(words, n_bytes):
    """Counts, per-level sortedness and sorted prefix, in numpy."""
    words = [np.asarray(w).astype(np.uint64) for w in words]
    nw = len(words)
    counts, level_sorted = [], []
    for level in range(n_bytes):
        d = (words[nw - 1 - level // 4] >> np.uint64((level % 4) * 8)) & 0xFF
        counts.append(np.bincount(d.astype(np.int64), minlength=256))
        level_sorted.append(bool(np.all(d[1:] >= d[:-1])))
    n = words[0].shape[0]
    prefix = n
    gt = np.zeros(max(n - 1, 0), bool)
    eq = np.ones_like(gt)
    for w in words:
        gt |= eq & (w[:-1] > w[1:])
        eq &= w[:-1] == w[1:]
    if gt.any():
        prefix = int(np.argmax(gt)) + 1
    return np.stack(counts), np.array(level_sorted), prefix


def _check(words, n_bytes):
    got = H.multi_level_histogram(words, n_bytes)
    counts, level_sorted, prefix = _reference(words, n_bytes)
    np.testing.assert_array_equal(got.counts, counts)
    np.testing.assert_array_equal(got.level_sorted, level_sorted)
    assert got.sorted_prefix == prefix
    assert got.n == words[0].shape[0]
    return got


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_histogram_matches_numpy(rng, dtype, n):
    nk = rkeys.normalize(_keys(rng, dtype, n))
    got = _check(list(nk.words), nk.n_bytes)
    # the single-level device histogram agrees level by level
    for level in range(nk.n_bytes):
        np.testing.assert_array_equal(
            np.asarray(H.level_histogram(tuple(nk.words), level)),
            got.counts[level],
        )


@pytest.mark.parametrize("pos", [1, 1023, 1024, 2047, 2048, 4999])
def test_sortedness_single_descent(pos):
    """A sorted u64 input with one descent at ``pos``: the levels whose
    digits descend there, and the prefix, report it wherever it sits
    (row and old block edges included)."""
    n = 5000
    x = (np.arange(n, dtype=np.uint64) + np.uint64(1)) * np.uint64(
        0x0101_0101_0101)
    x[pos] = x[pos - 1] - np.uint64(1)
    nk = rkeys.normalize(x)
    got = _check(list(nk.words), nk.n_bytes)
    assert got.sorted_prefix == pos
    assert not got.fully_sorted()


def test_histogram_sorted_and_constant():
    """Sorted input: the full prefix, the levels whose digits never
    descend, and the constant level; all-equal input is fully sorted."""
    x = np.arange(300_000, dtype=np.uint32)
    got = _check([jnp.asarray(x)], 4)
    assert got.sorted_prefix == x.shape[0]
    assert got.level_sorted.tolist() == [False, False, True, True]
    assert got.constant_levels().tolist() == [False, False, False, True]
    same = _check([jnp.full((5000,), np.uint32(7))], 4)
    assert same.fully_sorted() and same.constant_levels().all()
