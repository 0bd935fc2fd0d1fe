"""Default-pipeline coverage through the DEVICE dispatcher.

With the host-native fast path on (config.host_sort_max), every small
numpy-input sort with a built-in tuner runs the C++ host sort, so the
Sorter device flow (histogram -> tuner -> plan) would have no
default-flow coverage.  This suite pins host_sort_max = 0 so every sort
takes the device path, and adds
>=1M-element runs at the sizes where the StandardTuner NATURALLY picks
each large-regime plan (no pinned tuners):

  uniform 1.2M   -> Recombinating   (standard_tuner.rs: 260k < n <= 50M)
  skewed  4.2M   -> Regions         (skew ladder: n > 4M)
  skewed  1.0M   -> MtLsb           (skew ladder: 350k < n <= 4M)
  uniform 50M+1  -> Scanning        (n > 50M)
"""
import numpy as np
import pytest

import rdst_tpu as rt
from rdst_tpu import config
from rdst_tpu.tuner import Algorithm, StandardTuner, TuningParams


@pytest.fixture(autouse=True)
def _device_flow(monkeypatch):
    monkeypatch.setattr(config, "host_sort_max", 0)


ALL_TYPES = [
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
    "float32", "float64",
]


@pytest.mark.parametrize("dtype", ALL_TYPES)
def test_device_default_flow_all_dtypes(dtype, rng):
    """radix_sort_unstable via histogram -> tuner -> plan, no host path."""
    if dtype.startswith("float"):
        x = rng.standard_normal(10_000).astype(dtype)
        x[:8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0]
        got = rt.radix_sort_unstable(x)
        u = np.uint32 if dtype == "float32" else np.uint64
        from rdst_tpu import keys as rkeys

        nk = rkeys.normalize(x)
        if len(nk.words) == 1:
            order = np.argsort(np.asarray(nk.words[0]), kind="stable")
        else:
            hi, lo = (np.asarray(w) for w in nk.words)
            order = np.lexsort((lo, hi))
        np.testing.assert_array_equal(got.view(u), x[order].view(u))
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, size=10_000, endpoint=True,
                         dtype=dtype)
        got = rt.radix_sort_unstable(x)
        np.testing.assert_array_equal(got, np.sort(x))


def test_device_stable_key_value(rng):
    k = rng.integers(0, 64, size=20_000, dtype=np.uint16)
    v = np.arange(20_000, dtype=np.uint32)
    ks, vs = rt.sort_key_value(k, v, stable=True)
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks, k[order])
    np.testing.assert_array_equal(vs, v[order])


def _assert_pick(n, skewed, expect):
    """Sanity-pin the ladder so the sizes below stay 'natural'."""
    counts = [n // 256] * 256
    if skewed:
        counts[3] += n // 2
    p = TuningParams(threads=8, level=3, total_levels=4, input_len=n,
                     parent_len=None)
    assert StandardTuner().pick_algorithm(p, counts) is expect


def test_recombinating_natural_1m(rng):
    n = 1_200_000
    _assert_pick(n, False, Algorithm.RECOMBINATING)
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(got, np.sort(x))


def test_mt_lsb_natural_1m_skewed(rng):
    n = 1_000_000
    _assert_pick(n, True, Algorithm.MT_LSB)
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    x[: n // 2] = 0xDEADBEEF  # dominant digit => skew ladder
    v = np.arange(n, dtype=np.uint32)
    ks, vs = rt.sort_key_value(x, v, stable=True)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(ks, x[order])
    np.testing.assert_array_equal(vs, v[order])


def test_regions_natural_4m_skewed(rng):
    n = 4_200_000
    _assert_pick(n, True, Algorithm.REGIONS)
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    x[: n // 2] = 12345
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.slow
def test_scanning_natural_50m():
    n = 50_000_001
    _assert_pick(n, False, Algorithm.SCANNING)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(got, np.sort(x))
