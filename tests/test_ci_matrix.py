"""CI-matrix style coverage (reference .github/workflows/rust.yml):
single-program builds, regression cases, determinism, f64+payload configs.
"""
import numpy as np
import pytest

import rdst_tpu as rt
from rdst_tpu import keys as rkeys

ALL_TYPES = ["uint8", "uint16", "uint32", "uint64",
             "int8", "int16", "int32", "int64", "float32", "float64"]


@pytest.mark.parametrize("dtype", ALL_TYPES)
def test_single_program_build(dtype, rng):
    """with_parallel(False) across every key type — the reference's
    no-default-features job (rust.yml:34-39, reduced Algorithm enum)."""
    if dtype.startswith("float"):
        x = rng.standard_normal(8_000).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, 8_000, endpoint=True,
                         dtype=dtype)
    got = rt.radix_sort_builder(x).with_parallel(False).sort()
    if dtype.startswith("float"):
        nk = rkeys.normalize(x)
        if len(nk.words) == 1:
            order = np.argsort(np.asarray(nk.words[0]), kind="stable")
        else:
            hi, lo = (np.asarray(w) for w in nk.words)
            order = np.lexsort((lo, hi))
        want = x[order]
        u = f"uint{np.dtype(dtype).itemsize * 8}"
        np.testing.assert_array_equal(got.view(u), want.view(u))
    else:
        np.testing.assert_array_equal(got, np.sort(x))


def test_single_tile_regression(rng):
    """Histogram/scatter must be exact when input fits one tile
    (the reference's MtLsb single-tile regression, mt_lsb_sort.rs:323-328
    for GitHub issue #5)."""
    for n in (129, 2048, 2049, 4095):
        x = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
        got = rt.radix_sort_unstable(x)
        np.testing.assert_array_equal(got, np.sort(x))


def test_determinism(rng):
    """Same input => bitwise identical output, every plan (the XLA
    equivalent of the reference's race-freedom-by-construction story,
    SURVEY.md §5)."""
    x = rng.integers(0, 2**32, 100_000, dtype=np.int64).astype(np.uint32)
    v = np.arange(100_000, dtype=np.uint32)
    for algo in (rt.Algorithm.LSB, rt.Algorithm.SKA, rt.Algorithm.REGIONS,
                 rt.Algorithm.COMPARATIVE):
        r1 = rt.radix_sort_builder(x, [v]).with_algorithm(algo).with_stable(
            True).sort()
        r2 = rt.radix_sort_builder(x, [v]).with_algorithm(algo).with_stable(
            True).sort()
        np.testing.assert_array_equal(r1[0], r2[0])
        np.testing.assert_array_equal(r1[1][0], r2[1][0])


def test_f64_payload_stable_and_unstable(rng):
    """BASELINE config 2: f64 keys with payload, both modes."""
    n = 30_000
    f = rng.standard_normal(n)
    f[:8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0]
    v = np.arange(n, dtype=np.uint64)
    nk = rkeys.normalize(f)
    hi, lo = (np.asarray(w) for w in nk.words)
    order = np.lexsort((np.arange(n), lo, hi))
    for stable in (True, False):
        ks, vs = rt.sort_key_value(f, v, stable=stable)
        np.testing.assert_array_equal(
            ks.view(np.uint64), f[order].view(np.uint64)
        )
        if stable:
            np.testing.assert_array_equal(vs, v[order])
        else:
            # unstable: same multiset, keys aligned
            assert sorted(vs.tolist()) == v.tolist()


def test_u64_payload_parity_with_host_oracle(rng):
    """Device stable sort == native host runtime sort (bitwise row
    parity, the BASELINE north-star check)."""
    from rdst_tpu.native import host

    n = 200_000
    k = rng.integers(0, 2**16, n, dtype=np.uint64)  # duplicates guaranteed
    v = np.arange(n, dtype=np.uint32)
    dk, (dv,) = rt.radix_sort_builder(k, [v]).with_stable(True).sort()
    hk, hv = host.host_radix_sort(k.copy(), v.copy())
    np.testing.assert_array_equal(dk, hk)
    np.testing.assert_array_equal(dv, hv)
