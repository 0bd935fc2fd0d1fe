"""Per-algorithm comparison suites (reference pattern: every algorithm
module runs sort_comparison_suite + pattern suites through a pinned
tuner — e.g. lsb_sort.rs:141-196, ska_sort.rs:127-171,
regions_sort.rs:301-351; test_utils.rs:264-278 sort_single_algorithm)."""
import numpy as np
import pytest

import rdst_tpu as rt
from helpers import (
    run_single_algorithm,
    sort_comparison_suite,
    u32_patterns,
)

ALGOS = list(rt.Algorithm)


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
@pytest.mark.parametrize("dtype,shift", [("uint32", 0), ("uint32", 16),
                                         ("uint64", 32), ("int32", 16)])
def test_algorithm_suite(algo, dtype, shift, rng):
    sort_comparison_suite(
        dtype,
        lambda x: run_single_algorithm(algo, x),
        rng,
        shift=shift,
        maxn=40_000,
    )


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_algorithm_patterns(algo, rng):
    for x in u32_patterns(rng):
        got = run_single_algorithm(algo, x)
        assert np.array_equal(got, np.sort(x)), f"{algo} pattern failed"


@pytest.mark.parametrize(
    "algo",
    [rt.Algorithm.LSB, rt.Algorithm.LR_LSB, rt.Algorithm.MT_LSB],
    ids=lambda a: a.value,
)
def test_lsb_family_stability(algo, rng):
    """LSB family must be stable (reference lib.rs contract)."""
    k = rng.integers(0, 8, size=20_000, dtype=np.uint8)
    v = np.arange(20_000, dtype=np.uint32)
    ks, (vs,) = rt.radix_sort_builder(k, [v]).with_algorithm(algo).sort()
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(vs, v[order])


def test_packed_sort_low_entropy(rng):
    """Level compaction: u64 keys with only 2 varying bytes."""
    x = (rng.integers(0, 2**16, size=30_000).astype(np.uint64)
         | np.uint64(0xAB00_0000_0000_0000))
    got = run_single_algorithm(rt.Algorithm.LSB, x)
    np.testing.assert_array_equal(got, np.sort(x))


def test_bucketed_skew_fallback(rng):
    """Extreme skew: bucketed plan must fall back, still correct.

    MT_OOP is the Algorithm that maps to the bucketed plan under the
    measured default registry (sorter.py)."""
    x = np.full(50_000, 0xDEADBEEF, dtype=np.uint32)
    x[:100] = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    got = run_single_algorithm(rt.Algorithm.MT_OOP, x)
    np.testing.assert_array_equal(got, np.sort(x))


def test_regions_payload(rng):
    k = rng.integers(0, 2**32, size=30_000, dtype=np.uint32)
    v = np.arange(30_000, dtype=np.uint32)
    ks, (vs,) = (
        rt.radix_sort_builder(k, [v])
        .with_algorithm(rt.Algorithm.REGIONS)
        .with_stable(True)
        .sort()
    )
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks, k[order])
    np.testing.assert_array_equal(vs, v[order])


def test_bucketed_payload_stable(rng):
    """Drives sorts/msb.py's padded-bucket pipeline (via MT_OOP, the
    bucketed Algorithm in the measured registry): real 0xFFFFFFFF keys
    must not mix with the row pads."""
    k = rng.integers(0, 2**32, size=50_000, dtype=np.uint32)
    k[::7] = 0xFFFFFFFF  # real max keys must not mix with row pads
    v = np.arange(50_000, dtype=np.uint32)
    ks, (vs,) = (
        rt.radix_sort_builder(k, [v])
        .with_algorithm(rt.Algorithm.MT_OOP)
        .with_stable(True)
        .sort()
    )
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks, k[order])
    np.testing.assert_array_equal(vs, v[order])


def test_remapped_names_still_correct(rng):
    """Recombinating/Scanning/Ska keep their reference tuner regimes but
    execute the measured-winner plans; pin them and check correctness."""
    for algo in (rt.Algorithm.RECOMBINATING, rt.Algorithm.SCANNING,
                 rt.Algorithm.SKA):
        x = rng.integers(0, 2**32, size=30_000, dtype=np.int64).astype(
            np.uint32
        )
        got = run_single_algorithm(algo, x)
        np.testing.assert_array_equal(got, np.sort(x))


class _Depth1Tuner:
    """MT_OOP at the top level, StandardTuner below — exercises the
    bucketed plan's per-bucket re-tuning (reference re-picks per 256-bucket
    at every recursion level, sorter.rs:121-171)."""

    def __init__(self):
        self._std = rt.StandardTuner()
        self.picks = []

    def pick_algorithm(self, p, counts):
        if p.depth == 0:
            return rt.Algorithm.MT_OOP
        algo = self._std.pick_algorithm(p, counts)
        self.picks.append((p.level, p.input_len, algo))
        return algo


def test_bucketed_per_bucket_retune_differs_from_depth0(rng):
    """Skewed-inside-uniform: depth-1 picks must differ from the depth-0
    pick AND from each other (hot bucket vs uniform buckets)."""
    n = 200_000
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    # one hot KEY inside an otherwise uniform distribution: ~35% of all
    # rows share one value => its bucket is skewed inside, others uniform
    hot = np.uint32(0x37AB_12CD)
    x[: int(n * 0.35)] = hot
    rng.shuffle(x)
    tuner = _Depth1Tuner()
    ks = rt.RadixSortBuilder(x).with_tuner(tuner).sort()
    np.testing.assert_array_equal(ks, np.sort(x))
    assert tuner.picks, "per-bucket re-tuning never consulted the tuner"
    picked = {a for (_, _, a) in tuner.picks}
    assert rt.Algorithm.MT_OOP not in picked  # depth-1 differs from depth-0
    assert len(picked) >= 2, f"expected diverse depth-1 picks, got {picked}"


def test_bucketed_dominant_bucket_no_fallback(rng, capsys):
    """A 50% hot key no longer degrades MT_OOP to wholesale comparative:
    the dominant bucket is carved out (single-key skip) and the rest stays
    batched (ska_sort.rs:52-65 on one device)."""
    from rdst_tpu import config

    n = 120_000
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    x[(x >> 24) == 0x55] ^= np.uint32(1 << 24)  # keep top byte 0x55 pure
    x[: n // 2] = np.uint32(0x5555_AAAA)
    rng.shuffle(x)
    v = np.arange(n, dtype=np.uint32)
    with config.work_profiles(True):
        ks, (vs,) = (
            rt.radix_sort_builder(x, [v])
            .with_algorithm(rt.Algorithm.MT_OOP)
            .with_stable(True)
            .sort()
        )
        trace = capsys.readouterr().out
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(ks, x[order])
    np.testing.assert_array_equal(vs, v[order])
    assert "FALLBACK" not in trace, trace
    assert "SingleKeySkip" in trace, trace


def test_bucketed_dominant_multikey_carve(rng):
    """Dominant bucket with MANY distinct keys: carved and sorted via its
    own depth-1 plan (not skipped)."""
    n = 100_000
    # 60% of keys share the top byte 0x42 but vary below
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    hot = (rng.integers(0, 2**24, size=int(n * 0.6), dtype=np.int64)
           .astype(np.uint32) | np.uint32(0x42000000))
    x[: hot.shape[0]] = hot
    rng.shuffle(x)
    got = run_single_algorithm(rt.Algorithm.MT_OOP, x)
    np.testing.assert_array_equal(got, np.sort(x))


def test_regions_low_mem_engages_chunked(rng, monkeypatch):
    """Under real memory pressure REGIONS takes the chunked low-memory
    machinery (the resource contract); below it, the compaction plan,
    which skips the merge tree's extra passes."""
    from rdst_tpu import config

    k = rng.integers(0, 2**32, size=40_000, dtype=np.int64).astype(np.uint32)
    v = np.arange(40_000, dtype=np.uint32)
    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)  # force chunked
    ks, (vs,) = (
        rt.radix_sort_builder(k, [v])
        .with_algorithm(rt.Algorithm.REGIONS)
        .with_stable(True)
        .sort()
    )
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks, k[order])
    np.testing.assert_array_equal(vs, v[order])


def test_regions_chunked_unstable_keys_only(rng, monkeypatch):
    """Keys-only unstable chunked sorts skip the stability tax (no iota
    plane in the chunk sorts) yet still handle pad rows correctly —
    incl. real all-ones keys that tie with the pad sentinel."""
    from rdst_tpu import config

    n = 40_000  # non-pow2 chunking with a padded final chunk
    k = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    k[:64] = np.uint32(0xFFFFFFFF)  # ties with the pad sentinel
    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)  # force chunked
    got = (
        rt.radix_sort_builder(k)
        .with_algorithm(rt.Algorithm.REGIONS)
        .with_stable(False)
        .sort()
    )
    np.testing.assert_array_equal(got, np.sort(k))
