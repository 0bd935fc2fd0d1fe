"""End-to-end sort API tests, mirroring the reference's integration suite
(reference: src/radix_sort.rs:146-340 — all key types through the default
pipeline, low-mem tuner, custom tuner pass-through, float total-order
oracle)."""
import numpy as np
import pytest

import rdst_tpu as rt
from rdst_tpu import keys as rkeys


def np_sorted_oracle(x: np.ndarray) -> np.ndarray:
    """Reference-order oracle: sort by normalized key bits."""
    if x.dtype.kind == "f":
        nk = rkeys.normalize(x)
        if len(nk.words) == 1:
            k = np.asarray(nk.words[0])
            order = np.argsort(k, kind="stable")
        else:
            hi, lo = (np.asarray(w) for w in nk.words)
            order = np.lexsort((lo, hi))
        return x[order]
    return np.sort(x, kind="stable")


ALL_INT_TYPES = [
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
]


@pytest.mark.parametrize("dtype", ALL_INT_TYPES)
def test_default_pipeline_int(dtype, rng):
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, size=10_000, endpoint=True,
                     dtype=dtype)
    got = rt.radix_sort_unstable(x)
    assert isinstance(got, np.ndarray) and got.dtype == x.dtype
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_default_pipeline_float(dtype, rng):
    x = rng.standard_normal(10_000).astype(dtype)
    x[:16] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0] * 2
    got = rt.radix_sort_unstable(x)
    want = np_sorted_oracle(x)
    np.testing.assert_array_equal(
        got.view(np.uint32 if dtype == "float32" else np.uint64),
        want.view(np.uint32 if dtype == "float32" else np.uint64),
    )


def test_low_mem_tuner(rng):
    x = rng.integers(0, 2**32, size=50_000, dtype=np.uint32)
    got = rt.radix_sort_builder(x).with_low_mem_tuner().sort()
    np.testing.assert_array_equal(got, np.sort(x))


def test_single_threaded(rng):
    x = rng.integers(0, 2**32, size=50_000, dtype=np.uint32)
    got = (
        rt.radix_sort_builder(x)
        .with_parallel(False)
        .with_single_threaded_tuner()
        .sort()
    )
    np.testing.assert_array_equal(got, np.sort(x))


def test_custom_tuner_pass_through(rng):
    """Custom tuner is honored (reference: radix_sort.rs:319-327)."""
    picks = []

    class MyTuner:
        def pick_algorithm(self, p, counts):
            picks.append((p.level, p.input_len))
            return rt.Algorithm.COMPARATIVE

    x = rng.integers(0, 2**32, size=5_000, dtype=np.uint32)
    got = rt.radix_sort_builder(x).with_tuner(MyTuner()).sort()
    np.testing.assert_array_equal(got, np.sort(x))
    assert picks and picks[0] == (3, 5_000)


def test_empty_and_tiny():
    for n in (0, 1, 2, 5):
        x = np.arange(n, dtype=np.uint32)[::-1].copy()
        got = rt.radix_sort_unstable(x)
        np.testing.assert_array_equal(got, np.sort(x))


def test_already_sorted_short_circuit(rng):
    x = np.sort(rng.integers(0, 2**32, size=20_000, dtype=np.uint32))
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(got, x)


def test_key_value_stable(rng):
    """Stable mode: equal keys keep input order (LSB family contract)."""
    k = rng.integers(0, 16, size=5_000, dtype=np.uint8)
    v = np.arange(5_000, dtype=np.uint32)
    ks, vs = rt.sort_key_value(k, v, stable=True)
    np.testing.assert_array_equal(ks, np.sort(k))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(vs, v[order])


def test_key_value_payload64(rng):
    k = rng.integers(0, 2**32, size=3_000, dtype=np.uint32)
    v = rng.integers(0, 2**64, size=3_000, dtype=np.uint64)
    ks, vs = rt.sort_key_value(k, v, stable=True)
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks, k[order])
    np.testing.assert_array_equal(vs, v[order])


def test_argsort(rng):
    x = rng.integers(0, 1000, size=4_000, dtype=np.int32)
    idx = rt.argsort(x)
    np.testing.assert_array_equal(np.asarray(idx), np.argsort(x, kind="stable"))


def test_byte_array_keys(rng):
    x = rng.integers(0, 256, size=(2_000, 3), dtype=np.uint8)
    got = rt.radix_sort_unstable(x)
    rows = sorted(map(tuple, x.tolist()))
    assert list(map(tuple, got.tolist())) == rows


def test_composite_struct_keys(rng):
    """struct_sort-equivalent: multi-field key (u16, f32) with payload
    (reference: benches/struct_sort.rs + examples/impl_radix_key.rs)."""
    a = rng.integers(0, 2**16, size=2_000).astype(np.uint16)
    b = rng.standard_normal(2_000).astype(np.float32)
    payload = np.arange(2_000, dtype=np.uint32)
    (ka, kb), (vs,) = rt.radix_sort_builder((a, b), [payload]).with_stable(
        True
    ).sort()
    bkey = np.asarray(rkeys.normalize(b).words[0])
    order = np.lexsort((np.arange(2_000), bkey, a))
    np.testing.assert_array_equal(ka, a[order])
    np.testing.assert_array_equal(kb.view(np.uint32), b[order].view(np.uint32))
    np.testing.assert_array_equal(vs, payload[order])


def test_jax_input_returns_jax(rng):
    import jax.numpy as jnp

    x = jnp.asarray(rng.integers(0, 2**31, size=2_000, dtype=np.int32))
    got = rt.radix_sort_unstable(x)
    assert not isinstance(got, np.ndarray)
    np.testing.assert_array_equal(np.asarray(got), np.sort(np.asarray(x)))


def test_narrow_payloads_ride_u16(rng):
    """<=16-bit payloads ride as uint16 operands (half the bytes of a
    u32 rider) through every plan family."""
    import rdst_tpu as rt
    from rdst_tpu import config

    n = 30_000
    k = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    v16 = rng.integers(0, 2**16, size=n).astype(np.uint16)
    v8 = rng.integers(0, 250, size=n).astype(np.uint8)
    order = np.argsort(k, kind="stable")
    for algo in (rt.Algorithm.LSB, rt.Algorithm.MT_OOP,
                 rt.Algorithm.COMPARATIVE):
        ks, (a, b) = (
            rt.radix_sort_builder(k, [v16, v8])
            .with_algorithm(algo)
            .with_stable(True)
            .sort()
        )
        np.testing.assert_array_equal(ks, k[order], err_msg=str(algo))
        np.testing.assert_array_equal(a, v16[order], err_msg=str(algo))
        np.testing.assert_array_equal(b, v8[order], err_msg=str(algo))
        assert a.dtype == np.uint16 and b.dtype == np.uint8


def test_narrow_payloads_chunked_regions(rng, monkeypatch):
    from rdst_tpu import config
    import rdst_tpu as rt

    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)
    n = 20_000
    k = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    v = rng.integers(0, 2**16, size=n).astype(np.uint16)
    ks, (vs,) = (
        rt.radix_sort_builder(k, [v])
        .with_algorithm(rt.Algorithm.REGIONS)
        .with_stable(True)
        .sort()
    )
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks, k[order])
    np.testing.assert_array_equal(vs, v[order])
