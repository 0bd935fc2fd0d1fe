"""Large-size adversarial suites through the REAL dispatcher: bimodal and
bit-pattern inputs at 1M-5M, sizes where the carve-out / padding / chunk
logic of the tuned plans runs at representative shape (the reference's
release-mode suites go to 50M, test_utils.rs:63-146 + rust.yml:27-39;
chip_smoke.py runs the plans at 2^24-2^28 on the GPU).  No pinned tuner:
the StandardTuner picks whatever the histogram says, exactly like
production.
"""
import numpy as np
import pytest

import rdst_tpu as rt
from tests.helpers import gen_bimodal


@pytest.mark.slow
@pytest.mark.parametrize("shift", [0, 16])
@pytest.mark.parametrize("n", [1_000_000, 2_500_000])
def test_bimodal_u32_large(rng, n, shift):
    x = gen_bimodal(rng, n, np.dtype(np.uint32), shift)
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))


@pytest.mark.slow
@pytest.mark.parametrize("shift", [0, 32])
def test_bimodal_u64_large(rng, shift):
    n = 1_500_000
    x = gen_bimodal(rng, n, np.dtype(np.uint64), shift)
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))


@pytest.mark.slow
@pytest.mark.parametrize(
    "mask",
    [0xFF000000, 0x000000FF, 0xAAAAAAAA, 0x00FFFF00],
    ids=lambda m: f"0x{m:08X}",
)
def test_pattern_masks_large(rng, mask):
    """Masked-bit patterns at 2M: constant byte planes at natural tuner
    sizes drive the compaction plan's level dropping + narrow-MSW
    packing (u8/u16) through the dispatcher."""
    n = 2_000_000
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32) & np.uint32(mask)
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))


@pytest.mark.slow
def test_skew_outliers_large(rng):
    """A 5M spike distribution (5 outliers over one hot value): the skew
    ladder + single-key carve-out at representative size."""
    n = 5_000_000
    x = np.full(n, 0x0000_0100, dtype=np.uint32)
    x[:5] = [0xFFFFFFFF, 1, 2, 3, 0x80000000]
    perm = rng.permutation(n)
    x = x[perm]
    got = rt.radix_sort_unstable(x)
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))


@pytest.mark.slow
def test_bimodal_stable_payload_large(rng):
    """1M bimodal u64 + payload in stable mode: the stable fused-piece
    machinery (index plane, non-pow2 decomposition) at natural size."""
    n = 1_000_000
    x = gen_bimodal(rng, n, np.dtype(np.uint64), 32)
    v = np.arange(n, dtype=np.uint32)
    ks, vs = rt.sort_key_value(x, v, stable=True)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.asarray(ks), x[order])
    np.testing.assert_array_equal(np.asarray(vs), v[order])
