"""Checks that need the card (marker ``gpu``); they skip elsewhere.

``chip_smoke.py`` runs them on the GPU in its own process.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rdst_tpu import keys as rkeys
from rdst_tpu.ops.histogram import multi_level_histogram

pytestmark = pytest.mark.gpu


def test_u32_sort_reaches_cub(gpu):
    """One u32 key operand compiles to CUB's radix sort."""
    x = jnp.arange(1 << 20, dtype=jnp.uint32)[::-1]
    text = jax.jit(jax.lax.sort).lower(x).compile().as_text()
    assert "DeviceRadixSort" in text


def test_histogram_on_device(gpu, rng):
    x = rng.integers(0, 2**64, size=1 << 22, dtype=np.uint64)
    x[: 1 << 20] = 7  # a hot bin: the partial histograms must still add up
    h = multi_level_histogram(rkeys.normalize(x).words, 8)
    for level in range(8):
        d = ((x >> np.uint64(8 * level)) & np.uint64(0xFF)).astype(np.int64)
        np.testing.assert_array_equal(h.counts[level],
                                      np.bincount(d, minlength=256))

