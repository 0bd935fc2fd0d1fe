"""Prefix-sum / offset primitives.

Equivalents of the reference's L1 offset helpers (reference:
src/sort_utils.rs:10-31 ``get_prefix_sums`` / ``get_end_offsets``). These
operate on tiny (R,) or (T, R) count tables, so plain XLA ``cumsum`` is
already optimal — no kernel needed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["exclusive_prefix_sum", "end_offsets"]


def exclusive_prefix_sum(counts: jax.Array, axis: int = -1) -> jax.Array:
    """Exclusive scan (get_prefix_sums, sort_utils.rs:10-20)."""
    return jnp.cumsum(counts, axis=axis) - counts


def end_offsets(counts: jax.Array, axis: int = -1) -> jax.Array:
    """Inclusive scan = one-past-the-end offsets (get_end_offsets,
    sort_utils.rs:23-31)."""
    return jnp.cumsum(counts, axis=axis)
