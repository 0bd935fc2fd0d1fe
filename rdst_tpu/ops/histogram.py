"""Multi-level digit histograms with sortedness detection (plain XLA).

Re-design of the reference's counting primitives (reference:
src/sort_utils.rs:35-249 — ``get_counts_with_ends`` fuses the histogram scan
with monotonicity detection; ``get_tile_counts`` computes per-tile histograms
and merges cross-tile boundary sortedness; ``aggregate_tile_counts`` sums).

A digit plane's *global* histogram is permutation-invariant, so one
jitted call at plan time yields the histograms of EVERY level — the
reference re-counts per level (lsb_sort.rs:62-83). Each level is a digit
shift and mask that XLA fuses into a scatter-add, plus an adjacent
compare for sortedness.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu.keys import digit_plane

RADIX = 256

__all__ = ["HistogramResult", "multi_level_histogram", "level_histogram"]


@dataclasses.dataclass(frozen=True)
class HistogramResult:
    """Per-level global histograms + sortedness, fetched to host for planning.

    ``counts[l]`` is the 256-bin histogram of byte-level ``l`` (0 = least
    significant). ``level_sorted[l]`` is True iff the digit sequence of level
    ``l`` is globally nondecreasing *in the current array order* — exactly
    the reference's already-sorted short-circuit signal (sorter.rs:59-65):
    a stable counting-sort pass on a nondecreasing digit sequence is the
    identity, so the pass can be skipped.
    """

    counts: np.ndarray  # (L, 256) int64
    level_sorted: np.ndarray  # (L,) bool
    #: Length of the longest lexicographically-nondecreasing PREFIX of the
    #: full key (all word planes).  Powers the presorted-input advantage
    #: (reference analog: lsb_sort.rs:62-83 re-counts per pass to skip
    #: newly-sorted work; benches/struct_sort.rs:43-127 measures
    #: 90%-presorted inputs): a long sorted prefix lets the sorter sort
    #: only the suffix and bitonic-merge the halves.  0 when not computed.
    sorted_prefix: int = 0

    @property
    def n(self) -> int:
        return int(self.counts[0].sum())

    def constant_levels(self) -> np.ndarray:
        """Levels where one digit holds everything — skippable forever."""
        return (self.counts.max(axis=1) == self.counts.sum(axis=1)).astype(bool)

    def fully_sorted(self) -> bool:
        return bool(self.level_sorted.all())


#: Partial histograms per level: element ``i`` counts into row
#: ``i % _ROWS``, so neighbouring elements (one GPU warp) add into
#: different counters. A single 256-bin scatter serialises its atomics on
#: the hot bins of skewed, sorted or all-equal inputs.
_ROWS = 1024


def _digit(words, level: int) -> jax.Array:
    """Byte ``level`` (0 = least significant) of every key, as int32."""
    return digit_plane(words, level, 8).astype(jnp.int32)


def _bincount(d: jax.Array) -> jax.Array:
    """(256,) int32 counts of the digits in ``d``."""
    n = d.shape[0]
    rows = min(_ROWS, max(n, 1))
    total = -(-n // rows) * rows
    # pad slots index bin 256, which mode="drop" discards
    d = jnp.pad(d, (0, total - n), constant_values=RADIX)
    lane = jax.lax.broadcasted_iota(jnp.int32, (total // rows, rows), 1)
    partial = jnp.zeros((rows, RADIX), jnp.int32).at[
        lane, d.reshape(total // rows, rows)
    ].add(1, mode="drop")
    return jnp.sum(partial, axis=0)


@functools.partial(jax.jit, static_argnames=("n_bytes",))
def _multi_level_device(words, n_bytes: int):
    """Device part: (L, 256) int32 counts, (L,) sorted flags, prefix."""
    n = words[0].shape[0]
    counts, level_sorted = [], []
    for level in range(n_bytes):
        d = _digit(words, level)
        counts.append(_bincount(d))
        level_sorted.append(jnp.all(d[1:] >= d[:-1]))
    # longest lexicographically-nondecreasing prefix over the FULL key,
    # in this same jit so the planning fetch stays one device round trip.
    # A strict descent at i means prefix length i+1.
    gt = jnp.zeros((max(n - 1, 0),), jnp.bool_)
    eq = jnp.ones_like(gt)
    for w in words:
        a, b = w[:-1], w[1:]
        gt = gt | (eq & (a > b))
        eq = eq & (a == b)
    if n > 1:
        first_desc = jnp.argmax(gt).astype(jnp.int32)  # 0 if none set
        prefix = jnp.where(jnp.any(gt), first_desc + 1, n).astype(jnp.int32)
    else:
        prefix = jnp.int32(n)
    return jnp.stack(counts), jnp.stack(level_sorted), prefix


def multi_level_histogram(words, n_bytes: int) -> HistogramResult:
    """All-level histograms + sortedness in one jitted call (host result).

    The planning sync point: 256*L ints is tiny, and the reference pays the
    same host-visible cost when its tuner inspects counts (sorter.rs:55-76).
    """
    counts, level_sorted, prefix = jax.device_get(
        _multi_level_device(tuple(words), n_bytes)
    )
    return HistogramResult(
        counts.astype(np.int64), np.asarray(level_sorted), int(prefix)
    )


@functools.partial(jax.jit, static_argnames=("level",))
def level_histogram(words, level: int) -> jax.Array:
    """Single-level 256-bin histogram; stays on device."""
    return _bincount(_digit(words, level))
