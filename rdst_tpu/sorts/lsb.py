"""LSB-family plans: stable sorts with histogram-driven level compaction.

Re-design of the reference's LSB algorithms (reference:
src/sorts/lsb_sort.rs:39-127 ``Lsb``, src/sorts/out_of_place_sort.rs
``LrLsb``). The reference's defining LSB optimizations are *level
skipping* (don't sort already-ordered or constant byte planes,
lsb_sort.rs:62-83) and skew awareness (LrLsb is picked under digit skew,
standard_tuner.rs:26-33). A ``lax.sort`` pass costs per *operand
array*, not per byte, so the equivalent optimization is **level
compaction**: byte levels whose histogram is a single spike are constants
— drop them and repack the varying bytes into the fewest uint32 words,
then run one stable variadic sort over the packed words. Constant bytes
are reinserted afterwards with pure bit ops.

For a u64 key with <= 4 varying bytes this halves the sort's key operands;
for wide composite keys (the struct_sort pattern) it collapses many words
into one or two. Skewed single-digit-dominant inputs are precisely the
low-entropy inputs where compaction bites — same signal, same regime as
the reference's skew ladder.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu.keys import digit_plane
from rdst_tpu.sorts.comparative import comparative_sort

__all__ = ["packed_sort", "compaction_plan"]


def compaction_plan(counts: np.ndarray) -> tuple[list[int], list[int | None]]:
    """From (L, 256) histograms: varying levels (LSB-first indices) and the
    constant byte per level (None if varying).

    The reference detects the same thing per pass at runtime
    (lsb_sort.rs:62-83); one multi-level histogram gives it up front.
    """
    L = counts.shape[0]
    varying: list[int] = []
    const_byte: list[int | None] = []
    n = counts[0].sum()
    for lvl in range(L):
        nz = np.nonzero(counts[lvl])[0]
        if len(nz) == 1 and counts[lvl][nz[0]] == n:
            const_byte.append(int(nz[0]))
        else:
            const_byte.append(None)
            varying.append(lvl)
    return varying, const_byte


def _pack_levels(words: Sequence[jax.Array], varying: list[int]):
    """Pack the varying byte levels (MSB-first) into tight words.

    The most significant packed word narrows to uint16 when it holds <= 2
    bytes, so a 6-byte key rides as (u16, u32) instead of (u32, u32) and
    the sort moves fewer bytes.
    """
    vb = len(varying)
    n_packed = max(1, -(-vb // 4))
    packed = [None] * n_packed
    # packed level p (0 = least significant) takes varying[p] (LSB-first)
    for p, lvl in enumerate(varying):
        widx = n_packed - 1 - (p // 4)
        shift = np.uint32((p % 4) * 8)
        byte = digit_plane(words, lvl, 8)
        contrib = byte << shift
        packed[widx] = contrib if packed[widx] is None else packed[widx] | contrib
    n = words[0].shape[0]
    out = [
        p if p is not None else jnp.zeros((n,), jnp.uint32) for p in packed
    ]
    msw_bytes = vb - 4 * (n_packed - 1)
    if msw_bytes == 1:
        out[0] = out[0].astype(jnp.uint8)
    elif msw_bytes == 2:
        out[0] = out[0].astype(jnp.uint16)
    return out


def _unpack_levels(
    packed: Sequence[jax.Array],
    varying: list[int],
    const_byte: list[int | None],
    n_words: int,
):
    """Rebuild original words from packed words + constant bytes."""
    n = packed[0].shape[0]
    L = len(const_byte)
    words = [jnp.zeros((n,), jnp.uint32) for _ in range(n_words)]
    vpos = {lvl: p for p, lvl in enumerate(varying)}
    for lvl in range(L):
        widx = n_words - 1 - (lvl // 4)
        shift = np.uint32((lvl % 4) * 8)
        if const_byte[lvl] is not None:
            byte = jnp.full((n,), np.uint32(const_byte[lvl]), jnp.uint32)
        else:
            byte = digit_plane(packed, vpos[lvl], 8).astype(jnp.uint32)
        words[widx] = words[widx] | (byte << shift)
    return words


def packed_sort(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array],
    counts: np.ndarray | None,
    *,
    stable: bool = True,
) -> tuple[list[jax.Array], list[jax.Array]]:
    """Level-compacted stable sort (the Lsb/LrLsb plan)."""
    words = list(words)
    n_bytes = counts.shape[0] if counts is not None else len(words) * 4
    if counts is None:
        return comparative_sort(words, payloads, stable=stable)
    varying, const_byte = compaction_plan(counts)
    if not varying:
        # every level constant: all keys equal — identity (stable)
        return words, list(payloads)
    n_packed = -(-len(varying) // 4)
    msw_bytes = len(varying) - 4 * (n_packed - 1)
    if (
        len(varying) == n_bytes
        and n_packed == len(words)
        and msw_bytes > 2
    ):
        # nothing to compact and no width to shave
        return comparative_sort(words, payloads, stable=stable)
    packed = _pack_levels(words, varying)
    out_packed, out_payloads = comparative_sort(
        packed, payloads, stable=stable
    )
    out_words = _unpack_levels(out_packed, varying, const_byte, len(words))
    return out_words, out_payloads
