"""Regions plan: low-memory chunked sort with a bitonic merge tree.

Re-design of the reference's low-memory algorithms — ``Regions``
(Obeya et al. SPAA'19 in-place parallel radix: per-tile in-place sorts,
then an inter-region swap graph, regions_sort.rs:206-262) and the
low-memory role of ``Ska``. True in-place swaps don't exist in XLA's
functional model; the equivalent of "sort big data without 2x+
workspace" is to bound the *peak temporary footprint*:

  1. split the input into k equal chunks,
  2. sort each chunk separately (the sort's workspace scales with the
     chunk, not the whole array — peak extra ~2n/k),
  3. merge with a bitonic merge tree (ops/merge.py) whose stages are
     elementwise selects over static reshapes (O(n) temp per stage,
     XLA-fusable).

Like the reference's regions sort it trades extra passes over the data
for memory headroom (regions_sort.rs:3-10 cites the same tradeoff).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu.ops.merge import merge_many
from rdst_tpu.sorts.comparative import comparative_sort

__all__ = ["chunked_sort"]


def chunked_sort(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array],
    *,
    stable: bool = False,
    n_chunks: int = 4,
) -> tuple[list[jax.Array], list[jax.Array]]:
    """Low-memory plan: k chunk sorts + bitonic merge tree."""
    words = list(words)
    payloads = list(payloads)
    n = int(words[0].shape[0])
    n_words = len(words)
    if n < n_chunks * 2 or n_chunks < 2:
        return comparative_sort(words, payloads, stable=stable)

    # chunk length: power of two for the merge network; pad tail chunk
    m = 1
    while m * n_chunks < n:
        m *= 2
    total = m * n_chunks
    planes = words + payloads

    def padp(p, fill):
        return jnp.concatenate(
            [p, jnp.full((total - n,), fill, p.dtype)]
        ) if total > n else p

    planes = [
        padp(p, np.uint32(0xFFFFFFFF) if i < n_words else p.dtype.type(0))
        for i, p in enumerate(planes)
    ]

    # chunk sorts must be stable when (a) the API contract is stable, or
    # (b) payloads ride: a pad row ties with a real all-ones key and an
    # unstable sort could swap them, dropping a real payload at the
    # truncation. Keys-only unstable sorts skip the stability tax.
    stable_chunks = stable or bool(payloads)
    runs = []
    for c in range(n_chunks):
        chunk = [p[c * m : (c + 1) * m] for p in planes]
        cw, cp = comparative_sort(
            chunk[:n_words], chunk[n_words:], stable=stable_chunks
        )
        runs.append(cw + cp)

    merged = merge_many(runs, n_words, stable=True)
    out = [p[:n] for p in merged]
    return out[:n_words], out[n_words:]
