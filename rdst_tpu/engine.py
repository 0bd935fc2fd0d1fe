"""Jittable static-plan sort entry points.

The Sorter (rdst_tpu.sorter) is the tuner-driven dispatcher with a host
sync for histogram inspection — the reference's architecture. This module
is the fully-jittable path used inside larger jitted programs (distributed
shuffle, table ops, benchmarks): the plan is chosen statically, at trace
time, from host-side histogram counts if the caller has them.

``sort_words`` is the single-device workhorse. Plans:

  auto         - packed level compaction when ``counts`` allow it
                 (sorts/lsb.py), else the comparative sort
  comparative  - XLA variadic lax.sort (sorts/comparative.py)
  packed       - force level compaction (requires ``counts``)
  bucketed     - MSB partition + batched per-bucket sorts (requires
                 ``counts``; sorts/msb.py)
  lowmem       - chunked low-memory sort (sorts/regions.py)

The tuner-driven equivalent for callers that want the full reference
dispatch semantics inside jit is ``Sorter.run(..., hist=...)`` with a
precomputed histogram (see rdst_tpu/sorter.py).
"""
from __future__ import annotations

from typing import Sequence

import jax
import numpy as np

from rdst_tpu.sorts.comparative import comparative_sort

__all__ = ["sort_words"]


def sort_words(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array] = (),
    *,
    stable: bool = False,
    plan: str = "auto",
    counts: np.ndarray | None = None,
):
    """Sort uint32 word planes (most significant first) + payloads.

    Fully traceable/jittable: no host syncs, static plan selection.

    ``counts`` is an optional host-side ``(L, 256)`` numpy histogram of
    the byte planes (from ``ops.histogram.multi_level_histogram(...)
    .counts``). It is static data consumed at trace time: with it,
    ``plan="auto"`` applies the level-compaction plan (drop constant byte
    planes, repack the rest into fewer sort operands — sorts/lsb.py),
    which is the reference's level-skipping optimization
    (lsb_sort.rs:62-83) in jit-compatible form. Counts must describe the
    same byte-plane distribution as the data being sorted (exact counts
    are not needed — only which planes are constant).
    """
    if plan == "auto":
        plan = "packed" if counts is not None else "comparative"
    if plan == "comparative":
        return comparative_sort(words, payloads, stable=stable)
    if plan == "packed":
        from rdst_tpu.sorts.lsb import packed_sort

        if counts is None:
            raise ValueError("plan='packed' requires counts")
        return packed_sort(words, payloads, counts, stable=stable)
    if plan == "bucketed":
        from rdst_tpu.sorts.msb import bucketed_sort

        if counts is None:
            raise ValueError("plan='bucketed' requires counts")
        return bucketed_sort(words, payloads, counts, stable=stable)
    if plan == "lowmem":
        from rdst_tpu.sorts.regions import chunked_sort

        return chunked_sort(words, payloads, stable=stable)
    raise ValueError(f"unknown plan {plan!r}")
