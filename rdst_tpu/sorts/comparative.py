"""Comparative sort plan: the dense executor, ``lax.sort``.

Role-equivalent of the reference's comparison fallback (reference:
src/sorts/comparative_sort.rs:5-51): the reference packs up to 16 radix
levels into accumulator integers and calls ``sort_unstable_by``; we hand the
normalized word planes to the dense executor as multiple keys (most
significant first).

Unlike the reference (which only uses this for <=128 items, sorter.rs:35-38)
this plan is usable at any size: it is XLA's ``lax.sort`` and the
correctness anchor for every other plan.
"""
from __future__ import annotations

from typing import Sequence

import jax

__all__ = ["comparative_sort"]


def comparative_sort(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array] = (),
    *,
    stable: bool = False,
) -> tuple[list[jax.Array], list[jax.Array]]:
    """Sort word planes (most significant first) + payloads."""
    words = list(words)
    operands = tuple(words) + tuple(payloads)
    out = jax.lax.sort(operands, num_keys=len(words), is_stable=stable)
    return list(out[: len(words)]), list(out[len(words):])
