"""Bitonic merge of sorted multi-plane sequences (XLA-level).

Primitive behind the low-memory chunked plan (the reference's Regions sort
merges per-tile sorted runs, regions_sort.rs:206-262) and the distributed
post-exchange combine. Merging two sorted length-m runs takes log2(2m)
compare-exchange stages over the data.

All data movement is static reshapes + elementwise selects, one fused
XLA pass through device memory per stage.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["merge_sorted", "merge_many"]


def _lex_greater(keys_x, keys_y):
    """x > y lexicographically over key planes (most significant first)."""
    gt = jnp.zeros(keys_x[0].shape, jnp.bool_)
    eq = jnp.ones(keys_x[0].shape, jnp.bool_)
    for kx, ky in zip(keys_x, keys_y):
        gt = gt | (eq & (kx > ky))
        eq = eq & (kx == ky)
    return gt


def merge_sorted(
    planes_a: Sequence[jax.Array],
    planes_b: Sequence[jax.Array],
    n_keys: int,
    *,
    stable: bool = False,
) -> list[jax.Array]:
    """Merge two sorted plane-lists (first ``n_keys`` planes are the key,
    most significant first). The TOTAL length must be a power of two
    (equal halves is the common case; unequal splits — e.g. a long
    presorted prefix + a short sorted suffix — are fine: ascending-a then
    descending-b is bitonic wherever the peak sits). Pad with all-ones
    sentinel keys to reach a power of two; pads sort to the tail.

    ``stable=True`` appends a synthetic tiebreak plane (a-side before
    b-side, original order within side) so equal keys merge stably.
    """
    la = planes_a[0].shape[0]
    lb = planes_b[0].shape[0]
    total = la + lb
    if total & (total - 1):
        raise ValueError("merge_sorted needs a power-of-two total length")
    planes_a = list(planes_a)
    planes_b = list(planes_b)
    nk = n_keys
    if stable:
        ia = jax.lax.broadcasted_iota(jnp.uint32, (la, 1), 0).squeeze(-1)
        ib = jax.lax.broadcasted_iota(jnp.uint32, (lb, 1), 0).squeeze(-1)
        planes_a = planes_a[:nk] + [ia] + planes_a[nk:]
        planes_b = planes_b[:nk] + [ib + np.uint32(la)] + planes_b[nk:]
        nk = nk + 1

    # bitonic: concat(a, reverse(b)) then log2(total) split stages
    z = [jnp.concatenate([pa, pb[::-1]]) for pa, pb in zip(planes_a, planes_b)]
    s = total // 2
    while s >= 1:
        zs = [p.reshape(total // (2 * s), 2, s) for p in z]
        lo = [p[:, 0, :] for p in zs]
        hi = [p[:, 1, :] for p in zs]
        swap = _lex_greater(lo[:nk], hi[:nk])
        new_lo = [jnp.where(swap, h, l) for l, h in zip(lo, hi)]
        new_hi = [jnp.where(swap, l, h) for l, h in zip(lo, hi)]
        z = [
            jnp.stack([nl, nh], axis=1).reshape(total)
            for nl, nh in zip(new_lo, new_hi)
        ]
        s //= 2
    if stable:
        z = z[: n_keys] + z[n_keys + 1 :]
    return z


def merge_many(
    runs: Sequence[Sequence[jax.Array]], n_keys: int, *, stable: bool = False
) -> list[jax.Array]:
    """Merge k same-length sorted runs via a pairwise merge tree."""
    runs = [list(r) for r in runs]
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(
                merge_sorted(runs[i], runs[i + 1], n_keys, stable=stable)
            )
        if len(runs) % 2:
            nxt.append(runs[-1])
        # equalize lengths for the next level by re-pairing: merge_sorted
        # outputs 2m, an odd tail stays m — pad it to match when re-paired.
        # Key planes pad with the all-ones sentinel (sorts to the tail;
        # the padded run is always the LAST run, i.e. the b-side of its
        # pair, so stable-mode ties with real all-ones keys resolve
        # real-first); payload planes pad with zeros so no sentinel
        # "values" ever sit in payload planes.  Invariant for callers:
        # pads occupy exactly the output tail — slice [:real_total].
        mx = max(r[0].shape[0] for r in nxt)
        for j, r in enumerate(nxt):
            if r[0].shape[0] < mx:
                pad = mx - r[0].shape[0]
                nxt[j] = [
                    jnp.concatenate(
                        [p, jnp.full(
                            (pad,),
                            (np.iinfo(p.dtype).max
                             if jnp.issubdtype(p.dtype, jnp.integer)
                             else np.uint32(0xFFFFFFFF))
                            if i < n_keys
                            else (p.dtype.type(0)
                                  if jnp.issubdtype(p.dtype, jnp.number)
                                  else np.uint32(0)),
                            p.dtype,
                        )]
                    )
                    for i, p in enumerate(r)
                ]
        runs = nxt
    return runs[0]
