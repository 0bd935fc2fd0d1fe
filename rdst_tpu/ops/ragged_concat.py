"""Ragged row concatenation: write valid row prefixes densely.

The coarse-grained scatter primitive: given ``src`` (B, cap) whose row b
holds ``lengths[b]`` valid elements, write the valid prefixes densely into
a flat output at ``offsets[b]`` (exclusive prefix sums). This is the
writeback step of every bucketed plan (the reference's recombinating
phase 2 gather, recombinating_sort.rs:68-88) and of filter/compaction.

Implementation note: with traced lengths this is a sequential fori_loop
of read-modify-write ``dynamic_update_slice`` steps — B small fused
kernels, total traffic bounded by B*cap <= expansion*n.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu.ops.prefix import exclusive_prefix_sum

__all__ = ["ragged_concat_rows", "ragged_concat_multi"]


@functools.partial(jax.jit, static_argnames=("total",))
def ragged_concat_rows(
    src: jax.Array, lengths: jax.Array, total: int, fill: int = 0xFFFFFFFF
) -> jax.Array:
    """Concatenate valid row prefixes of ``src`` (B, cap) into (total,)."""
    return ragged_concat_multi([src], lengths, total, fill)[0]


def ragged_concat_multi(
    planes, lengths, total: int, fill: int = 0xFFFFFFFF
):
    """Same as :func:`ragged_concat_rows` for several (B, cap) planes that
    share one ragged structure (key words + payloads).

    When ``lengths`` is host-side numpy (the bucketed plan's case — bucket
    counts come from the plan-time histogram), the concatenation compiles
    to STATIC row-prefix slices + one fused XLA concatenate per plane —
    one parallel bandwidth-bound copy instead of the B-step sequential
    read-modify-write loop. The dynamic-lengths loop remains as the
    fallback for traced lengths."""
    if not isinstance(lengths, jax.Array):  # numpy / list => host-static
        lens = np.asarray(lengths).astype(np.int64)
        outs = []
        for p in planes:
            pieces = [p[b, : int(lens[b])] for b in range(len(lens))
                      if int(lens[b]) > 0]
            if not pieces:
                outs.append(jnp.full((total,), np.uint32(fill), p.dtype))
                continue
            cat = jnp.concatenate(pieces)
            if cat.shape[0] < total:
                cat = jnp.concatenate(
                    [cat, jnp.full((total - cat.shape[0],), np.uint32(fill),
                                   p.dtype)]
                )
            outs.append(cat[:total])
        return outs
    B, cap = planes[0].shape
    lengths = lengths.astype(jnp.int32)
    offsets = exclusive_prefix_sum(lengths)
    pos = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)

    outs = tuple(
        jnp.full((total + cap,), np.uint32(fill), dtype=p.dtype)
        for p in planes
    )

    def body(b, outs):
        ln = lengths[b]
        off = offsets[b]
        valid = pos < ln
        new = []
        for p, o in zip(planes, outs):
            row = jax.lax.dynamic_slice(p, (b, 0), (1, cap)).reshape(cap)
            cur = jax.lax.dynamic_slice(o, (off,), (cap,))
            merged = jnp.where(valid, row, cur)
            new.append(jax.lax.dynamic_update_slice(o, merged, (off,)))
        return tuple(new)

    outs = jax.lax.fori_loop(0, B, body, outs)
    return [o[:total] for o in outs]
