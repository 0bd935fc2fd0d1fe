"""MSB bucketed plans: partition by the top byte, then per-bucket plans.

Re-design of the reference's MSB family — ``Ska`` (in-place bucket
scatter with dominant-bucket pre-partition, ska_sort.rs:52-112), ``MtOop``
(one out-of-place MSB pass then recursion, mt_lsb_sort.rs:197-235),
``Recombinating`` (tile sorts + bucket gather, recombinating_sort.rs:44-112)
and ``Scanning`` (huge-input MSB scatter, scanning_sort.rs:91-241). Their
shared shape: one most-significant partition, then independent per-bucket
work chosen by RE-CONSULTING the tuner per bucket (sorter.rs:121-171).

Under XLA's static shapes the data-dependent per-bucket recursion becomes:

  1. stable partition by the top TWO bytes (one 1-key-operand sort pass;
     the finer 16-bit order makes every bucket's next-level histogram a
     free searchsorted over the sorted combined plane),
  2. per-bucket depth-1 tuner picks from those histograms — the reference's
     per-chunk re-tuning (sorter.rs:134-138) at plan time,
  3. dominant buckets (whose padding would blow the batched layout) are
     CARVED OUT as contiguous static slices — the pod-scale ska rule
     (ska_sort.rs:52-65) on a single chip. A carved single-key bucket is
     detected by min==max device reductions and skipped entirely (the
     Zipf hot-key fast path); otherwise the bucket runs its own depth-1
     plan (packed radix for LSB-family picks, ``lax.sort`` otherwise).
  4. remaining buckets are padded into (256, cap) rows and sorted in ONE
     batched stable sort,
  5. ragged writeback of valid prefixes, splicing carved blocks back in
     bucket order.

Stability: the partition is stable, row pads start at the row tail, the
batched sort is stable, and carved buckets sort stably in place — so the
composition is stable.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu import config
from rdst_tpu.ops.ragged_concat import ragged_concat_multi
from rdst_tpu.sorts.comparative import comparative_sort
from rdst_tpu.tuner import Algorithm, TuningParams

__all__ = ["bucketed_sort"]

RADIX = 256
MAX_CARVED = 8  # static slices per sort; more would bloat the graph

#: Algorithm names that execute as the packed/compacted radix plan
_PACKED_FAMILY = frozenset(
    {Algorithm.LSB, Algorithm.LR_LSB, Algorithm.MT_LSB, Algorithm.SKA}
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _trace(msg: str) -> None:
    if config.work_profiles_enabled():
        print(msg)


def _level_byte(words, counts_levels: int, level: int) -> jax.Array:
    """The ``level``-th (LSB-first) byte of every key, as uint32 in [0,256)."""
    n_words = len(words)
    widx = n_words - 1 - (level // 4)
    shift = np.uint32((level % 4) * 8)
    return (words[widx] >> shift) & np.uint32(0xFF)


def _carve_plan(top: np.ndarray, n: int, max_expansion: float):
    """Pick buckets to carve out so the padded batched layout stays cheap.

    Greedy largest-first (the reference carves exactly one — the >50%
    bucket, ska_sort.rs:52-65; several can dominate under multi-hot skew).
    Returns (carved bucket ids ascending, row cap for the rest) or None if
    even MAX_CARVED carves can't tame the padding.
    """
    order = np.argsort(top)[::-1]
    carved: list[int] = []
    for k in range(MAX_CARVED + 1):
        rest_max = int(top[order[k]]) if k < RADIX else 0
        cap = _round_up(max(rest_max, 8), 8)
        if cap * (RADIX - k) <= max_expansion * max(n, 1):
            carved = sorted(int(b) for b in order[:k])
            return carved, cap
    return None


def bucketed_sort(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array],
    counts: np.ndarray | None,
    *,
    stable: bool = False,
    tuner=None,
    parallel: bool = True,
    max_expansion: float = 1.8,
) -> tuple[list[jax.Array], list[jax.Array]]:
    """Top-byte partition + per-bucket re-tuned plans + ragged writeback."""
    from rdst_tpu.ops.histogram import multi_level_histogram
    from rdst_tpu.sorts.lsb import packed_sort

    words = list(words)
    payloads = list(payloads)
    n = int(words[0].shape[0])
    if counts is None:
        return comparative_sort(words, payloads, stable=stable)
    if n > config.max_bucketed_elements:
        # compile-time guard: the padded-bucket graph's compile cost grows
        # steeply with n (config.max_bucketed_elements)
        _trace(
            f"(msb) FALLBACK: Comparative (n={n} > "
            f"max_bucketed_elements={config.max_bucketed_elements})"
        )
        return comparative_sort(words, payloads, stable=stable)
    top = counts[-1]  # most significant level histogram
    L = counts.shape[0]
    plan = _carve_plan(top, n, max_expansion)
    if plan is None:
        _trace("(msb) FALLBACK: Comparative (padding untameable)")
        return comparative_sort(words, payloads, stable=stable)
    carved, cap = plan

    # 1. stable partition by the top TWO bytes (16-bit combined key). The
    # extra byte costs nothing (still one u32 key operand) and its sorted
    # order yields every bucket's next-level histogram via searchsorted.
    top_b = _level_byte(words, L, L - 1)
    if L >= 2:
        combined = (top_b << np.uint32(8)) | _level_byte(words, L, L - 2)
    else:
        combined = top_b
    # stability of the partition is only needed for stable-mode output;
    # unstable mode may reorder within a bucket freely (any partition
    # order composes with the stable row stage into a valid unstable sort)
    part = jax.lax.sort(
        (combined,) + tuple(words) + tuple(payloads),
        num_keys=1,
        is_stable=stable,
    )
    part_planes = list(part[1:])
    n_words = len(words)

    starts_np = (np.cumsum(top) - top).astype(np.int64)

    # 2. per-bucket depth-1 re-tuning (reference: sorter.rs:121-171 re-picks
    # per 256-bucket). hist2[b] = bucket b's level-(L-2) histogram.  The
    # re-tune edges AND every carved bucket's single-key flag fetch in ONE
    # batched device round trip instead of one sync per bucket.
    edges_dev = None
    if tuner is not None and L >= 2:
        edges_dev = jnp.searchsorted(
            part[0], jnp.arange(RADIX * RADIX + 1, dtype=jnp.uint32),
            side="left",
        )
    single_dev = {}
    for b in carved:
        s, ln = int(starts_np[b]), int(top[b])
        if ln > 0:
            bw = [p[s : s + ln] for p in part_planes[:n_words]]
            single_dev[b] = jnp.stack(
                [jnp.min(w) == jnp.max(w) for w in bw]
            ).all()
    edges_np, single_key_flags = jax.device_get((edges_dev, single_dev))

    picks: dict[int, Algorithm] = {}
    if edges_np is not None:
        hist2 = (edges_np[1:] - edges_np[:-1]).reshape(RADIX, RADIX)
        for b in range(RADIX):
            ln = int(top[b])
            if ln == 0:
                continue
            picks[b] = tuner.pick_algorithm(
                TuningParams(
                    threads=8 if parallel else 1,
                    level=L - 2,
                    total_levels=L,
                    input_len=ln,
                    parent_len=n,
                ),
                hist2[b].tolist(),
            )
        if config.work_profiles_enabled():
            names: dict[str, int] = {}
            for b, a in picks.items():
                if b not in carved:
                    names[a.value] = names.get(a.value, 0) + 1
            summary = " ".join(f"{k}x{v}" for k, v in sorted(names.items()))
            _trace(f"({L - 2}) PLAN: BatchedRows[{summary}] cap={cap}")

    # 3. carved dominant buckets: contiguous static slices, each with its
    # own depth-1 plan (ska_sort.rs:52-65 brought down from pod scale).
    carved_out: dict[int, tuple[list, list]] = {}
    for b in carved:
        s, ln = int(starts_np[b]), int(top[b])
        if ln == 0:
            carved_out[b] = ([p[0:0] for p in part_planes[:n_words]],
                             [p[0:0] for p in part_planes[n_words:]])
            continue
        bw = [p[s : s + ln] for p in part_planes[:n_words]]
        bp = [p[s : s + ln] for p in part_planes[n_words:]]
        if bool(single_key_flags[b]):
            # Zipf hot-key fast path: nothing to sort; the stable
            # partition already left payloads in stable order.
            _trace(f"({L - 2}) PLAN: SingleKeySkip len={ln} bucket={b}")
            carved_out[b] = (bw, bp)
            continue
        algo = picks.get(b, Algorithm.COMPARATIVE)
        _trace(f"({L - 2}) PLAN: {algo.value} len={ln} bucket={b} (carved)")
        if algo in _PACKED_FAMILY:
            bhist = multi_level_histogram(bw, L)
            sw, sp = packed_sort(
                bw, bp, bhist.counts,
                stable=True if algo is not Algorithm.SKA else stable,
            )
        else:
            sw, sp = comparative_sort(bw, bp, stable=stable)
        carved_out[b] = (list(sw), list(sp))

    # 4. the rest: pad buckets into (256, cap) rows + one batched sort
    lengths_np = top.astype(np.int64).copy()
    for b in carved:
        lengths_np[b] = 0  # excluded rows contribute nothing
    lengths = lengths_np.astype(np.int32)  # host-side: static writeback
    starts = jnp.asarray(starts_np.astype(np.int32))
    pos = jax.lax.broadcasted_iota(jnp.int32, (RADIX, cap), 1)
    valid = pos < lengths[:, None]

    def extract(plane, fill):
        padded = jnp.concatenate(
            [plane, jnp.full((cap,), fill, plane.dtype)]
        )

        def row(s):
            return jax.lax.dynamic_slice(padded, (s,), (cap,))

        rows = jax.vmap(row)(starts)
        return jnp.where(valid, rows, fill)

    bucket_rows = [
        extract(p, np.uint32(0xFFFFFFFF) if i < n_words else p.dtype.type(0))
        for i, p in enumerate(part_planes)
    ]
    srt = jax.lax.sort(
        tuple(bucket_rows), num_keys=n_words, dimension=1, is_stable=True
    )

    # 5. writeback in bucket order, splicing carved blocks between ragged
    # ranges of batched rows (all offsets are host-static from `counts`).
    pieces: list[list[jax.Array]] = []
    b0 = 0
    bounds = carved + [RADIX]
    for b in bounds:
        if b > b0:
            seg_total = int(top[b0:b].sum())
            if seg_total > 0:
                rows_seg = [p[b0:b] for p in srt]
                pieces.append(
                    ragged_concat_multi(
                        rows_seg, lengths[b0:b], seg_total
                    )
                )
        if b < RADIX:
            cw, cp = carved_out[b]
            if cw and int(cw[0].shape[0]) > 0:
                pieces.append(list(cw) + list(cp))
        b0 = b + 1
    if not pieces:
        return words, payloads
    out = [
        jnp.concatenate([piece[i] for piece in pieces])
        for i in range(len(part_planes))
    ]
    return out[:n_words], out[n_words:]
