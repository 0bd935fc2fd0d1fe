"""Relational operators over columnar tables, built on the sort engine.

The BASELINE.json operator set (sort-based hash aggregate, filter,
sort-merge join), built from sort-friendly primitives:

  * cumsum                    — the aggregation workhorse (group sums are
                                prefix-sum differences at boundaries)
  * boundary gather (G << n)  — segment extraction
  * stable 1-bit partition    — filter/compaction
  * searchsorted              — merge-join probes

Whether scatter-add segment sums beat cumsum differences on the GPU is
open (ROADMAP.md, R-agg).

Static-shape discipline: filter/group outputs keep length n with a valid
``count`` (JAX cannot return data-dependent shapes from jit); host
helpers densify when needed.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu import keys as _keys
from rdst_tpu.builder import _encode_payload, _has_64bit_keys, _x64_enabled
from rdst_tpu.table.table import Table

__all__ = ["sort_by", "filter", "group_aggregate", "join"]

_AGG_OPS = ("sum", "count", "mean", "min", "max", "first", "last")


def _key_arrays(table: Table, by: Sequence[str] | str):
    by = [by] if isinstance(by, str) else list(by)
    return by, tuple(table.column(c) for c in by)


def _sort_rows(table: Table, by, *, stable=True, extra_key=None):
    """Sort all columns by the composite key of ``by`` columns.

    Returns (sorted Table, sorted key words list). ``extra_key``: optional
    (name) appended as the least significant key field (for min/max aggs).
    """
    by, key_cols = _key_arrays(table, by)
    fields = list(key_cols)
    if extra_key is not None:
        fields.append(table.column(extra_key))
    nk = _keys.normalize(tuple(fields)) if len(fields) > 1 else _keys.normalize(fields[0])
    key_names = by + ([extra_key] if extra_key else [])
    other = [c for c in table.column_names if c not in key_names]
    enc = [_encode_payload(table.column(c)) for c in other]
    payload_words = [w for e in enc for w in e[0]]
    out = jax.lax.sort(
        tuple(nk.words) + tuple(payload_words),
        num_keys=nk.n_words,
        is_stable=stable,
    )
    out_words = list(out[: nk.n_words])
    out_payloads = out[nk.n_words:]
    out_nk = _keys.NormalizedKeys(tuple(out_words), nk.n_bytes, nk.meta)
    if _has_64bit_keys(nk) and not _x64_enabled():
        # device denormalize would truncate 64-bit keys without x64
        sorted_keys = _keys.denormalize_host(out_nk)
    else:
        sorted_keys = _keys.denormalize(out_nk)
    if len(fields) == 1:
        sorted_keys = (sorted_keys,)
    cols = {}
    for name, val in zip(key_names, sorted_keys):
        cols[name] = val
    i = 0
    for name, (words, decode) in zip(other, enc):
        k = len(words)
        cols[name] = decode(list(out_payloads[i : i + k]))
        i += k
    return Table({c: cols[c] for c in table.column_names}), out_words


def sort_by(table: Table, by, *, stable: bool = True) -> Table:
    """ORDER BY over any composite column key (rdst order semantics)."""
    t, _ = _sort_rows(table, by, stable=stable)
    return t


def filter(table: Table, mask, *, return_count: bool = True):
    """Keep rows where ``mask`` is true, packed to the front (stable).

    Output keeps static length n; rows past ``count`` are the filtered-out
    remainder (also in stable order). Equivalent of a 1-bit radix pass
    (SURVEY.md §7: "filter = predicate -> prefix-sum compaction").
    """
    mask = jnp.asarray(mask)
    pred = jnp.where(mask, np.uint8(0), np.uint8(1))
    enc = [_encode_payload(table.column(c)) for c in table.column_names]
    payload_words = [w for e in enc for w in e[0]]
    out = jax.lax.sort(
        (pred,) + tuple(payload_words), num_keys=1, is_stable=True
    )
    count = jnp.sum(mask.astype(jnp.int32))
    cols = {}
    i = 1
    for name, (words, decode) in zip(table.column_names, enc):
        k = len(words)
        cols[name] = decode(list(out[i : i + k]))
        i += k
    t = Table(cols)
    return (t, count) if return_count else t


def _segment_starts(key_words: Sequence[jax.Array]):
    """Boolean mask: row starts a new key group (rows already sorted)."""
    n = key_words[0].shape[0]
    neq = jnp.zeros((n,), jnp.bool_)
    for w in key_words:
        neq = neq | (w != jnp.roll(w, 1))
    return neq.at[0].set(True)


def group_aggregate(
    table: Table,
    by,
    aggs: Mapping[str, tuple[str, str]],
    *,
    presorted: bool = False,
) -> tuple[Table, jax.Array]:
    """Sort-based GROUP BY (SURVEY.md §7: sort by group key -> segment
    boundaries -> segmented reductions).

    ``aggs``: {out_name: (column, op)} with op in sum/count/mean/min/max/
    first/last. Output table has static length n (one row per group packed
    to the front, `count` groups valid). Aggregations use the
    cumsum-at-boundaries trick.
    """
    by_list = [by] if isinstance(by, str) else list(by)
    for out_name, (col, op) in aggs.items():
        if op not in _AGG_OPS:
            raise ValueError(f"unsupported agg op {op!r}")

    # min/max need value-ordered segments; do them via dedicated sorts
    minmax = {k: v for k, v in aggs.items() if v[1] in ("min", "max")}
    plain = {k: v for k, v in aggs.items() if v[1] not in ("min", "max")}

    srt, key_words = _sort_rows(table, by_list, stable=True)
    n = srt.n_rows
    if n == 0:
        out_cols = {name: srt.column(name) for name in by_list}
        for out_name in aggs:
            out_cols[out_name] = jnp.zeros((0,), jnp.float32)
        return Table(out_cols), jnp.int32(0)
    starts = _segment_starts(key_words)
    seg_id = jnp.cumsum(starts.astype(jnp.int32)) - 1  # 0-based group index
    count = seg_id[-1] + 1

    # boundary index per group: positions of starts, packed densely via
    # stable partition of (not-start, position)
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    packed = jax.lax.sort(
        (jnp.where(starts, np.uint8(0), np.uint8(1)), pos),
        num_keys=1,
        is_stable=True,
    )[1]  # first `count` entries = group start positions
    gstart = packed
    # group end position: next group's start - 1; last valid group ends at
    # n-1. Slots >= count hold garbage but stay within [0, n) for safe takes.
    gidx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    gnext = jnp.roll(gstart, -1)
    gend = jnp.where(gidx == count - 1, jnp.int32(n - 1), gnext - 1)
    gend = jnp.clip(gend, 0, n - 1)

    out_cols = {}
    for name in by_list:
        out_cols[name] = jnp.take(srt.column(name), gstart)

    sizes = None
    for out_name, (col, op) in plain.items():
        c = srt.column(col) if col is not None else None
        if op == "count":
            if sizes is None:
                sizes = _segment_sizes(gstart, gend)
            out_cols[out_name] = sizes
        elif op in ("sum", "mean"):
            ssum = _segment_sum(c, gstart, gend)
            if op == "sum":
                out_cols[out_name] = ssum
            else:
                if sizes is None:
                    sizes = _segment_sizes(gstart, gend)
                out_cols[out_name] = ssum.astype(jnp.float32) / jnp.maximum(
                    sizes, 1
                )
        elif op == "first":
            out_cols[out_name] = jnp.take(c, gstart)
        elif op == "last":
            out_cols[out_name] = jnp.take(c, gend)

    value_sorted: dict = {}  # one (key, value)-ordered sort per column
    for out_name, (col, op) in minmax.items():
        # sort (key, value) pairs; min = first of segment, max = last
        if col not in value_sorted:
            value_sorted[col], _ = _sort_rows(
                table.select(by_list + [col]), by_list, stable=True,
                extra_key=col,
            )
        idx = gstart if op == "min" else gend
        out_cols[out_name] = jnp.take(value_sorted[col].column(col), idx)

    return Table(out_cols), count


def _segment_sizes(gstart, gend):
    return (gend - gstart + 1).astype(jnp.int32)


def _segment_sum(c, gstart, gend):
    """Exact segmented sums via cumsum differences at boundaries.

    Integer columns accumulate in int64 (x64) or uint32 modular
    arithmetic — wrapped-cumsum differences are exact as long as each
    group's true sum fits the accumulator width (float32 cumsum, by
    contrast, silently loses integer exactness past 2^24). Float columns
    accumulate in float64 when x64 is enabled.
    """
    x64 = jax.config.jax_enable_x64
    if jnp.issubdtype(c.dtype, jnp.integer) or c.dtype == jnp.bool_:
        acc_dt = jnp.int64 if x64 else jnp.uint32
    else:
        acc_dt = jnp.float64 if x64 else jnp.float32
    acc = jnp.cumsum(c.astype(acc_dt))
    ends = jnp.take(acc, gend)
    starts_excl = jnp.where(
        gstart > 0,
        jnp.take(acc, jnp.maximum(gstart - 1, 0)),
        jnp.zeros((), acc_dt),
    )
    return ends - starts_excl


def join(
    left: Table,
    right: Table,
    on,
    *,
    how: str = "inner",
    suffix: str = "_r",
) -> tuple[Table, jax.Array]:
    """Sort-merge equi-join over composite keys of ANY width; ``right``
    keys may repeat.

    Both sides are partitioned by the same normalized key order (the
    distributed pipeline hash/range-partitions both sides identically,
    SURVEY.md §7 step 7). Probe = lexicographic binary search into the
    sorted right side (:func:`_lex_searchsorted` — device-side for any
    number of key words).

    ``how="inner"``: output has exactly one row per (left row, matching
    right row) pair — duplicate right keys EXPAND, in left order then
    right sorted order — with length = match count (host-materialized;
    joins are host-driven operators). ``how="left"``: output keeps left's
    static length; duplicate right keys resolve to the FIRST match in
    right's sorted order (documented many-one behavior), unmatched rows
    carry zero-fill and ``_matched=False``.
    """
    if how not in ("inner", "left"):
        raise ValueError("how must be 'inner' or 'left'")
    on_list = [on] if isinstance(on, str) else list(on)
    rs, r_words = _sort_rows(right, on_list, stable=True)

    lk = _keys.normalize(
        tuple(left.column(c) for c in on_list)
        if len(on_list) > 1
        else left.column(on_list[0])
    )
    lo = _lex_searchsorted(r_words, list(lk.words), side="left")
    hi = _lex_searchsorted(r_words, list(lk.words), side="right")
    matched = hi > lo
    mult = hi - lo

    if how == "left":
        idx = jnp.clip(lo, 0, max(rs.n_rows - 1, 0))
        cols = {name: left.column(name) for name in left.column_names}
        for name in rs.column_names:
            if name in on_list:
                continue
            out_name = name + (suffix if name in left.column_names else "")
            cols[out_name] = jnp.take(rs.column(name), idx, mode="clip")
        cols["_matched"] = matched
        return Table(cols), jnp.sum(matched.astype(jnp.int32))

    # inner: expand duplicate matches. Output length is data-dependent —
    # one host sync for the total, then a static-shape gather plan.
    total = int(jnp.sum(mult))
    if total == 0:
        cols = {name: jnp.asarray(left.column(name))[:0]
                for name in left.column_names}
        for name in rs.column_names:
            if name in on_list:
                continue
            out_name = name + (suffix if name in left.column_names else "")
            cols[out_name] = jnp.asarray(rs.column(name))[:0]
        return Table(cols), jnp.int32(0)
    offs = jnp.cumsum(mult)  # inclusive; offs[i]-mult[i] = exclusive start
    j = jax.lax.broadcasted_iota(jnp.int32, (total, 1), 0).squeeze(-1)
    li = jnp.searchsorted(offs, j, side="right").astype(jnp.int32)
    li = jnp.clip(li, 0, lo.shape[0] - 1)
    k = j - jnp.take(offs - mult, li)
    ri = jnp.take(lo, li) + k
    cols = {}
    for name in left.column_names:
        cols[name] = jnp.take(left.column(name), li, mode="clip")
    for name in rs.column_names:
        if name in on_list:
            continue
        out_name = name + (suffix if name in left.column_names else "")
        cols[out_name] = jnp.take(rs.column(name), ri, mode="clip")
    return Table(cols), jnp.int32(total)


def _lex_searchsorted(sorted_words, query_words, *, side="left", bound=None):
    """Vectorized lexicographic binary search over multi-word u32 keys.

    ``sorted_words``: word planes of the (lexicographically) sorted haystack
    (most significant first); ``query_words``: same-width query planes.
    Returns insertion positions in [0, m] — ``side="left"`` counts strictly
    smaller haystack keys, ``side="right"`` counts smaller-or-equal. Runs
    fully on device for ANY word count (the reference's comparator packs up
    to 16 levels into one integer, comparative_sort.rs:29-51; multi-word
    keys here compare word-by-word with a prefix-equality chain).

    ``bound``: optional traced scalar limiting the search to the first
    ``bound`` haystack rows (capacity-padded buffers whose valid prefix
    length is data-dependent — the distributed join's case).

    Branchless power-of-two descent: log2(m) rounds, each a clipped gather
    of the candidate key + a lexicographic compare.
    """
    m = int(sorted_words[0].shape[0])
    nq = query_words[0].shape[0]
    pos = jnp.zeros((nq,), jnp.int32)
    if m == 0:
        return pos
    limit = jnp.int32(m) if bound is None else bound.astype(jnp.int32)
    want_leq = side == "right"

    def lex_le_lt(cand):
        """sorted[cand-1] < q  (or <= for side='right')."""
        at = jnp.clip(cand - 1, 0, m - 1)
        lt = jnp.zeros((nq,), jnp.bool_)
        eq = jnp.ones((nq,), jnp.bool_)
        for sw, qw in zip(sorted_words, query_words):
            s = jnp.take(sw, at)
            lt = lt | (eq & (s < qw))
            eq = eq & (s == qw)
        return (lt | eq) if want_leq else lt

    step = 1 << (m.bit_length() - 1)
    while step >= 1:
        cand = pos + step
        take = (cand <= limit) & lex_le_lt(cand)
        pos = jnp.where(take, cand, pos)
        step //= 2
    return pos
