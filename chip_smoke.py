#!/usr/bin/env python3
"""End-to-end check of rdst_tpu on NVIDIA GPUs, at real sizes.

    python chip_smoke.py                        # one GPU: every single-device phase
    python chip_smoke.py --four-cards           # four GPUs: the mesh phase only
    python chip_smoke.py --four-cards sorts     # ... its sort cases only
    python chip_smoke.py --four-cards tables    # ... its table cases only
    python chip_smoke.py --seed 7

Drives the public entry points (the builder API, ``engine.sort_words`` in
``jax.jit``, ``Table`` operators, ``rdst_tpu.parallel``) on inputs made
from ``--seed``, and compares every case with a plain numpy reference at
the timed size: integer and sorted keys bit-exactly, f64 keys by the IEEE
total-order golden of tests/test_keys.py, stable results against
``np.argsort(kind="stable")``, float sums within a stated tolerance. Each
case prints its name, size, PASS/FAIL, first-call (compile included) and
warm seconds, the plan picked, and the allocator's peak so far.

Exits 2 before any case when JAX finds no GPU, 1 when a case fails, and 0
after printing, as its last line, one JSON object naming the device.
Everything runs in this one process: a JAX process reserves most of a
card's memory, so a second one would fail.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# TPC-H SF10 row counts (TPC-H specification 2.17, clause 4.2.5).
SF10_ORDERS = 15_000_000
SF10_LINEITEM = 59_986_052
EPS32 = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes; ``shift`` divides the array sizes by 2**shift (the
    CPU tests run every case at a tiny size)."""

    shift: int = 0

    def n(self, log2: int) -> int:
        return 1 << max(log2 - self.shift, 8)

    @property
    def orders(self) -> int:
        return SF10_ORDERS if self.shift == 0 else 2_500

    @property
    def lineitem(self) -> int:
        return SF10_LINEITEM if self.shift == 0 else 10_000


@dataclasses.dataclass
class Case:
    """One timed call: ``run`` returns host data, ``check`` judges it and
    returns a note (or raises AssertionError)."""

    name: str
    n: int
    run: object
    check: object


# --------------------------------------------------------------------------
# numpy references
# --------------------------------------------------------------------------


@functools.cache
def _golden_module():
    """tests/test_keys.py, loaded from its file: a ``tests`` package
    installed elsewhere would shadow the repository's ``tests`` directory
    on import."""
    spec = importlib.util.spec_from_file_location(
        "rdst_test_keys", os.path.join(ROOT, "tests", "test_keys.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_float_key(x):
    """The IEEE total-order fold of tests/test_keys.py (the golden)."""
    return _golden_module().ref_float_key(x)


def same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = "shape" if a.shape != b.shape else int(np.sum(a != b))
        raise AssertionError(f"{what}: mismatch ({bad})")


def float_sums_ok(got, want, column):
    """Group sums are differences of one float32 prefix sum over the whole
    column (rdst_tpu/table/ops.py _segment_sum), so the error bound scales
    with the column's absolute total: 4 * eps32 * sum|x|. The device sums
    in another order than the CPU. No matrix product is on this path, so
    TF32 does not arise."""
    tol = 4 * EPS32 * float(np.sum(np.abs(column.astype(np.float64))))
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want),
                       initial=0.0))
    if not err <= tol:
        raise AssertionError(f"float sums: max |err| {err} > tol {tol}")
    return f"float sums: max |err| {err} vs tolerance {tol} (4*eps32*sum|x|)"


def stable_perm_ok(keys_in, keys_out, idx_out):
    """``idx_out`` is the stable sorting permutation of ``keys_in``: keys
    sorted, every row once, equal keys in input order. The stable
    permutation is unique, so this is equality with
    ``np.argsort(keys_in, kind="stable")`` at the cost of one np.sort (used
    where that timsort would cost a minute of four cards' time)."""
    same(keys_out, np.sort(keys_in), "keys")
    idx = np.asarray(idx_out).astype(np.int64)
    if np.bincount(idx, minlength=keys_in.shape[0]).max(initial=1) != 1:
        raise AssertionError("payload is not a permutation")
    same(keys_in[idx], keys_out, "keys[payload]")
    ties = keys_out[1:] == keys_out[:-1]
    if not np.all(idx[1:][ties] > idx[:-1][ties]):
        raise AssertionError("equal keys out of input order")


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


def u64(rng, n):
    return rng.integers(0, 2**64, size=n, dtype=np.uint64)


def u32(rng, n):
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def lineitem_orders(rng, sz: Sizes):
    """Lineitem- and orders-shaped columns at the TPC-H row counts: 1-7
    lineitems per order, sparse order keys (8 used of every 32, as dbgen
    makes them), four (returnflag, linestatus) groups, rows shuffled."""
    n_ord, n_li = sz.orders, sz.lineitem
    per = rng.integers(1, 8, size=n_ord)
    diff = n_li - int(per.sum())
    while diff:
        room = np.flatnonzero(per < 7) if diff > 0 else np.flatnonzero(per > 1)
        pick = rng.choice(room, size=min(abs(diff), room.size), replace=False)
        per[pick] += 1 if diff > 0 else -1
        diff = n_li - int(per.sum())
    idx = np.arange(n_ord, dtype=np.int64)
    okey = (idx // 8 * 32 + idx % 8 + 1).astype(np.int32)
    order_of_row = np.repeat(idx, per)
    perm = rng.permutation(n_li)
    order_of_row = order_of_row[perm]
    status_f = rng.random(n_li) < 0.5
    flag = np.where(status_f, rng.choice(3, size=n_li, p=[0.49, 0.49, 0.02]),
                    2).astype(np.uint8)  # 0=A 1=R 2=N
    lineitem = {
        "orderkey": okey[order_of_row],
        "quantity": rng.integers(1, 51, size=n_li).astype(np.int32),
        "extendedprice": (rng.random(n_li) * 104_000 + 900).astype(np.float32),
        "returnflag": flag,
        "linestatus": status_f.astype(np.uint8),
        "lid": np.arange(n_li, dtype=np.int32),
    }
    orders = {
        "orderkey": okey,
        "custkey": rng.integers(1, n_ord // 10 + 2, size=n_ord).astype(np.int32),
    }
    return lineitem, orders, order_of_row


# --------------------------------------------------------------------------
# one-card cases
# --------------------------------------------------------------------------


def dense_sort_lines(sz: Sizes):
    """``lax.sort`` inside jit at 2^28: one u32 operand, and a u64 key as
    two u32 operands. Reports whether the compiled HLO calls CUB's radix
    sort (XLA sends only simple sort forms there)."""
    import jax
    import jax.numpy as jnp

    n = sz.n(28)
    key = jax.random.key(0)
    planes = jax.random.bits(key, (2, n), jnp.uint32)
    lines = []
    for label, ops in (("u32 keys, 1 operand", (planes[0],)),
                       ("u64 keys as (hi, lo), 2 operands", (planes[0], planes[1]))):
        f = jax.jit(lambda *o: jax.lax.sort(o, num_keys=len(o)))
        compiled = f.lower(*ops).compile()
        cub = "DeviceRadixSort" in compiled.as_text()
        out = jax.block_until_ready(f(*ops))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(*ops))
            times.append(time.perf_counter() - t0)
        lo, hi = out[0][:-1], out[0][1:]
        ok = bool(jnp.all(lo <= hi))
        lines.append(
            f"lax.sort in jit n={n} {label}: CUB sort call={cub} "
            f"warm median {sorted(times)[1]:.6f}s sorted={ok}"
        )
        if not ok:
            raise AssertionError(lines[-1])
    return lines


def one_card_cases(rng, sz: Sizes):
    """Yields the single-device cases in order (inputs are made lazily, so
    only one case's arrays are alive at a time)."""
    import jax
    import jax.numpy as jnp

    import rdst_tpu as rt
    from rdst_tpu import config
    from rdst_tpu.engine import sort_words
    from rdst_tpu.ops.histogram import multi_level_histogram
    from rdst_tpu.parallel import (distributed_group_aggregate,
                                   distributed_sort, gather_valid, make_mesh)
    from rdst_tpu.table import Table
    from rdst_tpu.tuner import Algorithm

    for log2, maker in ((28, u64), (28, u32)):
        x = maker(rng, sz.n(log2))
        yield Case(f"radix_sort_unstable {x.dtype}", x.size,
                   lambda x=x: rt.radix_sort_unstable(x),
                   lambda y, x=x: same(y, np.sort(x), "keys"))

    k, v = u64(rng, sz.n(27)), u32(rng, sz.n(27))
    yield Case("sort_key_value u64+u32 stable", k.size,
               lambda: rt.sort_key_value(k, v, stable=True),
               lambda kv: _check_kv(kv, k, v))
    del k, v

    n = sz.n(28)
    hi, lo = jax.random.bits(jax.random.key(1), (2, n), jnp.uint32)
    f = jax.jit(lambda h, l: tuple(sort_words([h, l])[0]))
    want = np.sort((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                   | np.asarray(lo))
    yield Case("engine.sort_words in jit u64 (device-resident)", n,
               lambda: jax.block_until_ready(f(hi, lo)),
               lambda o: same((np.asarray(o[0]).astype(np.uint64)
                               << np.uint64(32)) | np.asarray(o[1]), want,
                              "keys"))
    del hi, lo, want

    x = u64(rng, sz.n(26))
    nk = rt.keys.normalize(x)
    yield Case("multi_level_histogram u64 (8 levels)", x.size,
               lambda: multi_level_histogram(nk.words, 8),
               lambda h: _check_hist(h, x))
    del nk

    x = rng.standard_normal(sz.n(26))
    for special in (np.nan, -np.nan, 0.0, -0.0):
        x[rng.choice(x.size, x.size // 64, replace=False)] = special
    yield Case("radix_sort_unstable f64 (+-NaN, +-0)", x.size,
               lambda: rt.radix_sort_unstable(x),
               lambda y: same(ref_float_key(y), np.sort(ref_float_key(x)),
                              "IEEE total-order bits"))

    n = sz.n(24)
    a = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    b = rng.standard_normal(n).astype(np.float32)
    b[:64] = [np.nan, -np.nan, 0.0, -0.0] * 16
    pay = np.arange(n, dtype=np.uint32)
    yield Case("composite (u16, f32) stable", n,
               lambda: rt.radix_sort_builder((a, b), [pay])
               .with_stable().sort(),
               lambda o: _check_composite(o, a, b, pay))

    x = np.minimum(rng.zipf(1.3, sz.n(26)), 2**32 - 1).astype(np.uint32)
    yield Case("radix_sort_unstable zipf(1.3) u32", x.size,
               lambda: rt.radix_sort_unstable(x),
               lambda y: same(y, np.sort(x), "keys"))

    x = np.full(sz.n(26), 0xC0FFEE, np.uint32)
    yield Case("radix_sort_unstable all-equal u32", x.size,
               lambda: rt.radix_sort_unstable(x),
               lambda y: same(y, x, "keys"))

    x = u64(rng, sz.n(26))
    cut = x.size * 9 // 10
    x[:cut] = np.sort(x[:cut])
    yield Case("radix_sort_unstable 90% presorted u64", x.size,
               lambda: rt.radix_sort_unstable(x),
               lambda y: same(y, np.sort(x), "keys"))

    x = u64(rng, sz.n(26))

    def forced_regions(x=x):
        old = config.low_mem_threshold_bytes
        config.low_mem_threshold_bytes = 1  # any working set is pressure
        try:
            return rt.radix_sort_builder(x).with_low_mem_tuner().sort()
        finally:
            config.low_mem_threshold_bytes = old

    yield Case("Regions low-memory plan u64 (forced)", x.size,
               forced_regions, lambda y: same(y, np.sort(x), "keys"))

    x = u32(rng, sz.n(26))
    yield Case("argsort u32 (stable)", x.size, lambda: rt.argsort(x),
               lambda i: same(i, np.argsort(x, kind="stable"), "indices"))

    x = u32(rng, sz.n(24))
    yield Case("bucketed MT_OOP plan u32", x.size,
               lambda: rt.radix_sort_builder(x)
               .with_algorithm(Algorithm.MT_OOP).sort(),
               lambda y: same(y, np.sort(x), "keys"))

    side = 1 << ((sz.n(24).bit_length() - 1) // 2)
    m = u32(rng, side * side).reshape(side, side)
    yield Case("batched_sort rows", m.size,
               lambda: np.asarray(rt.batched_sort(jnp.asarray(m))[0]),
               lambda y: same(y, np.sort(m, axis=-1), "rows"))
    k = min(64, side)
    yield Case(f"batched_top_k rows (k={k})", m.size,
               lambda: np.asarray(rt.batched_top_k(jnp.asarray(m), k)[0]),
               lambda y: same(y, np.sort(m, axis=-1)[:, ::-1][:, :k],
                              "top-k"))
    del m

    yield from table_cases(rng, sz, Table)

    n = sz.n(24)
    mesh1 = make_mesh(1)
    k, pay = u64(rng, n), np.arange(n, dtype=np.uint32)
    nk = rt.keys.normalize(k)

    def dsort():
        w, p, c = distributed_sort(list(nk.words), [jnp.asarray(pay)],
                                   mesh=mesh1, stable=True)
        hi, lo, idx = gather_valid(list(w) + list(p), c)
        return (hi.astype(np.uint64) << np.uint64(32)) | lo, idx

    def check_dsort(o):
        order = np.argsort(k, kind="stable")
        same(o[0], k[order], "keys")
        same(o[1], order, "payload (stable)")

    yield Case("distributed_sort 1-device mesh u64 stable", n, dsort,
               check_dsort)
    grp = rng.integers(0, n // 8, size=n).astype(np.int32)
    val = (rng.random(n) * 1000).astype(np.float32)
    t = Table({"grp": jnp.asarray(grp), "val": jnp.asarray(val)})
    yield Case("distributed_group_aggregate 1-device mesh", n,
               lambda: distributed_group_aggregate(
                   t, "grp", {"s": ("val", "sum"), "c": ("val", "count")},
                   mesh=mesh1),
               lambda o: _check_groups(o, grp, val))


def _check_kv(kv, k, v):
    order = np.argsort(k, kind="stable")
    same(kv[0], k[order], "keys")
    same(kv[1], v[order], "payload (stable)")


def _check_hist(h, x):
    for level in range(8):
        d = ((x >> np.uint64(8 * level)) & np.uint64(0xFF)).astype(np.int64)
        same(h.counts[level], np.bincount(d, minlength=256), f"level {level}")
        if bool(h.level_sorted[level]) != bool(np.all(d[1:] >= d[:-1])):
            raise AssertionError(f"level {level} sortedness")


def _check_composite(out, a, b, pay):
    (sa, sb), (sp,) = out
    order = np.lexsort((ref_float_key(b), a))  # stable, a most significant
    same(sa, a[order], "u16 field")
    same(np.asarray(sb).view(np.uint32), b[order].view(np.uint32), "f32 bits")
    same(sp, pay[order], "payload (stable)")


def _check_groups(out, grp, val):
    t, n_groups = out
    keys, inv = np.unique(grp, return_inverse=True)
    g = int(n_groups)
    if g != keys.size:
        raise AssertionError(f"{g} groups, want {keys.size}")
    got_k = np.asarray(t["grp"])[:g]
    order = np.argsort(got_k)  # hash partitioning orders groups by hash
    same(got_k[order], keys, "group keys")
    same(np.asarray(t["c"])[:g][order], np.bincount(inv), "counts")
    want = np.bincount(inv, weights=val.astype(np.float64))
    return float_sums_ok(np.asarray(t["s"])[:g][order], want, val)


def table_cases(rng, sz: Sizes, Table):
    """Table operators on lineitem / orders at SF10 row counts."""
    import jax.numpy as jnp

    li, orders, order_of_row = lineitem_orders(rng, sz)
    t = Table({c: jnp.asarray(a) for c, a in li.items()})
    o = Table({c: jnp.asarray(a) for c, a in orders.items()})
    n = sz.lineitem

    def check_sort(s):
        order = np.argsort(li["orderkey"], kind="stable")
        for c, a in li.items():
            same(s[c], a[order], c)

    yield Case("Table.sort_by orderkey", n,
               lambda: t.sort_by("orderkey").to_numpy(), check_sort)

    def check_filter(out):
        ft, cnt = out
        keep = li["quantity"] < 25
        if int(cnt) != int(keep.sum()):
            raise AssertionError("filter count")
        for c, a in li.items():
            same(np.asarray(ft[c])[: int(cnt)], a[keep], c)

    yield Case("Table.filter quantity<25", n,
               lambda: t.filter(t["quantity"] < 25), check_filter)

    def check_q1(out):
        g, cnt = out
        code = li["returnflag"].astype(np.int64) * 2 + li["linestatus"]
        keys, inv = np.unique(code, return_inverse=True)
        if int(cnt) != keys.size:
            raise AssertionError(f"{int(cnt)} groups, want {keys.size}")
        k = keys.size
        got_code = (np.asarray(g["returnflag"])[:k].astype(np.int64) * 2
                    + np.asarray(g["linestatus"])[:k])
        same(got_code, keys, "group keys")
        same(np.asarray(g["sum_qty"])[:k].astype(np.int64),
             np.bincount(inv, weights=li["quantity"]).astype(np.int64),
             "sum_qty")
        same(np.asarray(g["n"])[:k], np.bincount(inv), "count")
        want = np.bincount(inv, weights=li["extendedprice"].astype(np.float64))
        return float_sums_ok(np.asarray(g["sum_price"])[:k], want,
                             li["extendedprice"])

    yield Case("Table.group_aggregate 4 groups", n,
               lambda: t.group_aggregate(
                   ["returnflag", "linestatus"],
                   {"sum_qty": ("quantity", "sum"),
                    "sum_price": ("extendedprice", "sum"),
                    "n": ("quantity", "count")}),
               check_q1)

    def check_orders(out):
        g, cnt = out
        k = sz.orders
        if int(cnt) != k:
            raise AssertionError(f"{int(cnt)} groups, want {k}")
        same(np.asarray(g["orderkey"])[:k], orders["orderkey"], "keys")
        same(np.asarray(g["n"])[:k], np.bincount(order_of_row), "count")
        want = np.bincount(order_of_row,
                           weights=li["extendedprice"].astype(np.float64))
        return float_sums_ok(np.asarray(g["sum_price"])[:k], want,
                             li["extendedprice"])

    yield Case(f"Table.group_aggregate orderkey (~{sz.orders} groups)", n,
               lambda: t.group_aggregate(
                   "orderkey", {"sum_price": ("extendedprice", "sum"),
                                "n": ("extendedprice", "count")}),
               check_orders)

    def check_join(out):
        j, cnt = out
        if int(cnt) != n:
            raise AssertionError(f"{int(cnt)} matches, want {n}")
        same(j["lid"], li["lid"], "left order")
        same(j["custkey"], orders["custkey"][order_of_row], "custkey")

    yield Case("Table.join orders on orderkey", n,
               lambda: t.join(o, on="orderkey"), check_join)


# --------------------------------------------------------------------------
# four-card cases
# --------------------------------------------------------------------------


def fair_share_line(name, counts, n):
    counts = np.asarray(counts)
    fair = n / counts.size
    return (f"    {name}: rows per card {counts.tolist()}, fair share {fair}, "
            f"max/fair {counts.max() / fair:.6f}")


def four_card_cases(rng, sz: Sizes, part: str = "all"):
    """The mesh cases on a flat 4-device mesh (and one 2x2 mesh), all of
    them with the default (dense) exchange; ``part`` picks the ``sorts``
    or the ``tables`` half, so each half fits a shorter run."""
    import jax.numpy as jnp

    import rdst_tpu as rt
    from rdst_tpu.parallel import (distributed_sort, distributed_sort_auto,
                                   gather_valid, make_mesh, make_mesh_2d)
    from rdst_tpu.table import Table

    mesh = make_mesh(4)

    def sort_case(name, k, mesh, axis="shard", auto=False):
        n = k.size
        nk = rt.keys.normalize(k)
        pay = jnp.arange(n, dtype=jnp.uint32)
        fn = distributed_sort_auto if auto else distributed_sort

        def run():
            w, p, c = fn(list(nk.words), [pay], mesh=mesh, axis=axis,
                         stable=True)
            hi, lo, idx = gather_valid(list(w) + list(p), c)
            return (hi.astype(np.uint64) << np.uint64(32)) | lo, idx, c

        def check(o):
            stable_perm_ok(k, o[0], o[1])
            return fair_share_line(name, o[2], n)

        return Case(name, n, run, check)

    if part in ("all", "sorts"):
        yield sort_case("distributed_sort u64+u32 stable, 4 cards",
                        u64(rng, sz.n(28)), mesh)
        # clipped to the u32 range: the hot keys are single-key buckets,
        # which the partition splits by rank. Clipped at 2^62 instead, the
        # tail is spread over the high word and one card takes most rows
        # (ROADMAP R-skew).
        z = np.minimum(rng.zipf(1.2, sz.n(27)), 2**32 - 1).astype(np.uint64)
        yield sort_case("distributed_sort_auto zipf(1.2) u64 < 2^32, 4 cards",
                        z, mesh, auto=True)
        del z
        yield sort_case("distributed_sort u64 stable, 2x2 mesh",
                        u64(rng, sz.n(26)), make_mesh_2d(2, 2),
                        axis=("host", "chip"))
    if part in ("all", "tables"):
        yield from _four_card_table_cases(rng, sz, mesh, Table)


def _four_card_table_cases(rng, sz: Sizes, mesh, Table):
    import jax.numpy as jnp

    from rdst_tpu.parallel import (distributed_filter,
                                   distributed_group_aggregate,
                                   distributed_join)

    li, orders, order_of_row = lineitem_orders(rng, sz)
    t = Table({c: jnp.asarray(a) for c, a in li.items()})
    o = Table({c: jnp.asarray(a) for c, a in orders.items()})
    n = sz.lineitem
    mask = li["quantity"] < 25

    def check_filter(out):
        ft, counts = out
        counts = np.asarray(counts)
        lid = np.asarray(ft["lid"]).reshape(4, -1)
        got = np.concatenate([lid[d, : counts[d]] for d in range(4)])
        same(got, li["lid"][mask], "kept rows")
        return fair_share_line("distributed_filter", counts, int(mask.sum()))

    yield Case("distributed_filter quantity<25, 4 cards", n,
               lambda: distributed_filter(t, jnp.asarray(mask), mesh=mesh),
               check_filter)

    for part in ("range", "hash"):
        def check_agg(out):
            g, cnt = out
            k = sz.orders
            if int(cnt) != k:
                raise AssertionError(f"{int(cnt)} groups, want {k}")
            gk = np.asarray(g["orderkey"])[:k]
            order = np.argsort(gk)
            same(gk[order], orders["orderkey"], "keys")
            same(np.asarray(g["n"])[:k][order], np.bincount(order_of_row),
                 "count")
            want = np.bincount(order_of_row,
                               weights=li["extendedprice"].astype(np.float64))
            return float_sums_ok(np.asarray(g["sum_price"])[:k][order], want,
                                 li["extendedprice"])

        yield Case(f"distributed_group_aggregate orderkey {part}, 4 cards", n,
                   lambda part=part: distributed_group_aggregate(
                       t, "orderkey",
                       {"sum_price": ("extendedprice", "sum"),
                        "n": ("extendedprice", "count")},
                       mesh=mesh, partition=part),
                   check_agg)

        def check_join(out):
            j, cnt = out
            if int(cnt) != n:
                raise AssertionError(f"{int(cnt)} matches, want {n}")
            lid = np.asarray(j["lid"]).astype(np.int64)
            if np.bincount(lid, minlength=n).max() != 1:
                raise AssertionError("a lineitem row is missing or repeated")
            same(j["orderkey"], li["orderkey"][lid], "orderkey")
            same(j["custkey"], orders["custkey"][order_of_row[lid]],
                 "custkey")

        yield Case(f"distributed_join orders {part}, 4 cards", n,
                   lambda part=part: distributed_join(
                       t, o, "orderkey", mesh=mesh, partition=part),
                   check_join)


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


FOUR_CARD_PARTS = ("all", "sorts", "tables")


def select_phases(four_cards) -> list[str]:
    """Phases in run order: the four-card run is the mesh phase alone
    (``four_cards`` True or "all"), or one half of it ("sorts",
    "tables")."""
    if four_cards in (True, "all"):
        return ["mesh4"]
    if four_cards:
        return [f"mesh4:{four_cards}"]
    return ["dense_sort", "cases", "gpu_tests"]


def peak_bytes(jax) -> str:
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak} B"


def run_case(case: Case, jax, out=print) -> bool:
    """First call (compile included), warm call, check; one result line."""
    from rdst_tpu import config

    buf = io.StringIO()
    try:
        with config.work_profiles(True), contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            case.run()
            first = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = case.run()
        warm = time.perf_counter() - t0
        note = case.check(result)
        ok = True
    except Exception:  # report the case and go on; the exit code says FAIL
        ok, first, warm, note = False, float("nan"), float("nan"), None
        out(traceback.format_exc())
    plans = sorted({ln.strip() for ln in buf.getvalue().splitlines()
                    if "PLAN:" in ln})
    out(f"{case.name:<52} n={case.n:<10} {'PASS' if ok else 'FAIL'} "
        f"first={first:.6f}s warm={warm:.6f}s plan={plans} "
        f"peak={peak_bytes(jax)}")
    if note:
        out(f"    {note}")
    return ok


def card_lines() -> list[str]:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def run_phases(phases, rng, sz: Sizes, out=print) -> bool:
    import jax

    ok = True
    for phase in phases:
        if phase == "dense_sort":
            try:
                for line in dense_sort_lines(sz):
                    out(line)
            except Exception:
                ok = False
                out(traceback.format_exc())
        elif phase == "cases" or phase.startswith("mesh4"):
            cases = (one_card_cases(rng, sz) if phase == "cases" else
                     four_card_cases(rng, sz, phase.partition(":")[2] or "all"))
            try:
                for case in cases:
                    ok &= run_case(case, jax, out)
            except Exception:  # making a case's inputs failed
                ok = False
                out(traceback.format_exc())
        elif phase == "gpu_tests":
            import pytest

            rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                              os.path.join(ROOT, "tests", "test_gpu.py")])
            out(f"pytest -m gpu tests/test_gpu.py: exit {int(rc)}")
            ok &= int(rc) == 0
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", nargs="?", const="all", default=None,
                    choices=FOUR_CARD_PARTS,
                    help="run the 4-GPU mesh phase only (or its sorts or "
                         "tables half)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        print(f"need {want} GPUs, JAX sees {len(jax.devices())}",
              file=sys.stderr)
        return 2

    import jaxlib

    from rdst_tpu import config

    cards = card_lines()
    for line in cards:
        print(line)
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"compile cache: {config.enable_compile_cache()}")
    print(f"devices: {[d.device_kind for d in jax.devices()]}; "
          f"host_sort_max={config.host_sort_max} "
          f"low_mem_threshold={config.low_mem_threshold()} B")

    t0 = time.perf_counter()
    ok = run_phases(select_phases(args.four_cards),
                    np.random.default_rng(args.seed), Sizes(), print)
    print(f"total {time.perf_counter() - t0:.1f}s")
    if not ok:
        print("FAILED", file=sys.stderr)
        return 1
    for line in cards:
        print(line)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": want}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
