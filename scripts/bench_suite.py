"""Benchmark suite covering the BASELINE.md driver configs.

  1. 10M uniform u32 (reference basic_sort)
  2. u64 and f64 keys + payload, stable and unstable
  3. composite struct keys (u16, f32, u32 payload — struct_sort)
  4. skewed/Zipfian distributions (tuner selection / low-mem regime)
  5. distributed pipeline — covered by tests/test_dtable.py + dryrun
     (mesh scaling: scripts/bench_mesh.py)

Every config runs the REAL dispatcher path: the multi-level histogram is
computed on device and the pluggable tuner picks the plan (exactly the
reference's flow, sorter.rs:55-76); the pick happens at trace time so the
timed loop measures the tuner-chosen plan's device execution. Iterations
re-randomize the input with a plane-preserving XOR rehash — a bijection
that permutes each byte-plane's histogram buckets without changing their
shape, so duplicate structure, skew and constant-plane decisions stay
valid while the sorted-input short circuit is defeated.

Run on the GPU host:  python scripts/bench_suite.py
Prints one JSON line per config (same schema as bench.py).
"""
import json
import time

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def bench_injit(step, args, iters=None):
    """step: tuple -> same-structure tuple. Chained through the loop so
    XLA cannot hoist the loop-invariant body.

    ``iters`` scales inversely with input size so small inputs run long
    enough for the once-vs-many difference to stand above host timing
    noise."""
    import jax
    import jax.numpy as jnp

    if iters is None:
        n = int(args[0].shape[0])
        iters = max(6, min(256, int(1e8 // max(n, 1))))

    @jax.jit
    def once(a):
        r = step(a)
        return jnp.sum(r[0][:4].astype(jnp.float32)), r

    @jax.jit
    def many(a):
        r = jax.lax.fori_loop(0, iters, lambda i, x: step(x), a)
        return jnp.sum(r[0][:4].astype(jnp.float32))

    jax.block_until_ready(once(args))
    t0 = time.perf_counter(); jax.block_until_ready(once(args))
    t1 = time.perf_counter() - t0
    jax.block_until_ready(many(args))
    t0 = time.perf_counter(); jax.block_until_ready(many(args))
    tm = (time.perf_counter() - t0 - t1) / (iters - 1)
    return max(tm, 1e-9)


def emit(metric, n, seconds, extra=None):
    rec = {
        "metric": metric,
        "value": round(n / seconds),
        "unit": "keys/s",
        "vs_baseline": round(n / seconds / 1e9, 4),
    }
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def dispatcher_step(n_words, n_bytes, stable, hist, sorter, scramble):
    """Build a jittable step running the tuner-chosen plan.

    The tuner consultation happens when this closure is traced (host-side
    numpy hist), mirroring sorter.rs:67-76; only the chosen plan's device
    program is timed.
    """
    import dataclasses

    from rdst_tpu.keys import NormalizedKeys

    def step(a):
        ws, ps = list(a[:n_words]), list(a[n_words:])
        ws = scramble(ws)
        nk = NormalizedKeys(tuple(ws), n_bytes, ("dtype", np.dtype(np.uint32)))
        out_nk, out_ps = sorter.run(nk, ps, stable=stable, hist=hist)
        return tuple(out_nk.words) + tuple(out_ps)

    return step


def xor_scramble(ws):
    """Plane-preserving rehash: XOR each word with a fixed odd constant.

    Bijective; permutes each byte-plane's histogram buckets (constant
    planes stay constant, skew magnitudes unchanged) while scrambling
    sort order so the already-sorted short circuit never fires between
    iterations. Safe for plans whose static decisions depend only on
    histogram SHAPE (compaction, tuner ladders) — not for plans using
    absolute bucket offsets (the bucketed MSB plan recomputes its own)."""
    C = np.uint32(0xB5A93E6B)
    return [w ^ C for w in ws]


def suffix_scramble(s):
    """Rehash only the tail beyond ``s``: the presorted-prefix plan's
    correctness (and the benched regime) depends on the prefix staying
    sorted across iterations — exactly struct_sort.rs:43-127's fixed
    90%-presorted inputs."""

    def scramble(ws):
        C = np.uint32(0xB5A93E6B)
        import jax.numpy as jnp

        return [jnp.concatenate([w[:s], w[s:] ^ C]) for w in ws]

    return scramble


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,6",
                    help="comma-separated subset of configs to run")
    opts = ap.parse_args()
    run = set(opts.configs.split(","))

    import jax.numpy as jnp
    from rdst_tpu import keys as rkeys
    from rdst_tpu.ops.histogram import multi_level_histogram
    from rdst_tpu.sorter import Sorter

    rng = np.random.default_rng(0)
    sorter = Sorter()

    def bench_config(metric, words_np, payloads_np, n_bytes, stable,
                     scramble=xor_scramble):
        ws = [jnp.asarray(w) for w in words_np]
        ps = [jnp.asarray(p) for p in payloads_np]
        hist = multi_level_histogram(ws, n_bytes)
        algo = None
        if not hist.fully_sorted():
            from rdst_tpu.sorter import DEFAULT_THREADS
            from rdst_tpu.tuner import TuningParams

            params = TuningParams(
                threads=DEFAULT_THREADS, level=n_bytes - 1,
                total_levels=n_bytes, input_len=int(ws[0].shape[0]),
            )
            algo = sorter.tuner.pick_algorithm(
                params, hist.counts[n_bytes - 1].tolist()
            ).value
        step = dispatcher_step(
            len(ws), n_bytes, stable, hist, sorter, scramble
        )
        t = bench_injit(step, tuple(ws) + tuple(ps))
        n = int(ws[0].shape[0])
        emit(metric, n, t, extra={"plan": algo})

    n = 10_000_000
    pay = [np.arange(n, dtype=np.uint32)]

    if "1" in run:
        w = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
        bench_config("c1_u32_10M_uniform", [w], [], 4, stable=False)

    if "2" in run:
        w2 = [rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
              for _ in range(2)]
        bench_config("c2_u64_payload_unstable_10M", w2, pay, 8, stable=False)
        bench_config("c2_u64_payload_stable_10M", w2, pay, 8, stable=True)

        f = rng.standard_normal(n)
        nkf = rkeys.normalize(f)
        wf = [np.asarray(x) for x in nkf.words]
        bench_config("c2_f64_payload_stable_10M", wf, pay, 8, stable=True)

    if "3" in run:
        # config 3: composite struct key (u16, f32) + u32 payload
        a16 = rng.integers(0, 2**16, n).astype(np.uint16)
        b32 = rng.standard_normal(n).astype(np.float32)
        nk3 = rkeys.normalize((a16, b32))
        w3 = [np.asarray(x) for x in nk3.words]
        assert len(w3) == 2  # 6 key bytes -> 2 words
        bench_config("c3_struct_key_payload_10M", w3, pay, nk3.n_bytes,
                     stable=True)

    if "4" in run:
        # config 4: Zipfian u32 (skew regime — exercises the tuner's skew
        # ladder; XOR rehash preserves the skew between iterations)
        z = (rng.zipf(1.3, n) % (2**31)).astype(np.uint32)
        nz = rkeys.normalize(z)
        wz = [np.asarray(x) for x in nz.words]
        bench_config("c4_zipf_u32_10M", wz, [], 4, stable=False)

    if "6" in run:
        # config 6: 90%-presorted inputs (struct_sort.rs:43-127 benches
        # 409k 16-byte structs at 90% presorted). Only the random tail is
        # rehashed between iterations so the regime persists.
        ns = 409_600
        cut = int(ns * 0.9)
        a16 = rng.integers(0, 2**16, ns).astype(np.uint16)
        b32 = rng.standard_normal(ns).astype(np.float32)
        nk6 = rkeys.normalize((a16, b32))
        w6 = []
        for x in nk6.words:
            x = np.asarray(x).copy()
            w6.append(x)
        # sort the prefix lexicographically across word planes; force a
        # descent AT the cut so the measured prefix never extends into
        # the (rehashed-between-iterations) tail
        order = np.lexsort([w[:cut] for w in w6][::-1])
        for w in w6:
            w[:cut] = w[:cut][order]
        w6[0][cut] = 0
        bench_config(
            "c6_struct_409k_90presorted", w6,
            [np.arange(ns, dtype=np.uint32)], nk6.n_bytes, stable=False,
            scramble=suffix_scramble(cut),
        )

        cut10 = int(n * 0.9)
        wp = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
        wp[:cut10] = np.sort(wp[:cut10])
        wp[cut10] = 0
        bench_config(
            "c6_u32_10M_90presorted", [wp], [], 4, stable=False,
            scramble=suffix_scramble(cut10),
        )


if __name__ == "__main__":
    main()
