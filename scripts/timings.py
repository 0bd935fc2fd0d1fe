"""Perf-regression harness: CSV of keys/sec per (size, type, distribution).

Equivalent of the reference's scripts/timings.rs:88-200 — exponential size
set, median-of-k timings, one CSV row per configuration keyed by the git
commit. Run on the GPU host:

    python scripts/timings.py --out timings.csv --max-exp 24
"""
import argparse
import csv
import subprocess
import time

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except Exception:
        return "unknown"


def gen(rng, n, dtype, dist):
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, size=max(n, 1), endpoint=True,
                     dtype=dtype)
    if dist == "bimodal":
        # reference bimodal: half >>shift, half <<shift (bench_utils.rs:56-75)
        shift = np.dtype(dtype).itemsize * 4
        u = x.view(f"uint{np.dtype(dtype).itemsize * 8}")
        h = n // 2
        u[:h] >>= u.dtype.type(shift)
        u[h:] <<= u.dtype.type(shift)
    return x[:n]


def gen_u128(rng, n, dist):
    """u128 = composite (hi u64, lo u64), 16 levels (timings.rs covers
    u128; radix_key_impl.rs:39-46)."""
    hi = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    lo = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    if dist == "bimodal":
        # half >>64 (hi moves into lo), half <<64 (lo moves into hi)
        h = n // 2
        lo[:h], hi[:h] = hi[:h].copy(), np.uint64(0)
        hi[h:], lo[h:] = lo[h:].copy(), np.uint64(0)
    return hi, lo


def median_time(fn, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="timings.csv")
    ap.add_argument("--max-exp", type=int, default=23)
    ap.add_argument("--min-exp", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from rdst_tpu.engine import sort_words
    from rdst_tpu import keys as rkeys

    sha = git_sha()
    rng = np.random.default_rng(0)
    rows = []
    for dtype in ("uint32", "uint64", "uint128"):
        for dist in ("uniform", "bimodal"):
            n = 1 << args.max_exp
            if dtype == "uint128":
                pool = gen_u128(rng, n, dist)
            else:
                pool = gen(rng, n, np.dtype(dtype), dist)
            size = n
            while size >= (1 << args.min_exp):
                if dtype == "uint128":
                    x = (pool[0][:size], pool[1][:size])
                else:
                    x = pool[:size]
                nk = rkeys.normalize(x)
                words = tuple(jnp.asarray(np.asarray(w)) for w in nk.words)
                f = jax.jit(
                    lambda ws: tuple(sort_words(list(ws))[0])
                )

                def run(f=f, words=words):
                    jax.block_until_ready(f(words))

                run()  # compile + warm
                t = median_time(run, args.reps)
                rows.append(
                    {
                        "commit": sha,
                        "type": dtype,
                        "dist": dist,
                        "n": size,
                        "seconds": f"{t:.6f}",
                        "keys_per_sec": f"{size / t:.0f}",
                    }
                )
                print(rows[-1])
                size //= 2

    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}")

    # medley summary (bench_utils.rs:78-100, 134-166): total elements /
    # total seconds over the exponential size set, per (type, dist)
    for dtype in ("uint32", "uint64", "uint128"):
        for dist in ("uniform", "bimodal"):
            sel = [r for r in rows
                   if r["type"] == dtype and r["dist"] == dist]
            tot_n = sum(r["n"] for r in sel)
            tot_s = sum(float(r["seconds"]) for r in sel)
            if tot_s > 0:
                print(f"medley {dtype} {dist}: "
                      f"{tot_n / tot_s:.0f} keys/s summed over "
                      f"{len(sel)} sizes")


if __name__ == "__main__":
    main()
