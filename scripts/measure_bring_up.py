#!/usr/bin/env python3
"""Measurements that decide the GPU bring-up's open choices.

    python scripts/measure_bring_up.py [--log2-n 28] [--reps 5]

Needs a GPU (exits 2 without one). Prints, with the card's name and power
limit first:

* hist:      the planning histogram alone on u64 keys (8 levels), for
             several partial-histogram row counts and three inputs, with
             its rate against the bytes it must read (2 x 4 B per key) at
             the H100's 3.35 TB/s;
* served:    a warm ``radix_sort_unstable`` on the same keys (numpy in and
             out), split into normalize / histogram / plan / denormalize,
             and the histogram's share of the call;
* presorted: the 90%-presorted u64 case with the presorted merge and with
             ``presorted_merge_min=0`` (a plain sort of the whole input),
             in turns;
* crossover: numpy-in/numpy-out sorts of 2^14..2^20 keys on the host C++
             runtime and on the device path.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Device-memory bandwidth by ``device_kind`` (NVIDIA's H100 SXM data
#: sheet). A card missing here is an error, not a default.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def timed(fn, reps):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), statistics.median(ts)


def hist_study(rng, n, reps, peak):
    import jax

    import rdst_tpu as rt
    from rdst_tpu.ops import histogram as H

    inputs = {
        "uniform": rng.integers(0, 2**64, size=n, dtype=np.uint64),
        "all-equal": np.full(n, 0x0123456789ABCDEF, np.uint64),
        "zipf1.3": np.minimum(rng.zipf(1.3, n), 2**62).astype(np.uint64),
    }
    must_read = n * 8
    shipped = H._ROWS
    for name, x in inputs.items():
        words = rt.keys.normalize(x).words
        for rows in (1, 256, shipped, 4096):
            H._ROWS = rows
            H._multi_level_device.clear_cache()
            f = lambda: jax.block_until_ready(  # noqa: E731
                H._multi_level_device(tuple(words), 8))
            lo, med = timed(f, reps)
            print(f"hist {name:<9} rows={rows:<5} min {lo * 1e3:.4f} ms "
                  f"median {med * 1e3:.4f} ms -> {must_read / med / 1e9:.2f} "
                  f"GB/s = {must_read / med / peak:.5f} of "
                  f"{peak / 1e12} TB/s{' (shipped)' if rows == shipped else ''}")
        del words
    H._ROWS = shipped
    H._multi_level_device.clear_cache()


def served_study(rng, n, reps):
    import jax

    import rdst_tpu as rt
    from rdst_tpu.keys import NormalizedKeys, denormalize_host
    from rdst_tpu.ops.histogram import multi_level_histogram
    from rdst_tpu.sorter import Sorter

    x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    lo, med = timed(lambda: rt.radix_sort_unstable(x), reps)
    print(f"served radix_sort_unstable u64 n={n}: min {lo:.6f} s "
          f"median {med:.6f} s")
    parts = {}
    t0 = time.perf_counter()
    nk = rt.keys.normalize(x)
    jax.block_until_ready(nk.words)
    parts["normalize (host split + copy in)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = multi_level_histogram(nk.words, nk.n_bytes)
    parts["histogram (incl. fetch)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, _ = Sorter().run(nk, hist=hist)
    jax.block_until_ready(out.words)
    parts["plan (device sort)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    y = denormalize_host(NormalizedKeys(out.words, nk.n_bytes, nk.meta))
    parts["denormalize (copy out + host join)"] = time.perf_counter() - t0
    assert np.array_equal(y, np.sort(x))
    total = sum(parts.values())
    for k, v in parts.items():
        print(f"    {k:<36} {v:.6f} s  {v / total:.4f} of the parts")
    print(f"    histogram share of the served median: "
          f"{parts['histogram (incl. fetch)'] / med:.5f}")


def presorted_study(rng, n, reps):
    import rdst_tpu as rt
    from rdst_tpu import config

    x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    x[: n * 9 // 10] = np.sort(x[: n * 9 // 10])
    want = np.sort(x)
    default = config.presorted_merge_min
    res = {"merge (default)": [], "no merge (presorted_merge_min=0)": []}
    for setting in [default, 0, 0, default] * ((reps + 1) // 2):
        config.presorted_merge_min = setting
        key = "merge (default)" if setting else "no merge (presorted_merge_min=0)"
        if not res[key]:
            rt.radix_sort_unstable(x)  # warm this setting's shapes
        t0 = time.perf_counter()
        y = rt.radix_sort_unstable(x)
        res[key].append(time.perf_counter() - t0)
        assert np.array_equal(y, want)
    config.presorted_merge_min = default
    for k, ts in res.items():
        print(f"presorted 90% u64 n={n} {k}: min {min(ts):.6f} s "
              f"median {statistics.median(ts):.6f} s ({len(ts)} runs)")


def crossover_study(rng, reps, log2_sizes):
    import rdst_tpu as rt
    from rdst_tpu import config

    old = config.host_sort_max
    for dt in (np.uint32, np.uint64):
        for log2 in log2_sizes:
            x = rng.integers(0, np.iinfo(dt).max, size=1 << log2, dtype=dt)
            row = []
            for label, cap in (("host", 1 << 30), ("device", 0)):
                config.host_sort_max = cap
                lo, med = timed(lambda: rt.radix_sort_unstable(x), reps)
                row.append(f"{label} median {med * 1e3:.4f} ms")
            print(f"crossover {np.dtype(dt).name} n=2^{log2}: " + ", ".join(row))
    config.host_sort_max = old


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-n", type=int, default=28)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--studies", default="hist,served,presorted,crossover")
    ap.add_argument("--crossover-log2", default="14-20",
                    help="inclusive range of log2 sizes for the crossover")
    args = ap.parse_args()
    studies = args.studies.split(",")

    import jax

    if jax.default_backend() != "gpu":
        print("no GPU", file=sys.stderr)
        return 2
    kind = jax.devices()[0].device_kind
    if kind not in HBM_BYTES_PER_S:
        print(f"no bandwidth peak for {kind!r}", file=sys.stderr)
        return 2
    from rdst_tpu import config

    config.enable_compile_cache()
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=False)
    print(r.stdout.strip())
    print(f"device {kind}, jax {jax.__version__}")
    rng = np.random.default_rng(args.seed)
    n = 1 << args.log2_n
    if "hist" in studies:
        hist_study(rng, n, args.reps, HBM_BYTES_PER_S[kind])
    if "served" in studies:
        served_study(rng, n, max(args.reps // 2, 2))
    if "presorted" in studies:
        presorted_study(rng, n >> 2, args.reps)
    if "crossover" in studies:
        lo, hi = (int(v) for v in args.crossover_log2.split("-"))
        crossover_study(rng, args.reps + 2, range(lo, hi + 1))
    print(r.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
