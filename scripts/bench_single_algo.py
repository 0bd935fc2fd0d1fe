"""Per-algorithm benchmark — the reference's benches/single_algo_sort.rs.

One row per (Algorithm, key type) at 10M uniform elements, each forced
through the public builder with a SingleAlgoTuner (exactly
single_algo_sort.rs:64-85's shape), timed in-jit through the dispatcher
step harness.  Also covers BASELINE config 1's three-tuner ladder
(default / low-mem / single-threaded basic_sort, benches/basic_sort.rs:
45-47) when ``--tuners`` is passed.

Run on the GPU host:
    python scripts/bench_single_algo.py [--types u32,u64] [--tuners]
"""
import argparse
import json

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

N = 10_000_000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--types", default="u32,u64")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--tuners", action="store_true",
                    help="also run config 1's default/low-mem/"
                         "single-threaded tuner rows (u32)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from rdst_tpu import keys as rkeys
    from rdst_tpu.ops.histogram import multi_level_histogram
    from rdst_tpu.sorter import Sorter
    from rdst_tpu.tuner import (
        Algorithm,
        LowMemoryTuner,
        SingleAlgoTuner,
        SingleThreadedTuner,
        StandardTuner,
    )
    from scripts.bench_suite import (
        bench_injit,
        dispatcher_step,
        xor_scramble,
    )

    rng = np.random.default_rng(0)
    gens = {
        "u32": lambda: rng.integers(0, 2**32, args.n, dtype=np.int64)
        .astype(np.uint32),
        "u64": lambda: rng.integers(0, 2**64, args.n, dtype=np.uint64),
    }

    import time

    import jax

    def bench(metric, x, tuner):
        nk = rkeys.normalize(x)
        ws = [jnp.asarray(np.asarray(w)) for w in nk.words]
        hist = multi_level_histogram(ws, nk.n_bytes)
        sorter = Sorter(tuner=tuner)
        step = dispatcher_step(
            len(ws), nk.n_bytes, False, hist, sorter, xor_scramble
        )
        mode = "injit"
        try:
            t = bench_injit(step, tuple(ws))
        except jax.errors.ConcretizationTypeError:
            # the bucketed (MT_OOP) plan is host-driven by design: its
            # per-bucket re-tuning and static writeback need concrete
            # bucket counts at trace time (sorts/msb.py), so it runs
            # the builder's EAGER path; per-call wall time includes the
            # eager dispatch overhead its production mode actually pays
            mode = "eager"

            nk_dev = rkeys.NormalizedKeys(tuple(ws), nk.n_bytes, nk.meta)

            def run():
                out = sorter.run(nk_dev, [], stable=False, hist=hist)
                jax.block_until_ready(out[0].words)

            run()  # compile/warm
            reps, ts = 3, []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                ts.append(time.perf_counter() - t0)
            t = float(np.median(ts))
        print(json.dumps({
            "metric": metric,
            "value": round(args.n / t),
            "unit": "keys/s",
            "vs_baseline": round(args.n / t / 1e9, 4),
            "mode": mode,
        }), flush=True)

    for tname in args.types.split(","):
        x = gens[tname]()
        for algo in Algorithm:
            bench(
                f"single_algo_{algo.name.lower()}_{tname}_{args.n}",
                x, SingleAlgoTuner(algo),
            )

    if args.tuners:
        x = gens["u32"]()
        for label, tuner in (
            ("default", StandardTuner()),
            ("low_mem", LowMemoryTuner()),
            ("single_threaded", SingleThreadedTuner()),
        ):
            bench(f"basic_sort_u32_{args.n}_{label}", x, tuner)


if __name__ == "__main__":
    main()
