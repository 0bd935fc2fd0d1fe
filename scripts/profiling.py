"""Profiler entry point — the reference's scripts/profiling.rs analog.

profiling.rs (reference: scripts/profiling.rs:87-109) builds a
profiler-friendly binary whose sleep markers separate input generation
from the sort so a sampling profiler can window the region of interest.
The JAX equivalent is a jax.profiler trace: this script captures one
XProf/TensorBoard trace of the full dispatcher pipeline (histogram ->
tuner -> plan kernels), with the same generate / sleep / sort / sleep
phase structure so both wall-profilers and the trace viewer can isolate
the sort.

    python scripts/profiling.py --n 10000000 --trace /tmp/rdst_trace
    tensorboard --logdir /tmp/rdst_trace   # or xprof

Per-level algorithm picks print alongside (the work_profiles trace,
sorter.rs:78-79 parity) so the captured kernels can be attributed to
plans.
"""
import argparse
import time

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--dtype", default="uint64")
    ap.add_argument("--trace", default="/tmp/rdst_trace")
    ap.add_argument("--sleep", type=float, default=0.5,
                    help="marker sleeps separating phases (profiling.rs)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import rdst_tpu as rt
    from rdst_tpu import config
    from rdst_tpu.utils.trace import profile_to

    rng = np.random.default_rng(0)
    info = np.iinfo(args.dtype)
    x = rng.integers(info.min, info.max, size=args.n, endpoint=True,
                     dtype=args.dtype)

    # warm (compile outside the trace so the trace shows steady state)
    with config.work_profiles(True):
        warm = rt.radix_sort_unstable(x)
    del warm

    time.sleep(args.sleep)  # marker: input/compile done
    with profile_to(args.trace):
        out = rt.radix_sort_unstable(x)
        if not isinstance(out, np.ndarray):
            out = np.asarray(jnp.asarray(out))
    time.sleep(args.sleep)  # marker: sort done

    assert np.array_equal(np.sort(x), out)
    print(f"trace written to {args.trace}; sorted {args.n} ok")


if __name__ == "__main__":
    main()
