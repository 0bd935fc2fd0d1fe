"""Headline benchmark: u64 keys/s on one device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

vs_baseline is the ratio against the BASELINE.json north-star target of
1e9 u64 keys/s/chip. Timing loops run inside a single jit (lax.fori_loop)
so per-call dispatch stays out of the per-iteration time.

Extra configs (BASELINE.md list) via: python bench.py --all
"""
import argparse
import json
import sys
import time

import numpy as np


def _bench_sort_words(n, n_words, iters=8, plan="auto"):
    import jax
    import jax.numpy as jnp
    from rdst_tpu.engine import sort_words

    rng = np.random.default_rng(42)
    words = [
        jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
        for _ in range(n_words)
    ]

    # re-randomize cheaply between iterations so the input is never sorted
    def step(ws):
        ws = [w * np.uint32(2654435761) + np.uint32(i + 1)
              for i, w in enumerate(ws)]
        return tuple(sort_words(ws, plan=plan)[0])

    @jax.jit
    def once(ws):
        return step(ws)

    @jax.jit
    def many(ws):
        return jax.lax.fori_loop(
            0, iters, lambda i, a: step(list(a)), tuple(ws)
        )

    jax.block_until_ready(once(words))
    t0 = time.perf_counter()
    jax.block_until_ready(once(words))
    t_once = time.perf_counter() - t0

    jax.block_until_ready(many(words))
    t0 = time.perf_counter()
    jax.block_until_ready(many(words))
    t_many = time.perf_counter() - t0
    per_iter = (t_many - t_once) / (iters - 1)
    return n / per_iter


def _bench_sort_words_donated(n, n_words, iters=3, plan="auto"):
    """Large-n harness: donated input buffers + device-side generation.

    The chain-through-loop harness (_bench_sort_words) keeps
    in + out + loop-carry live (~3x data). Here the input is generated
    ON DEVICE (no host transfer) and DONATED to the timed jit, so the
    loop carry aliases the input and peak live memory is the sort's own
    working set.
    """
    import functools

    import jax
    import jax.numpy as jnp
    from rdst_tpu.engine import sort_words

    def step(ws):
        ws = [w * np.uint32(2654435761) + np.uint32(i + 1)
              for i, w in enumerate(ws)]
        return tuple(sort_words(ws, plan=plan)[0])

    @jax.jit
    def gen(seed):
        key = jax.random.key(seed)
        return tuple(
            jax.random.bits(k, (n,), dtype=jnp.uint32)
            for k in jax.random.split(key, n_words)
        )

    @functools.partial(jax.jit, donate_argnums=0)
    def once(ws):
        return step(ws)

    @functools.partial(jax.jit, donate_argnums=0)
    def many(ws):
        return jax.lax.fori_loop(
            0, iters, lambda i, a: step(list(a)), tuple(ws)
        )

    def timed(fn, seed):
        ws = jax.block_until_ready(gen(seed))
        return jax.block_until_ready(fn(ws))

    timed(once, 0)  # compile
    t0 = time.perf_counter()
    timed(once, 1)
    t_once = time.perf_counter() - t0
    timed(many, 2)  # compile
    t0 = time.perf_counter()
    timed(many, 3)
    t_many = time.perf_counter() - t0
    per_iter = (t_many - t_once) / (iters - 1)
    return n / per_iter


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 25)
    ap.add_argument("--plan", default="auto")
    ap.add_argument("--all", action="store_true",
                    help="run all BASELINE configs (verbose, not driver mode)")
    ap.add_argument("--sweep", action="store_true",
                    help="keys/s at 2^25..2^28 — the large-n anchor for "
                         "the 1B-key north star (one JSON line per size)")
    ap.add_argument("--sweep-large", action="store_true",
                    help="donated-buffer sweep at 2^28..2^29 (and --try-2e30)"
                         " — measures AT the north-star scale")
    ap.add_argument("--try-2e30", action="store_true",
                    help="attempt n=2^30 with the donated harness (records "
                         "an out-of-memory attempt as value 0)")
    ap.add_argument("--planes", type=int, default=2,
                    help="key word planes for --sweep-large (1 = u32 keys)")
    args = ap.parse_args()

    from rdst_tpu import config

    config.enable_compile_cache()

    if args.all:
        from scripts import timings  # noqa: F401 — full harness lives there

        print("use scripts/timings.py for the full matrix", file=sys.stderr)

    if args.sweep_large:
        logns = [28, 29] + ([30] if args.try_2e30 else [])
        P = args.planes
        for logn in logns:
            try:
                kps = _bench_sort_words_donated(
                    1 << logn, n_words=P, plan=args.plan, iters=3,
                )
            except Exception as e:  # noqa: BLE001 — record OOM verdicts
                print(json.dumps({
                    "metric": f"u{32 * P}_sort_keys_per_s_chip_n{1 << logn}",
                    "value": 0,
                    "unit": "keys/s",
                    "error": repr(e)[:300],
                }))
                continue
            print(json.dumps({
                "metric": f"u{32 * P}_sort_keys_per_s_chip_n{1 << logn}",
                "value": round(kps),
                "unit": "keys/s",
                "vs_baseline": round(kps / 1e9, 4),
            }))
        return

    if args.sweep:
        for logn in (25, 26, 27, 28):
            kps = _bench_sort_words(1 << logn, n_words=2, plan=args.plan,
                                    iters=4 if logn >= 27 else 8)
            print(json.dumps({
                "metric": f"u64_sort_keys_per_s_chip_n{1 << logn}",
                "value": round(kps),
                "unit": "keys/s",
                "vs_baseline": round(kps / 1e9, 4),
            }))
        return

    keys_per_s = _bench_sort_words(args.n, n_words=2, plan=args.plan)
    target = 1e9  # BASELINE.json north star: 1B u64 keys/s/chip
    print(
        json.dumps(
            {
                "metric": f"u64_sort_keys_per_s_chip_n{args.n}",
                "value": round(keys_per_s),
                "unit": "keys/s",
                "vs_baseline": round(keys_per_s / target, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
