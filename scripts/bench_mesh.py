"""Mesh scaling harness: distributed shuffle-sort throughput vs #devices.

BASELINE.json's second north star is >=80% rows/s scaling efficiency from
1 device -> 1 host -> N hosts. This harness produces the scaling CURVE on
whatever devices exist:

  * on a multi-GPU host:         python scripts/bench_mesh.py
  * on the virtual CPU mesh:     python scripts/bench_mesh.py --cpu 8
    (virtual devices share host cores — the numbers validate the harness
    and the weak-scaling SHAPE, not device throughput)

For each D in the ladder it weak-scales the input (n = per_device * D),
runs the full distributed sort (local sort + psum histograms + balanced
assignment + ragged/dense exchange + local finish) inside one jit, and
reports rows/s plus efficiency vs D=1 extrapolation.

Prints one JSON line per mesh size (same schema as bench.py).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="force a virtual CPU mesh of this many devices")
    ap.add_argument("--per-device", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)
    import jax.numpy as jnp

    from rdst_tpu.parallel import distributed_sort, make_mesh

    n_dev = len(jax.devices())
    ladder = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    rng = np.random.default_rng(0)
    base = None
    for D in ladder:
        mesh = make_mesh(D)
        n = args.per_device * D
        words = [
            jnp.asarray(rng.integers(0, 2**32, n, dtype=np.int64)
                        .astype(np.uint32))
            for _ in range(2)
        ]

        def run():
            w, p, c = distributed_sort(
                words, [], mesh=mesh, capacity_factor=2.0, stable=False
            )
            return jax.block_until_ready((w, c))

        run()  # compile
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        dt = (time.perf_counter() - t0) / args.iters
        rows_s = n / dt
        if base is None:
            base = rows_s
        eff = rows_s / (base * D)
        print(json.dumps({
            "metric": f"dist_shuffle_rows_per_s_D{D}",
            "value": round(rows_s),
            "unit": "rows/s",
            "vs_baseline": round(eff, 4),
            "devices": D,
            "weak_scaling_efficiency_vs_D1": round(eff, 4),
        }), flush=True)

    # 2-axis (host x chip) hierarchical exchange at the largest even
    # split — the multi-host code shape (per-host blocks, then a regroup
    # within each host)
    if n_dev >= 4:
        from rdst_tpu.parallel import make_mesh_2d

        H = 2
        C = (n_dev // H)
        mesh2 = make_mesh_2d(H, C)
        D = H * C
        n = args.per_device * D
        words = [
            jnp.asarray(rng.integers(0, 2**32, n, dtype=np.int64)
                        .astype(np.uint32))
            for _ in range(2)
        ]

        def run2():
            w, p, c = distributed_sort(
                words, [], mesh=mesh2, axis=mesh2.axis_names,
                capacity_factor=2.0, stable=False,
            )
            return jax.block_until_ready((w, c))

        run2()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run2()
        dt = (time.perf_counter() - t0) / args.iters
        rows_s = n / dt
        eff = rows_s / (base * D)
        print(json.dumps({
            "metric": f"dist_shuffle_rows_per_s_hier_{H}x{C}",
            "value": round(rows_s),
            "unit": "rows/s",
            "vs_baseline": round(eff, 4),
            "devices": D,
            "weak_scaling_efficiency_vs_D1": round(eff, 4),
        }), flush=True)


if __name__ == "__main__":
    main()
