"""Capacity-factor study for the distributed shuffle.

Measures, per input distribution on the virtual 8-device mesh, the
actual per-device DEMAND ratio max(counts)/n_local — the minimum
capacity_factor that would have fit — for both the 1-axis and the 2-axis
(2, 4) hierarchical mesh, plus the stage-1 intermediate demand of the
hierarchical exchange (found by bisecting hier_stage1_headroom against
the poisoning signal). Its table (row counts, not times) sets the
shipped defaults:

* ``capacity_factor`` default — covers every benign distribution,
* ``hier_stage1_headroom`` default — covers benign routing,
* ``distributed_sort_auto`` — the escape for adversarial inputs.

Run:  JAX_PLATFORMS=cpu python scripts/capacity_study.py
(sets the 8-device host platform itself)
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, "/root/repo")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from rdst_tpu import config  # noqa: E402
from rdst_tpu.parallel import (  # noqa: E402
    distributed_sort,
    gather_valid,
    make_mesh,
    make_mesh_2d,
)

D = 8
N = 1 << 15


def _u64_planes(x):
    x = x.astype(np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return [hi, lo]


def distributions(rng):
    n = N
    uni = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    shift = np.uint64(32)
    bimodal = np.concatenate(
        [uni[: n // 2] >> shift, uni[n // 2 :] << shift]
    )
    rng.shuffle(bimodal)
    z = np.minimum(rng.zipf(1.2, size=n), 1 << 20).astype(np.uint64)
    hot = rng.integers(0, 1 << 8, size=n, dtype=np.uint64)
    hot[: n // 8] = uni[: n // 8]
    return {
        "uniform": uni,
        "bimodal_s32": bimodal,
        "zipf_1.2": z,
        "low_entropy_16b": uni % np.uint64(1 << 16),
        "sorted_uniform": np.sort(uni),
        "all_equal": np.full(n, 42, dtype=np.uint64),
        "hot_multikey_88pct": hot,
    }


def demand_ratio(x, mesh, axis):
    """max(counts)/n_local with a roomy buffer (nothing overflows)."""
    words, _, counts = distributed_sort(
        _u64_planes(x), mesh=mesh, axis=axis, capacity_factor=float(D)
    )
    c = np.asarray(counts)
    return float(c.max()) * D / len(x)


def stage1_headroom_needed(x, mesh2, factor):
    """Smallest hier_stage1_headroom in {1.0, 1.25, ... 8.0} that avoids
    stage-1 poisoning at the given final capacity_factor."""
    old = config.hier_stage1_headroom
    try:
        for h in [1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0]:
            config.hier_stage1_headroom = h
            words, _, counts = distributed_sort(
                _u64_planes(x), mesh=mesh2, axis=mesh2.axis_names,
                capacity_factor=factor,
            )
            try:
                gather_valid(words, counts)
                return h
            except OverflowError:
                continue
        return float("inf")
    finally:
        config.hier_stage1_headroom = old


def main():
    rng = np.random.default_rng(0xCAFE)
    mesh1 = make_mesh(D)
    mesh2 = make_mesh_2d(2, D // 2)
    print(f"| distribution | demand 1-axis | demand (2,4) | "
          f"stage-1 headroom @1.25x final |")
    print("|---|---|---|---|")
    for name, x in distributions(rng).items():
        r1 = demand_ratio(x, mesh1, "shard")
        r2 = demand_ratio(x, mesh2, mesh2.axis_names)
        f = max(1.25, 1.1 * r2)
        h = stage1_headroom_needed(x, mesh2, f)
        print(f"| {name} | {r1:.3f} | {r2:.3f} | {h} (final f={f:.2f}) |",
              flush=True)


if __name__ == "__main__":
    main()
