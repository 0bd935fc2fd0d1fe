"""Distributed table pipeline over a device mesh (BASELINE config 5).

Global sort, filter, group-aggregate, and a co-partitioned join — the
multi-device generalization of the reference's bucket-exchange algorithms
(reference: recombinating_sort.rs, regions_sort.rs; SURVEY.md §2.3/§7).
Runs on any mesh: the GPUs of a host, or a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).
"""
import numpy as np

import jax

from rdst_tpu.parallel import (
    distributed_filter,
    distributed_group_aggregate,
    distributed_join,
    distributed_sort_table,
    make_mesh,
)
from rdst_tpu.table import Table

mesh = make_mesh()  # all visible devices
D = mesh.devices.size
n = 4096 * D
rng = np.random.default_rng(0)

facts = Table(
    {
        "sku": rng.integers(0, 256, n).astype(np.uint32),
        "qty": rng.integers(1, 20, n).astype(np.uint32),
        "ts": rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32),
    }
)
dims = Table(
    {
        "sku": np.arange(256, dtype=np.uint32),
        "price": (np.arange(256, dtype=np.uint32) * 3 + 10),
    }
)

# global ORDER BY ts
ordered, counts = distributed_sort_table(facts, "ts", mesh=mesh)
print("sorted rows per device:", np.asarray(counts))

# WHERE qty > 10 (local, no exchange)
kept, kcounts = distributed_filter(facts, np.asarray(facts["qty"]) > 10, mesh=mesh)
print("filtered rows per device:", np.asarray(kcounts))

# GROUP BY sku: SUM(qty)
agg, n_groups = distributed_group_aggregate(
    facts, "sku", {"total_qty": ("qty", "sum")}, mesh=mesh
)
print("groups:", int(n_groups))

# JOIN facts x dims on sku (co-partitioned: both sides routed by the
# same range partition so matching keys meet on one device; the small
# dim side automatically gets full-table per-device capacity, so no
# mesh-size-dependent tuning is needed)
joined, n_matched = distributed_join(facts, dims, "sku", mesh=mesh)
assert int(n_matched) == n
assert np.array_equal(
    np.asarray(joined["price"]), np.asarray(joined["sku"]) * 3 + 10
)
print("joined rows:", int(n_matched))

# raw key sort with automatic overflow retry: skewed key masses balance
# via hot-bucket refinement; anything deeper doubles capacity until fit
from rdst_tpu.parallel import distributed_sort_auto, gather_valid

zipf = np.minimum(rng.zipf(1.2, size=n), 1 << 20).astype(np.uint32)
words, _, zcounts = distributed_sort_auto(
    [jax.numpy.asarray(zipf)], mesh=mesh
)
assert np.array_equal(gather_valid(words, zcounts)[0], np.sort(zipf))
print("zipf sorted; max device load:",
      int(np.asarray(zcounts).max()), "of", n // D, "fair share")
jax.block_until_ready(counts)
