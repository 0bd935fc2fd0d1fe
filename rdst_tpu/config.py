"""Global configuration for rdst_tpu.

Like the reference's cargo features + builder flags (reference:
Cargo.toml:15-18, src/radix_sort_builder.rs:53-132) but runtime-settable.
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path

import jax

#: Fallback for :func:`low_mem_threshold` on devices whose allocator
#: reports no limit (``memory_stats()`` is None on the CPU backend).
_LOW_MEM_FALLBACK_BYTES = 2 << 30

#: Fixed compile-cache location inside the checkout, used when
#: ``JAX_COMPILATION_CACHE_DIR`` is unset. The path is part of the
#: cache's key, so it must not move between runs.
_REPO_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry-point script.

    A set ``JAX_COMPILATION_CACHE_DIR`` is honoured as JAX reads it, and
    nothing else is changed; otherwise the cache goes to the fixed
    in-checkout path ``<checkout>/.jax_cache``. Returns the directory in
    use.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(_REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


#: Size cap for the bucketed MSB plan. The (256, cap) padded-bucket
#: pipeline's compile time grows steeply with input size (the batched
#: sort + ragged writeback graph); above this many elements the plan
#: falls back to the comparative sort. Override with
#: RDST_TPU_MAX_BUCKETED or set at runtime.
max_bucketed_elements = int(
    os.environ.get("RDST_TPU_MAX_BUCKETED", str(20_000_000))
)

#: Runtime override for :func:`low_mem_threshold` (bytes); None derives
#: the threshold from the device's memory.
low_mem_threshold_bytes: int | None = None


def low_mem_threshold(device=None) -> int:
    """Working-set size (bytes, all operand planes) above which the REGIONS
    plan engages its low-memory chunked machinery.

    The reference picks Regions for RESOURCE reasons (bounded extra
    workspace, regions_sort.rs:3-10); below real memory pressure Regions'
    tuner regime (large skewed/low-entropy inputs) runs the
    level-compaction plan, because the chunked path's merge tree costs
    extra passes over the data. The threshold is an eighth of the
    device allocator's ``bytes_limit``: a sort needs input, output and
    workspace beside the caller's own arrays. Devices that report no
    limit (the CPU backend) use a fixed 2 GiB.
    """
    if low_mem_threshold_bytes is not None:
        return low_mem_threshold_bytes
    dev = device if device is not None else jax.local_devices()[0]
    stats = dev.memory_stats()
    if not stats or "bytes_limit" not in stats:
        return _LOW_MEM_FALLBACK_BYTES
    return int(stats["bytes_limit"]) // 8


#: Host-native fast path: numpy inputs up to this many elements sort on
#: the C++ host runtime (native/rdst_host.cpp) instead of paying the
#: host-to-device copy, the device plan and the copy back. 0 disables.
#: Only the default tuners take this path — forcing an Algorithm or
#: supplying a custom tuner always runs the device plans. Off by default:
#: on an NVIDIA H100 80GB HBM3 host (700 W limit), numpy-in/numpy-out
#: sorts of 2^6..2^20 u32 and u64 keys were as fast or faster on the
#: device path at every size (scripts/measure_bring_up.py --studies
#: crossover); the host sort paid 1.5-4 ms even at 64 keys.
host_sort_max = int(os.environ.get("RDST_TPU_HOST_SORT_MAX", "0"))

#: Stage-1 intermediate buffer headroom for the hierarchical (host, chip)
#: exchange. Stage 1 lands each destination HOST's rows on the source
#: chip's column-peer, so a chip's stage-1 receive load is bounded by the
#: column's share of the host's incoming data, not by the final balanced
#: per-chip capacity — skewed routing that funnels one host's rows
#: through a single chip column can need more than ``capacity`` rows in
#: flight even when the FINAL distribution fits. The stage-1 buffer is
#: sized ``ceil(capacity * hier_stage1_headroom)``; overflow beyond that
#: is detected (the poisoned count raises OverflowError in gather_valid).
#: Measured by row counts on the CPU mesh (scripts/capacity_study.py):
#: uniform and bimodal route evenly (stage-1 load ~= final load); the
#: headroom is insurance for adversarial funneling.
hier_stage1_headroom = float(
    os.environ.get("RDST_TPU_HIER_STAGE1_HEADROOM", "1.5")
)

#: Hot-bucket refinement depth for the distributed shuffle's partition
#: (shuffle._refined_assignment). Each level re-windows THE hottest
#: multi-key bucket with a fresh 16-bit window over its own key range —
#: the distributed analog of the reference's per-bucket depth recursion
#: (sorter.rs:121-171). 2 levels (48 effective window bits) balance
#: every distribution in scripts/capacity_study.py (bimodal demand
#: 4.0 -> ~1.0, zipf 3.9 -> ~1.0); mass hidden below 48 adaptive window
#: bits still falls back to atomic assignment + the OverflowError /
#: distributed_sort_auto escape. 0 disables refinement.
shuffle_refine_levels = int(
    os.environ.get("RDST_TPU_REFINE_LEVELS", "2")
)

#: Small-table replication bound for :func:`partition_exchange`. A
#: partitioned dataset no larger than this many rows gets FULL-TABLE
#: per-device capacity (any partition skew is covered — a device can
#: never receive more rows than exist), so co-partitioning a small dim
#: table against a skewed fact partition needs no mesh-size-scaled
#: capacity_factor. Cost ceiling: this many rows x planes x 4 B per
#: device (64 Ki rows ~ 1 MB for a 4-plane table).
replicate_capacity_max = int(
    os.environ.get("RDST_TPU_REPLICATE_CAP_MAX", str(1 << 16))
)

#: Presorted-input advantage (reference analog: lsb_sort.rs:62-83 skips
#: newly-sorted levels at runtime; benches/struct_sort.rs:43-127 measures
#: 90%-presorted inputs): when the histogram pass finds a sorted prefix
#: covering at least half the input, the sorter sorts only the suffix and
#: bitonic-merges the halves (ops/merge.py). The split is quantized to
#: sixteenths of the padded size so the jit cache stays bounded. 0
#: disables.
presorted_merge_min = int(
    os.environ.get("RDST_TPU_PRESORTED_MIN", str(1 << 17))
)


# work_profiles-equivalent: trace per-level algorithm picks
# (reference: Cargo.toml:18, src/sorter.rs:78-79).
_work_profiles = [os.environ.get("RDST_TPU_WORK_PROFILES", "0") not in ("0", "")]


def work_profiles_enabled() -> bool:
    return _work_profiles[0]


@contextlib.contextmanager
def work_profiles(enabled: bool = True):
    old = _work_profiles[0]
    _work_profiles[0] = enabled
    try:
        yield
    finally:
        _work_profiles[0] = old
