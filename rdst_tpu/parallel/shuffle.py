"""Distributed MSB shuffle sort over a device mesh.

The multi-device generalization of the reference's bucket-exchange algorithms
(reference: recombinating_sort.rs:44-112 two-barrier tile sort;
regions_sort.rs:206-262 inter-region exchange; SURVEY.md §2.3): the
keyspace is range-partitioned across devices by the most significant
digits, every device exchanges buckets with every other, and
local sorts complete the order. Device-major concatenation of the outputs
is the globally sorted sequence — the same bucket-major/tile-minor layout
the reference uses for stability (mt_lsb_sort.rs:51-63), with devices
playing the role of tiles.

Pipeline (inside one ``jax.shard_map`` over the partition axis):

  1. local stable sort of the resident shard (so send segments are
     contiguous and the exchange is order-preserving),
  2. global top-byte histogram via ``psum`` (the distributed analog of
     ``aggregate_tile_counts``, sort_utils.rs:247-249),
  3. histogram-driven monotone bucket->device assignment (balanced
     ranges; single-key buckets split by exact stable rank, hot
     multi-key buckets refine recursively — _refined_assignment; the
     skew signal family matches the tuners' ``count >= 2*len/256``
     rule, standard_tuner.rs:20-22),
  4. all-to-all exchange of the per-destination segments into
     fixed-capacity shards (dense ``all_to_all`` by default, exact-size
     ``jax.lax.ragged_all_to_all`` with ``use_ragged=True``),
  5. local merge-sort of the received segments.

Static-shape constraint: outputs are ``capacity``-sized with a per-device
valid count (pad slots hold 0xFFFFFFFF and sort to the tail behind a
validity plane). ``capacity_factor`` bounds skew absorption; overflow is
detectable from the returned counts.
"""
from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rdst_tpu.ops.prefix import exclusive_prefix_sum

__all__ = [
    "distributed_sort", "distributed_sort_auto", "partition_exchange",
    "make_mesh", "make_mesh_2d", "init_distributed",
]

#: Partition granularity: top 16 bits. The reference's MSB level is one
#: byte (sorter.rs:106-119); two bytes gives 256x finer bucket->device
#: splitting, which is the histogram-driven "skew splitting" of SURVEY.md
#: §7 — a bucket hotter than one device's share splits across devices at
#: the next byte automatically. Hotter still (a single repeated key):
#: single-key buckets are detected and split across devices by exact
#: global stable rank, so even an all-equal input balances perfectly.
#: A hot bucket containing MULTIPLE distinct keys beyond the 16 window
#: bits refines recursively (config.shuffle_refine_levels fresh 16-bit
#: windows over the hottest bucket's own range — _refined_assignment);
#: only mass hidden below ~48 adaptive window bits still concentrates,
#: covered by capacity_factor + the OverflowError signal +
#: distributed_sort_auto. Defaults are set from measured demand
#: (scripts/capacity_study.py: max 1.11x fair share across uniform /
#: bimodal / zipf-1.2 / low-entropy / sorted / all-equal / hot-multikey).
N_BUCKETS = 1 << 16
PAD_WORD = np.uint32(0xFFFFFFFF)


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh_2d(
    n_hosts: int,
    chips_per_host: int,
    axes: tuple[str, str] = ("host", "chip"),
) -> Mesh:
    """Two-axis mesh: ``axes[0]`` spans hosts (the network between
    hosts), ``axes[1]`` the devices within a host (NVLink).  On a
    multi-host cluster ``jax.devices()`` enumerates process-major, so the
    row-major (H, C) reshape puts each host's devices on one ``chip`` row;
    on a single host (or the virtual CPU mesh) the same shape exercises
    the hierarchical exchange code paths."""
    devs = jax.devices()[: n_hosts * chips_per_host]
    if len(devs) < n_hosts * chips_per_host:
        raise ValueError(
            f"need {n_hosts * chips_per_host} devices, have {len(devs)}"
        )
    return Mesh(np.array(devs).reshape(n_hosts, chips_per_host), axes)


def init_distributed(**kwargs) -> None:
    """Multi-process entry point: initialize the JAX distributed runtime
    (one process per host; pass ``coordinator_address``,
    ``num_processes`` and ``process_id`` where the cluster does not
    provide them).  Call once before building meshes on a multi-host
    cluster; a no-op when already initialized."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e):
            raise


def _flat_index(axis) -> jax.Array:
    """Flat device rank along ``axis`` (host-major for a (host, chip)
    tuple — the order all_gather concatenates and P(axis) shards)."""
    if isinstance(axis, tuple):
        ha, ca = axis
        return jax.lax.axis_index(ha) * jax.lax.psum(1, ca) + (
            jax.lax.axis_index(ca)
        )
    return jax.lax.axis_index(axis)


def _bit_length(x: jax.Array) -> jax.Array:
    """Exact bit length of a uint32 scalar (32 shift-compare steps)."""
    bits = jnp.int32(0)
    for k in range(32):
        bits = bits + (jnp.right_shift(x, np.uint32(k)) > 0).astype(jnp.int32)
    return bits


def _window_params(words, axis: str):
    """Entropy-adaptive 16-bit window parameters per key word.

    A fixed top-16-bit window collapses low-entropy keys (e.g. all values
    < 2^16, or u64 keys whose high word is constant) into one bucket and
    therefore one device. Instead: walk ALL word planes most-significant
    first, allocating the 16 bucket bits to each word's globally-varying
    bit range (pmin/pmax collectives) until the budget is spent. This is
    the histogram-driven skew/entropy adaptation of SURVEY.md §7 at the
    partitioning level — the same signal the packed LSB plan uses to drop
    constant byte planes.

    Returns (gmins, shifts, bits): stacked (W,) arrays — the reusable
    partition window that :func:`partition_exchange` applies to OTHER
    datasets (co-partitioning for joins).
    """
    remaining = jnp.int32(16)
    gmins, shifts, bits = [], [], []
    for w in words:
        gmin = jax.lax.pmin(jnp.min(w), axis)
        span = jax.lax.pmax(jnp.max(w), axis) - gmin
        bl = _bit_length(span)
        b = jnp.minimum(bl, remaining)  # bits taken from this word
        gmins.append(gmin)
        shifts.append((bl - b).astype(jnp.uint32))
        bits.append(b)
        remaining = remaining - b
    return jnp.stack(gmins), jnp.stack(shifts), jnp.stack(bits)


def _apply_window(words, gmins, shifts, bits) -> jax.Array:
    """Bucket ids from window params. Earlier words dominate
    (lexicographic), later words refine within equal-prefix groups —
    monotone in the full key for keys inside the window's range.

    Keys OUTSIDE the range (possible when a window derived from one
    dataset is applied to another) saturate per word; the result is still
    a deterministic function of the key — equal keys always land in the
    same bucket — which is all co-partitioning needs (out-of-range keys
    have no join partner by construction).
    """
    result = jnp.zeros(words[0].shape, jnp.int32)
    for i, w in enumerate(words):
        clamped = jnp.maximum(w, gmins[i]) - gmins[i]
        part = jnp.right_shift(clamped, shifts[i]).astype(jnp.int32)
        part = jnp.minimum(part, (jnp.int32(1) << bits[i]) - 1)
        result = (result << bits[i]) | part
    return result


def _adaptive_buckets(sorted_words, axis: str) -> jax.Array:
    gmins, shifts, bits = _window_params(sorted_words, axis)
    return _apply_window(sorted_words, gmins, shifts, bits)


def _local_shard_body(
    axis: str,
    n_send_words: int,
    capacity: int,
    stage1_cap: int,
    stable: bool,
    use_ragged: bool,
    split_uniform: bool,
    return_partition: bool,
    overlap: bool,
    refine_levels: int,
    *arrs,
):
    """shard_map body. arrs = word planes + payload planes, local shards."""
    words_and_payloads = list(arrs)
    D = jax.lax.psum(1, axis)
    me = _flat_index(axis)
    n_local = words_and_payloads[0].shape[0]

    # 1. local stable sort by full key (payloads ride along)
    n_keys = n_send_words
    sorted_all = list(jax.lax.sort(
        tuple(words_and_payloads), num_keys=n_keys, is_stable=stable
    ))
    # nondecreasing after the local sort (monotone function of the key)
    gmins, wshifts, wbits = _window_params(sorted_all[:n_keys], axis)
    buckets = _apply_window(sorted_all[:n_keys], gmins, wshifts, wbits)

    # 2. global top-16-bit histogram. Buckets are sorted, so the local
    # histogram is a searchsorted diff — O(R log n), no one-hot
    # materialization. The full (D, R) matrix of per-sender histograms is
    # gathered because the stable-rank split below needs each sender's
    # within-bucket offset (the distributed aggregate_tile_counts,
    # sort_utils.rs:247-249, with devices as tiles).
    edges = jnp.searchsorted(
        buckets, jnp.arange(N_BUCKETS + 1, dtype=jnp.int32), side="left"
    )
    local_hist = (edges[1:] - edges[:-1]).astype(jnp.int32)
    if split_uniform:
        hist_matrix = jax.lax.all_gather(local_hist, axis)  # (D, R)
        global_hist = jnp.sum(hist_matrix, axis=0)
    else:
        # atomic-only mode never needs per-sender offsets — a psum moves
        # D x less data than the (D, R) gather
        global_hist = jax.lax.psum(local_hist, axis)

    # 2b. single-key ("uniform") bucket detection. A bucket whose global
    # key set is ONE value can be split across devices at any rank without
    # breaking sortedness — that's the multi-device version of ska_sort's
    # dominant-bucket special-casing (ska_sort.rs:52-65) and the fix for
    # degenerate/Zipf-hot keys that would otherwise overflow one device.
    # Detection: for every key word, the global min of per-device segment
    # minima equals the global max of segment maxima. Within a locally
    # sorted bucket segment the first element carries the minimum of the
    # most-significant differing word and the last the maximum, which is
    # exactly what the equality test needs (lower words only matter when
    # all higher words are constant, in which case first/last are the
    # true extrema for them too).
    if split_uniform:
        first_idx = jnp.clip(edges[:-1], 0, n_local - 1)
        last_idx = jnp.clip(edges[1:] - 1, 0, n_local - 1)
        nonempty = local_hist > 0
        uniform = jnp.ones((N_BUCKETS,), jnp.bool_)
        for w in sorted_all[:n_keys]:
            lmin = jnp.where(nonempty, jnp.take(w, first_idx), PAD_WORD)
            lmax = jnp.where(nonempty, jnp.take(w, last_idx), np.uint32(0))
            gmin = jax.lax.pmin(lmin, axis)
            gmax = jax.lax.pmax(lmax, axis)
            uniform = uniform & (gmin == gmax)
    else:
        # co-partitioning mode (joins): every bucket stays atomic so a
        # second dataset partitioned by the same window lands key-aligned
        uniform = jnp.zeros((N_BUCKETS,), jnp.bool_)

    # 3. destination assignment by global stable rank. Device d owns the
    # stable-rank range [Rd[d], Rd[d+1]); an element's stable rank is
    # (bucket start) + (earlier senders' count in my bucket) + (my local
    # offset). Uniform buckets are split exactly at the range boundaries
    # (perfect balance); mixed-key buckets are assigned atomically by
    # their midpoint rank (a split there could send key-order across
    # devices in the wrong direction). Both rules use the SAME integer
    # boundary vector Rd so the per-bucket take counts form a consistent
    # staircase and every send segment is a contiguous slice.
    # float32 rank math: d * total overflows int32; float rounding only
    # nudges boundaries by elements and is identical on every device.
    total = jnp.maximum(jnp.sum(global_hist), 1)
    cum = jnp.cumsum(global_hist)
    bstart = cum - global_hist  # exclusive start rank per bucket
    # midpoint rank for the atomic rule; the ceil'd half keeps every
    # nonempty bucket's midpoint strictly below `total` (a trailing
    # 1-element bucket would otherwise satisfy cum_mid == total == Rd[D]
    # and be assigned to no device)
    cum_mid = cum - (global_hist + 1) // 2
    share = total.astype(jnp.float32) / jnp.float32(D)
    d_iota = jax.lax.broadcasted_iota(jnp.float32, (D + 1, 1), 0)[:, 0]
    Rd = (d_iota * share).astype(jnp.int32)
    Rd = Rd.at[D].set(total.astype(jnp.int32))  # exact top boundary
    c_me = local_hist
    atomic_below = (cum_mid[None, :] < Rd[:, None]).astype(jnp.int32)
    take_atomic = atomic_below * c_me[None, :]
    if split_uniform:
        # my within-bucket stable offset: earlier senders' counts (this is
        # the only consumer of the (D, R) hist_matrix gather)
        sender_iota = jax.lax.broadcasted_iota(jnp.int32, (D, 1), 0)
        o_me = jnp.sum(
            jnp.where(sender_iota < me, hist_matrix, 0), axis=0
        )  # (R,)
        # take_lt[d, b] = how many of MY bucket-b elems go to devices < d
        rank_cut = Rd[:, None] - (bstart + o_me)[None, :]  # (D+1, R)
        take_uniform = jnp.clip(rank_cut, 0, c_me[None, :])
        take_lt = jnp.where(uniform[None, :], take_uniform, take_atomic)
    else:
        take_lt = take_atomic
    extra_take = jnp.zeros((D + 1,), jnp.int32)
    if refine_levels > 0 and split_uniform and not return_partition and D > 1:
        take_lt, extra_take = _refined_assignment(
            sorted_all[:n_keys], edges, global_hist, uniform, take_lt,
            bstart, Rd, total, D, me, axis, refine_levels,
        )
    boundary = (jnp.sum(take_lt, axis=1) + extra_take).astype(
        jnp.int32
    )  # (D+1,)
    send_sizes = boundary[1:] - boundary[:-1]  # (D,)
    input_offsets = boundary[:-1]

    # 4-6. exchange + local finish
    out_planes, n_valid = _exchange_and_finish(
        sorted_all, n_keys, input_offsets, send_sizes, capacity, stable,
        use_ragged, axis, D, me, n_local, overlap=overlap,
        stage1_cap=stage1_cap,
    )
    outs = tuple(out_planes) + (n_valid[None],)
    if return_partition:
        # bucket id where each device's range starts, same comparison the
        # atomic rule uses (dev_start[d] <= b  <=>  Rd[d] <= cum_mid[b]),
        # so partition_exchange reproduces this shuffle's assignment
        # exactly. Top entry forced to N_BUCKETS so trailing one-element
        # buckets (cum_mid == total) are never dropped.
        dev_start = jnp.searchsorted(cum_mid, Rd, side="left").astype(
            jnp.int32
        )
        dev_start = dev_start.at[D].set(N_BUCKETS)
        outs = outs + (gmins, wshifts, wbits, dev_start)
    return outs


def _refined_assignment(
    words, edges, global_hist, uniform, take_lt, bstart, Rd, total, D, me,
    axis, levels,
):
    """Hierarchical hot-bucket refinement — the distributed analog of the
    reference's per-bucket depth recursion (sorter.rs:121-171).

    The 16-bit entropy-adaptive window collapses any key mass sharing a
    windowed prefix into ONE bucket; atomic assignment of a multi-key
    hot bucket then caps balance at that bucket's size (measured before
    this existed: bimodal-shift demand 4.0x of fair share on 8 devices,
    zipf-1.2 3.9x — scripts/capacity_study.py). Each refinement level
    re-partitions THE hottest multi-key bucket with a fresh 16-bit
    window over its own key range, nested inside its global-rank
    interval, reusing the same assignment rules: atomic midpoint for
    mixed refined buckets, exact stable-rank splitting for single-key
    refined buckets. Levels run unconditionally (static graph, one
    (D, 2^16) gather + O(n) window pass each) and are masked to no-ops
    when the hot bucket is small or single-key.

    Returns (take_lt with refined chain heads zeroed, (D+1,) extra
    boundary counts from the refined levels).
    """
    n_local = words[0].shape[0]
    R = N_BUCKETS
    iota = jax.lax.broadcasted_iota(jnp.int32, (n_local,), 0)
    riota = jnp.arange(R, dtype=jnp.int32)

    # chain head: the hottest level-0 bucket
    hot = jnp.argmax(global_hist).astype(jnp.int32)
    seg_lo = edges[hot]
    seg_hi = edges[hot + 1]
    base_rank = bstart[hot]
    # refine only a multi-key bucket bigger than half a device share
    active = (global_hist[hot] > total // (2 * D)) & (~uniform[hot])
    take_lt = jnp.where(((riota == hot) & active)[None, :], 0, take_lt)

    def seg_extrema(lo, hi):
        """EXACT per-word min/max over the chain segment (masked global
        reductions). Segment-first/last rows are NOT valid extrema for
        words below the most significant varying one — a varying word
        whose boundary rows coincide would read as constant, get zero
        window bits, and break the refined bucket id's monotonicity in
        the sorted order (wrong send segments => wrong output; regression
        pinned by tests/test_overflow.py::test_refinement_hidden_word)."""
        in_seg = (iota >= lo) & (iota < hi)
        mins, maxs = [], []
        for w in words:
            mins.append(jax.lax.pmin(
                jnp.min(jnp.where(in_seg, w, PAD_WORD)), axis
            ))
            maxs.append(jax.lax.pmax(
                jnp.max(jnp.where(in_seg, w, np.uint32(0))), axis
            ))
        return mins, maxs

    extra = jnp.zeros((D + 1,), jnp.int32)
    sender_iota = jax.lax.broadcasted_iota(jnp.int32, (D, 1), 0)
    for lvl in range(levels):
        cmin, cmax = seg_extrema(seg_lo, seg_hi)
        # fresh 16-bit window over the chain's own key range (span-based:
        # words constant within the chain contribute zero bits)
        remaining = jnp.int32(16)
        rg, rs, rb = [], [], []
        for wi in range(len(words)):
            span = cmax[wi] - cmin[wi]
            bl = _bit_length(span)
            b = jnp.minimum(bl, remaining)
            rg.append(cmin[wi])
            rs.append((bl - b).astype(jnp.uint32))
            rb.append(b)
            remaining = remaining - b
        rbuck = _apply_window(
            words, jnp.stack(rg), jnp.stack(rs), jnp.stack(rb)
        )
        # confine to the chain segment with order-preserving markers so
        # the refined histogram is one static-shape searchsorted
        rkey = jnp.where(
            iota < seg_lo, jnp.int32(-1),
            jnp.where(iota >= seg_hi, jnp.int32(R), rbuck),
        )
        redges = jnp.searchsorted(
            rkey, jnp.arange(R + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        rhist = redges[1:] - redges[:-1]
        rmatrix = jax.lax.all_gather(rhist, axis)  # (D, R)
        rglobal = jnp.sum(rmatrix, axis=0)
        rcum = jnp.cumsum(rglobal)
        rb_start = base_rank + rcum - rglobal  # global excl start / bucket
        rcum_mid = base_rank + rcum - (rglobal + 1) // 2
        o_me2 = jnp.sum(jnp.where(sender_iota < me, rmatrix, 0), axis=0)
        # single-key detection per refined bucket (first/last extrema —
        # exact for the most significant varying word, which is the one
        # that decides equality)
        first2 = jnp.clip(redges[:-1], 0, n_local - 1)
        last2 = jnp.clip(redges[1:] - 1, 0, n_local - 1)
        nonempty2 = rhist > 0
        runi = jnp.ones((R,), jnp.bool_)
        for w in words:
            lmin = jnp.where(nonempty2, jnp.take(w, first2), PAD_WORD)
            lmax = jnp.where(nonempty2, jnp.take(w, last2), np.uint32(0))
            gmn = jax.lax.pmin(lmin, axis)
            gmx = jax.lax.pmax(lmax, axis)
            runi = runi & (gmn == gmx)
        atomic2 = (rcum_mid[None, :] < Rd[:, None]).astype(jnp.int32) * (
            rhist[None, :]
        )
        cut2 = Rd[:, None] - (rb_start + o_me2)[None, :]
        uni2 = jnp.clip(cut2, 0, rhist[None, :])
        take2 = jnp.where(runi[None, :], uni2, atomic2)
        # next chain link: hottest refined child, refinable iff multi-key
        # and still big; its column defers to the next level. The LAST
        # level never defers (no next level would assign those rows):
        # its hot child stays in take2 under the atomic rule.
        hot2 = jnp.argmax(rglobal).astype(jnp.int32)
        active_next = (
            active & (rglobal[hot2] > total // (2 * D)) & (~runi[hot2])
            & (lvl < levels - 1)
        )
        take2 = jnp.where(((riota == hot2) & active_next)[None, :], 0,
                          take2)
        extra = extra + jnp.where(active, jnp.sum(take2, axis=1), 0)
        # advance the chain (next level recomputes exact extrema)
        seg_lo = redges[hot2]
        seg_hi = redges[hot2 + 1]
        base_rank = rb_start[hot2]
        active = active_next
    return take_lt, extra


def _hier_phase(
    planes, n_keys, input_offsets, send_sizes, capacity, stage1_cap,
    stable, use_ragged, axes, n_local,
):
    """One run of the two-stage hierarchical exchange + local sort.

    ``send_sizes`` may be sender-masked all-or-nothing by the overlapped
    caller (a masked-out device sends nothing this phase).  Returns
    (locally sorted ``capacity``-length planes LED by a validity plane —
    ``[validity, keys..., (src,) payloads...]`` — and the poisoned
    receive count).  The validity plane lets the overlapped caller merge
    two phases; :func:`_hier_exchange_and_finish` strips it.
    """
    host_ax, chip_ax = axes
    H = jax.lax.psum(1, host_ax)
    C = jax.lax.psum(1, chip_ax)
    h_me = jax.lax.axis_index(host_ax)
    c_me = jax.lax.axis_index(chip_ax)
    me = h_me * C + c_me

    # per-element flat destination (staircase over segment ends)
    ends = (input_offsets + send_sizes).astype(jnp.int32)
    iota = jax.lax.broadcasted_iota(jnp.int32, (n_local,), 0)
    dest = jnp.searchsorted(ends, iota, side="right").astype(jnp.uint32)
    ex_planes = list(planes) + [dest]
    if stable:
        ex_planes.append(jnp.full((n_local,), me, jnp.uint32))

    # stage 1: host-contiguous blocks along the host axis. The
    # intermediate buffer gets its own (larger) capacity: a chip's
    # stage-1 load is its column's share of the host's incoming data,
    # which skewed routing can push past the final balanced per-chip
    # capacity (config.hier_stage1_headroom).
    hs_sizes = jnp.sum(send_sizes.reshape(H, C), axis=1)
    hs_offsets = input_offsets.reshape(H, C)[:, 0]
    p1, valid1, n1 = _exchange_raw(
        ex_planes, hs_offsets, hs_sizes, stage1_cap, use_ragged, host_ax,
        H, h_me, n_local,
    )

    # stage 2: regroup by destination chip (pads route to C, sort last)
    dest1 = p1[len(planes)]
    route = jnp.where(
        valid1, dest1 % jnp.uint32(jnp.maximum(C, 1)), jnp.uint32(C)
    )
    srt = jax.lax.sort(tuple([route] + p1), num_keys=1, is_stable=True)
    routed = list(srt[1:])
    bounds = jnp.searchsorted(
        srt[0], jnp.arange(C + 1, dtype=jnp.uint32), side="left"
    ).astype(jnp.int32)
    # routed length is stage1_cap (ragged) or H*stage1_cap (dense)
    p2, valid2, n2 = _exchange_raw(
        routed, bounds[:-1], bounds[1:] - bounds[:-1], capacity,
        use_ragged, chip_ax, C, c_me, routed[0].shape[0],
    )

    out = p2[: len(planes)]
    validity = jnp.where(valid2, np.uint32(0), np.uint32(1))
    if stable:
        # source plane follows the keys in compare order; riders after
        src = p2[len(planes) + 1]
        sort_planes = [validity] + out[:n_keys] + [src] + out[n_keys:]
        nk_sort = 2 + n_keys
    else:
        sort_planes = [validity] + out
        nk_sort = 1 + n_keys
    finished = [
        p[:capacity] for p in jax.lax.sort(
            tuple(sort_planes), num_keys=nk_sort, is_stable=stable
        )
    ]
    # the reported count is the FINAL receive count (n2); a stage-1
    # intermediate overflow (n1 > stage1_cap: rows were dropped) poisons
    # it past capacity so gather_valid raises the OverflowError signal
    n_valid = jnp.where(n1 > stage1_cap, jnp.maximum(n1, n2), n2)
    return finished, n_valid


def _hier_exchange_and_finish(
    planes, n_keys, input_offsets, send_sizes, capacity, stable,
    use_ragged, axes, n_local, overlap=False, stage1_cap=None,
):
    """Two-stage hierarchical exchange over a (host, chip) mesh.

    The flat destination order is host-major, so each destination HOST's
    send data is one contiguous block: stage 1 moves host blocks along
    the host axis between same-index devices — every message between
    hosts is a single contiguous per-host block.  Stage 2 regroups
    locally by destination device (a stable route sort) and exchanges
    along the chip axis, within a host (NVLink).

    Exactness under rank-splitting: the flat destination of every element
    is computed ONCE on the source device (a searchsorted staircase over
    the send boundaries) and carried as a rider plane, so single-key
    buckets split by stable rank route identically to the 1-axis path.
    Stability: the two-stage exchange delivers ties in (source-chip,
    source-host) order rather than flat source order, so stable mode
    carries a source-device plane and the final sort tiebreaks on it
    (each source's internal order survives every stage — all interchanges
    are segment-order-preserving and the route sort is stable).

    ``overlap=True`` splits by sender HOST half: hosts < H/2 run the full
    two-stage exchange in phase 1, the rest in phase 2, and phase 1's
    local sort can hide under phase 2's collectives (the same
    sender-half pipelining as the 1-axis path).  The two sorted capacity
    buffers combine with the bitonic merge on (validity, keys);
    phase-1 senders all precede phase-2 senders in flat order and the
    merge's a-side wins ties, so stable mode survives (each phase's
    output is already in (key, source, arrival) order internally).
    """
    if stage1_cap is None:
        from rdst_tpu import config

        stage1_cap = max(
            int(np.ceil(capacity * config.hier_stage1_headroom)), capacity
        )
    host_ax, _ = axes
    H = jax.lax.psum(1, host_ax)
    if overlap and H > 1:
        half = H // 2
        h_me = jax.lax.axis_index(host_ax)
        sizes1 = jnp.where(h_me < half, send_sizes, 0)
        sizes2 = send_sizes - sizes1
        q1, v1 = _hier_phase(
            planes, n_keys, input_offsets, sizes1, capacity, stage1_cap,
            stable, use_ragged, axes, n_local,
        )
        q2, v2 = _hier_phase(
            planes, n_keys, input_offsets, sizes2, capacity, stage1_cap,
            stable, use_ragged, axes, n_local,
        )
        from rdst_tpu.ops.merge import merge_sorted

        cap2 = 1 << max(0, (capacity - 1).bit_length())

        def padp(p):
            fill = p.dtype.type(PAD_WORD)
            return (
                jnp.concatenate(
                    [p, jnp.full((cap2 - capacity,), fill, p.dtype)]
                )
                if cap2 > capacity else p
            )

        merged = merge_sorted(
            [padp(p) for p in q1], [padp(p) for p in q2], 1 + n_keys,
            stable=stable,
        )
        out = [p[:capacity] for p in merged[1:]]
        if stable:
            out = out[:n_keys] + out[n_keys + 1 :]
        return out, v1 + v2
    q, nv = _hier_phase(
        planes, n_keys, input_offsets, send_sizes, capacity, stage1_cap,
        stable, use_ragged, axes, n_local,
    )
    out = q[1:]
    if stable:
        out = out[:n_keys] + out[n_keys + 1 :]
    return out, nv


def _exchange_and_finish(
    planes, n_keys, input_offsets, send_sizes, capacity, stable,
    use_ragged, axis, D, me, n_local, overlap=False, stage1_cap=None,
):
    """All-to-all of contiguous send segments + local re-sort.

    ``planes``: locally key-sorted word+payload planes; segment for
    destination d is ``[input_offsets[d], input_offsets[d]+send_sizes[d])``.
    Returns (capacity-sized planes in sorted order with PAD_WORD tails,
    received-row count).  A tuple ``axis`` routes to the two-stage
    hierarchical (host, chip) exchange.

    ``overlap=True`` runs the exchange in TWO phases split by SENDER half
    (devices < D/2 send in phase 1, the rest in phase 2) and finishes
    phase 1's local sort while phase 2 is in flight — XLA's async
    collectives let the phase-1 sort hide under the phase-2 all-to-all
    (SURVEY §7 step 6; the reference's scanning workers stream counts
    while scattering, scanning_sort.rs:91-218).  The two sorted halves
    combine with the bitonic merge (ops/merge.py), which keeps the
    sender order on ties, so stable mode is preserved: phase-1 senders
    all precede phase-2 senders, and the merge's a-side wins ties.
    Single-chip semantics are identical to the sequential path (parity
    pinned by tests/test_exchange_parity.py).
    """
    if isinstance(axis, tuple):
        return _hier_exchange_and_finish(
            planes, n_keys, input_offsets, send_sizes, capacity, stable,
            use_ragged, axis, n_local, overlap=overlap,
            stage1_cap=stage1_cap,
        )
    if overlap and D > 1:
        half = D // 2
        sizes1 = jnp.where(me < half, send_sizes, 0)
        sizes2 = send_sizes - sizes1
        p1, v1 = _exchange_once(
            planes, n_keys, input_offsets, sizes1, capacity, stable,
            use_ragged, axis, D, me, n_local,
        )
        p2, v2 = _exchange_once(
            planes, n_keys, input_offsets, sizes2, capacity, stable,
            use_ragged, axis, D, me, n_local,
        )
        # merge the two sorted capacity buffers (validity plane leads so
        # pads sort behind real all-ones keys); a-side = phase-1 senders
        from rdst_tpu.ops.merge import merge_sorted

        cap2 = 1 << max(0, (capacity - 1).bit_length())
        def padp(p):
            fill = p.dtype.type(PAD_WORD)
            return (
                jnp.concatenate([p, jnp.full((cap2 - capacity,), fill,
                                             p.dtype)])
                if cap2 > capacity else p
            )
        merged = merge_sorted(
            [padp(p) for p in p1], [padp(p) for p in p2], 1 + n_keys,
            stable=stable,
        )
        return [p[:capacity] for p in merged[1:]], v1 + v2
    out_planes, valid_mask, n_valid = _exchange_raw(
        planes, input_offsets, send_sizes, capacity, use_ragged, axis, D,
        me, n_local,
    )
    return _finish_sort(out_planes, valid_mask, n_keys, capacity, stable), \
        n_valid


def _exchange_once(
    planes, n_keys, input_offsets, send_sizes, capacity, stable,
    use_ragged, axis, D, me, n_local,
):
    """One phase of the overlapped exchange: raw exchange + local sort.

    Returns capacity-sized planes LED by the validity plane (0 = real,
    1 = pad) so the caller can merge phases, plus the valid count.
    """
    out_planes, valid_mask, n_valid = _exchange_raw(
        planes, input_offsets, send_sizes, capacity, use_ragged, axis, D,
        me, n_local,
    )
    validity = jnp.where(valid_mask, np.uint32(0), np.uint32(1))
    resorted = jax.lax.sort(
        tuple([validity] + list(out_planes)), num_keys=1 + n_keys,
        is_stable=stable,
    )
    return [p[:capacity] for p in resorted], n_valid


def _finish_sort(out_planes, valid_mask, n_keys, capacity, stable):
    # local sort of received data; a leading validity plane keeps pads
    # behind any real all-ones keys, then truncate to capacity.
    validity = jnp.where(valid_mask, np.uint32(0), np.uint32(1))
    resorted = jax.lax.sort(
        tuple([validity] + list(out_planes)), num_keys=1 + n_keys,
        is_stable=stable,
    )
    return [p[:capacity] for p in resorted[1:]]


def _exchange_raw(
    planes, input_offsets, send_sizes, capacity, use_ragged, axis, D, me,
    n_local,
):
    """The bare collective: returns (received planes, validity mask,
    valid count)."""
    if D == 1:
        # degenerate 1-device axis: the exchange is an identity (the
        # single send segment covers the whole resident shard at offset
        # 0), so the collective is skipped.
        tail = capacity - n_local
        out_planes = [
            jnp.concatenate(
                [a, jnp.full((tail,), a.dtype.type(PAD_WORD), a.dtype)]
            )
            if tail > 0 else a[:capacity]
            for a in planes
        ]
        pos = jax.lax.broadcasted_iota(jnp.int32, (capacity,), 0)
        n_valid = jnp.sum(send_sizes)
        return out_planes, pos < n_valid, n_valid
    # size matrix via all_gather -> offsets in receiver buffers
    size_matrix = jax.lax.all_gather(send_sizes, axis)  # (D, D)[sender, dst]
    recv_sizes = size_matrix[:, me]  # what each sender sends me
    # where MY segment starts in each receiver's buffer: senders before me
    output_offsets = jnp.sum(
        jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, size_matrix.shape, 0) < me,
            size_matrix,
            0,
        ),
        axis=0,
    )  # (D,) per destination

    # exchange per plane. The default is the dense all_to_all of
    # worst-case ``capacity`` chunks per sender, which moves and allocates
    # about D times the bytes needed. ``use_ragged=True`` sends exact-size
    # segments with ``ragged_all_to_all`` (NCCL on GPUs); it is opt-in
    # because a repeated call on four GPUs returned wrong rows, and
    # XLA:CPU has no lowering for it (tests emulate the primitive).
    n_valid = jnp.sum(recv_sizes)
    if use_ragged:
        out_planes = []
        for a in planes:
            buf = jnp.full((capacity,), PAD_WORD, dtype=a.dtype)
            out = jax.lax.ragged_all_to_all(
                a,
                buf,
                input_offsets.astype(jnp.int32),
                send_sizes.astype(jnp.int32),
                output_offsets.astype(jnp.int32),
                recv_sizes.astype(jnp.int32),
                axis_name=axis,
            )
            out_planes.append(out)
        # valid positions are per-sender segments in the output buffer
        recv_offsets = exclusive_prefix_sum(recv_sizes)
        pos = jax.lax.broadcasted_iota(jnp.int32, (D, capacity), 1)
        seg_valid = (pos >= recv_offsets[:, None]) & (
            pos < (recv_offsets + recv_sizes)[:, None]
        )
        valid_mask = jnp.any(seg_valid, axis=0)
    else:
        chunk = capacity  # worst case: one sender fills my whole buffer
        pos = jax.lax.broadcasted_iota(jnp.int32, (D, chunk), 1)
        out_planes = []
        for a in planes:
            idx = jnp.clip(input_offsets[:, None] + pos, 0, n_local - 1)
            send_buf = jnp.where(
                pos < send_sizes[:, None], a[idx], a.dtype.type(PAD_WORD)
            )
            recv = jax.lax.all_to_all(
                send_buf, axis, split_axis=0, concat_axis=0, tiled=False
            )  # (D, chunk): row i = chunk from sender i
            out_planes.append(recv.reshape(-1))
        valid_mask = (pos < recv_sizes[:, None]).reshape(-1)

    return out_planes, valid_mask, n_valid


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "n_key_words", "capacity", "stage1_cap", "stable",
        "use_ragged", "split_uniform", "return_partition", "overlap",
        "refine_levels",
    ),
)
def _distributed_sort_jit(
    arrs, mesh: Mesh, axis: str, n_key_words: int, capacity: int,
    stage1_cap: int, stable: bool, use_ragged: bool,
    split_uniform: bool = True, return_partition: bool = False,
    overlap: bool = False, refine_levels: int = 0,
):
    body = functools.partial(
        _local_shard_body, axis, n_key_words, capacity, stage1_cap, stable,
        use_ragged, split_uniform, return_partition, overlap, refine_levels,
    )
    n_arr = len(arrs)
    n_part = 4 if return_partition else 0
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(P(axis) for _ in range(n_arr)),
        out_specs=tuple(P(axis) for _ in range(n_arr + 1))
        + tuple(P() for _ in range(n_part)),
        # the partition outputs are replicated by construction (pure
        # functions of psum/pmin/pmax results) but the static VMA check
        # cannot see through searchsorted/cumsum chains
        check_vma=not return_partition,
    )
    out = fn(*arrs)
    if return_partition:
        return out[: n_arr], out[n_arr], tuple(out[n_arr + 1 :])
    return out[:-1], out[-1], None


def _partition_body(
    axis: str,
    n_key_words: int,
    capacity: int,
    stage1_cap: int,
    stable: bool,
    use_ragged: bool,
    overlap: bool,
    gmins,
    wshifts,
    wbits,
    dev_start,
    *arrs,
):
    """shard_map body for :func:`partition_exchange`: route rows by a
    PRE-COMPUTED partition (window + device bucket ranges) instead of a
    freshly balanced one."""
    planes = list(arrs)
    D = jax.lax.psum(1, axis)
    me = _flat_index(axis)
    n_local = planes[0].shape[0]
    n_keys = n_key_words
    buckets0 = _apply_window(planes[:n_keys], gmins, wshifts, wbits)
    # local sort by (bucket, key): send segments must be bucket-contiguous
    # even where window saturation breaks key-monotonicity of the bucket
    # map (out-of-range keys of a foreign window)
    srt = jax.lax.sort(
        tuple([buckets0] + planes), num_keys=1 + n_keys, is_stable=stable
    )
    buckets = srt[0]
    planes_sorted = list(srt[1:])
    boundary = jnp.searchsorted(buckets, dev_start, side="left").astype(
        jnp.int32
    )  # (D+1,)
    send_sizes = boundary[1:] - boundary[:-1]
    input_offsets = boundary[:-1]
    out_planes, n_valid = _exchange_and_finish(
        planes_sorted, n_keys, input_offsets, send_sizes, capacity, stable,
        use_ragged, axis, D, me, n_local, overlap=overlap,
        stage1_cap=stage1_cap,
    )
    return tuple(out_planes) + (n_valid[None],)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "n_key_words", "capacity", "stage1_cap", "stable",
        "use_ragged", "overlap",
    ),
)
def _partition_exchange_jit(
    arrs, partition, mesh: Mesh, axis: str, n_key_words: int,
    capacity: int, stage1_cap: int, stable: bool, use_ragged: bool,
    overlap: bool = False,
):
    body = functools.partial(
        _partition_body, axis, n_key_words, capacity, stage1_cap, stable,
        use_ragged, overlap,
    )
    n_arr = len(arrs)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(P() for _ in range(4))
        + tuple(P(axis) for _ in range(n_arr)),
        out_specs=tuple(P(axis) for _ in range(n_arr + 1)),
    )
    out = fn(*partition, *arrs)
    return out[:-1], out[-1]


def partition_exchange(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array],
    partition,
    *,
    mesh: Mesh,
    axis: str = "shard",
    capacity_factor: float = 1.5,
    stable: bool = False,
    use_ragged: bool = False,
    overlap_exchange: bool = False,
):
    """Route rows to devices by an EXISTING partition (co-partitioning).

    ``partition`` is the 4-tuple returned by
    ``distributed_sort(..., split_uniform=False, return_partition=True)``:
    the entropy-adaptive window parameters plus each device's bucket
    range. Rows whose key falls in bucket b land on the same device that
    the originating shuffle assigned bucket b to — the join-side
    guarantee that equal keys of two datasets meet on one device
    (SURVEY.md §7 step 7: "partition both sides by the same MSB
    shuffle"). Keys outside the originating window's range saturate into
    its edge buckets (they have no join partner by construction).

    Same return convention as :func:`distributed_sort`.
    """
    from rdst_tpu import config

    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
    D = mesh.devices.size
    n = int(words[0].shape[0])
    if n % D != 0:
        raise ValueError(f"global length {n} not divisible by mesh size {D}")
    n_local = n // D
    capacity = int(np.ceil(capacity_factor * n_local))
    if n <= config.replicate_capacity_max:
        # replication-aware floor: a device can never receive more rows
        # than exist, so full-table capacity covers ANY partition skew
        # for small (dim) tables without a mesh-size-scaled factor
        capacity = max(capacity, n)
    capacity = max(capacity, 16)
    arrs = tuple(words) + tuple(payloads)
    sharding = NamedSharding(mesh, P(axis))
    arrs = tuple(jax.device_put(a, sharding) for a in arrs)
    stage1_cap = max(
        int(np.ceil(capacity * config.hier_stage1_headroom)), capacity
    )
    out, counts = _partition_exchange_jit(
        arrs, tuple(partition), mesh, axis, len(words), capacity,
        stage1_cap, stable, use_ragged, overlap=overlap_exchange,
    )
    k = len(words)
    return list(out[:k]), list(out[k:]), counts


def distributed_sort(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array] = (),
    *,
    mesh: Mesh,
    axis: str = "shard",
    capacity_factor: float = 1.5,
    stable: bool = False,
    split_uniform: bool = True,
    return_partition: bool = False,
    use_ragged: bool = False,
    overlap_exchange: bool = False,
):
    """Sort globally over a mesh axis.

    ``words``/``payloads``: uint32 planes, length divisible by mesh size
    (caller pads with 0xFFFFFFFF key words if needed). Returns
    ``(words, payloads, counts)`` where each plane is (D * capacity,) laid
    out device-major — device d's valid slice is
    ``plane[d*capacity : d*capacity + counts[d]]`` — and the concatenation
    of valid slices in device order is the globally sorted sequence.

    ``split_uniform=False`` keeps every bucket device-atomic (required when
    the partition will be reused for co-partitioning another dataset);
    ``return_partition=True`` appends the reusable partition state for
    :func:`partition_exchange` as a fourth return value.
    ``overlap_exchange=True`` pipelines the all-to-all in two sender-half
    phases so the first half's local sort hides under the second half's
    collective (see _exchange_and_finish) — bitwise-identical output.

    ``use_ragged=True`` swaps the dense all_to_all for the exact-size
    ``ragged_all_to_all`` (see _exchange_raw for why it is opt-in).

    A 2-axis mesh (``make_mesh_2d``) with ``axis=mesh.axis_names`` runs
    the hierarchical (host, chip) exchange: contiguous per-host blocks
    between hosts, then a regroup within each host
    (_hier_exchange_and_finish).
    ``overlap_exchange`` there splits by sender-host half (no-op pipelined
    into a single phase when the host axis has one device).
    """
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
    D = mesh.devices.size
    n = int(words[0].shape[0])
    if n % D != 0:
        raise ValueError(f"global length {n} not divisible by mesh size {D}")
    n_local = n // D
    capacity = int(np.ceil(capacity_factor * n_local))
    capacity = max(capacity, 16)
    arrs = tuple(words) + tuple(payloads)
    sharding = NamedSharding(mesh, P(axis))
    arrs = tuple(jax.device_put(a, sharding) for a in arrs)
    from rdst_tpu import config

    stage1_cap = max(
        int(np.ceil(capacity * config.hier_stage1_headroom)), capacity
    )
    out, counts, partition = _distributed_sort_jit(
        arrs, mesh, axis, len(words), capacity, stage1_cap, stable,
        use_ragged, split_uniform=split_uniform,
        return_partition=return_partition, overlap=overlap_exchange,
        refine_levels=config.shuffle_refine_levels,
    )
    k = len(words)
    if return_partition:
        return list(out[:k]), list(out[k:]), counts, partition
    return list(out[:k]), list(out[k:]), counts


def distributed_sort_auto(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array] = (),
    *,
    mesh: Mesh,
    capacity_factor: float = 1.5,
    max_capacity_factor: float = 16.0,
    **kwargs,
):
    """:func:`distributed_sort` with automatic overflow retry.

    Extreme skew (a hot bucket holding many distinct keys beyond the
    16 window bits) can demand more rows on one device than the
    ``capacity_factor``-sized buffer holds; plain ``distributed_sort``
    reports that through counts and :func:`gather_valid` raises
    OverflowError (the reference's analog is scanning_sort's
    uniform_threshold skew handling, scanning_sort.rs:109-126 — a static
    plan with a detectable escape). This wrapper inspects the counts and
    DOUBLES the factor until every device fits or ``max_capacity_factor``
    is exceeded. Each retry recompiles (capacity is a static shape), so
    callers with a known skew bound should size ``capacity_factor``
    directly; scripts/capacity_study.py counts each distribution's demand
    and overflow on the CPU mesh.
    """
    f = capacity_factor
    D = mesh.devices.size
    while True:
        out = distributed_sort(
            words, payloads, mesh=mesh, capacity_factor=f, **kwargs
        )
        counts = np.asarray(out[2])
        cap = out[0][0].shape[0] // D
        if int(counts.max(initial=0)) <= cap:
            return out
        if f >= max_capacity_factor:
            raise OverflowError(
                f"device demand {int(counts.max())} rows > capacity {cap} "
                f"at capacity_factor={f} (max {max_capacity_factor})"
            )
        f = min(f * 2.0, max_capacity_factor)


def gather_valid(planes: Sequence[jax.Array], counts) -> list[np.ndarray]:
    """Host helper: concatenate the valid device-major slices densely.

    ``counts[d]`` reports the number of rows RECEIVED by device d (demand),
    which exceeds the buffer capacity under extreme skew — that's the
    overflow signal (raise rather than slice garbage; retry with a larger
    ``capacity_factor``).
    """
    counts = np.asarray(counts)
    D = counts.shape[0]
    out = []
    for p in planes:
        p = np.asarray(p).reshape(D, -1)
        cap = p.shape[1]
        if (counts > cap).any():
            raise OverflowError(
                f"device received {int(counts.max())} rows > capacity {cap}; "
                "increase capacity_factor"
            )
        out.append(
            np.concatenate([p[d, : counts[d]] for d in range(D)])
        )
    return out
