"""Sorter: the dispatch layer routing a sort to an execution plan.

Re-design of the reference's recursive router (reference:
src/sorter.rs:10-171). The reference recurses per 256-bucket with
data-dependent shapes — that cannot jit. Instead the sorter:

  1. computes ALL levels' histograms + sortedness in one jitted call
     (the reference re-scans per level/bucket — sorter.rs:50-55),
  2. short-circuits fully-sorted inputs (sorter.rs:59-65),
  3. asks the pluggable Tuner for an Algorithm using the top level's counts
     (sorter.rs:67-76),
  4. runs the chosen plan as a fixed-depth pass schedule chosen from the
     histograms, entirely on device.

len<=1 early-out lives in the builder (radix_sort_builder.rs:150-152);
len<=128 comparative short-circuit here (sorter.rs:35-38).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import numpy as np

from rdst_tpu import config
from rdst_tpu.keys import NormalizedKeys
from rdst_tpu.ops.histogram import HistogramResult, multi_level_histogram
from rdst_tpu.tuner import (
    SINGLE_PROGRAM_ALGORITHMS,
    Algorithm,
    StandardTuner,
    Tuner,
    TuningParams,
)

__all__ = ["Sorter", "PlanContext", "register_plan", "get_plan"]

#: Small-input comparative cutoff (reference: src/sorter.rs:35-38).
COMPARATIVE_CUTOFF = 128

#: Nominal parallelism reported to tuners: grid programs, not OS threads.
#: (The reference reports rayon::current_num_threads, sorter.rs:108.)
DEFAULT_THREADS = 8


@dataclasses.dataclass
class PlanContext:
    """Everything an execution plan may need."""

    hist: HistogramResult | None
    stable: bool
    parallel: bool
    algorithm: Algorithm
    tuner: Tuner


# plan registry: Algorithm -> fn(words, payloads, ctx) -> (words, payloads)
_PLANS: dict[Algorithm, Callable] = {}


def register_plan(algo: Algorithm):
    def deco(fn):
        _PLANS[algo] = fn
        return fn

    return deco


def get_plan(algo: Algorithm) -> Callable:
    return _PLANS[algo]


class Sorter:
    """Routes one sort request to a plan (reference Sorter, sorter.rs:10-22)."""

    def __init__(self, parallel: bool = True, tuner: Tuner | None = None):
        self.parallel = parallel
        self.tuner = tuner if tuner is not None else StandardTuner()

    def run(
        self,
        nk: NormalizedKeys,
        payloads: Sequence[jax.Array] = (),
        *,
        stable: bool = False,
        hist: HistogramResult | None = None,
    ) -> tuple[NormalizedKeys, list[jax.Array]]:
        """Histogram -> tuner -> plan. ``hist`` may be precomputed (e.g.
        from a prior ``multi_level_histogram`` call); since HistogramResult
        is host-side numpy, passing it makes this method fully traceable
        under jit — the histogram/tuner decision happens at trace time,
        exactly like the reference consulting the tuner on every sort
        (sorter.rs:67-76) but with the data scan hoisted out."""
        words = list(nk.words)
        payloads = list(payloads)
        n = int(words[0].shape[0])
        L = nk.n_bytes

        if n <= COMPARATIVE_CUTOFF:
            algo = Algorithm.COMPARATIVE
            hist = None
        else:
            if hist is None:
                hist = multi_level_histogram(words, L)
            if hist.fully_sorted():
                # already-sorted short circuit (sorter.rs:59-65): every
                # level's digit sequence is nondecreasing => identity sort.
                # (Payload order is already the stable outcome.)
                self._trace(L - 1, "AlreadySorted", n)
                return nk, payloads
            params = TuningParams(
                threads=DEFAULT_THREADS if self.parallel else 1,
                level=L - 1,
                total_levels=L,
                input_len=n,
                parent_len=None,
            )
            algo = self.tuner.pick_algorithm(
                params, hist.counts[L - 1].tolist()
            )
            if not self.parallel and algo not in SINGLE_PROGRAM_ALGORITHMS:
                # reference single-threaded builds only have the reduced
                # Algorithm enum (tuner.rs:24-31); map to the closest
                # single-program plan.
                algo = Algorithm.LSB

        self._trace(L - 1, algo, n)
        ctx = PlanContext(
            hist=hist,
            stable=stable,
            parallel=self.parallel,
            algorithm=algo,
            tuner=self.tuner,
        )
        plan = _PLANS[algo]
        split = _presorted_split(n, hist)
        if algo is Algorithm.MT_OOP:
            # bucketed_sort sizes its buckets from ctx.hist's full-input
            # counts — running it on a suffix would partition wrongly.
            split = None
        if split is not None:
            # presorted-input advantage (lsb_sort.rs:62-83's runtime skip,
            # struct_sort.rs:43-127's 90%-presorted regime): keep the
            # sorted prefix, run the plan on the suffix only, then
            # bitonic-merge the halves (ops/merge.py).
            self._trace(L - 1, f"PresortedMerge[{algo.value}]", n)
            out_words, out_payloads = _presorted_merge(
                words, payloads, split, plan, ctx, stable
            )
        else:
            out_words, out_payloads = plan(words, payloads, ctx)
        return (
            NormalizedKeys(tuple(out_words), nk.n_bytes, nk.meta),
            list(out_payloads),
        )

    @staticmethod
    def _trace(level: int, algo, n: int) -> None:
        _trace_pick(level, algo, n)


def _trace_pick(level: int, algo, n: int) -> None:
    # work_profiles-equivalent pick trace (reference: sorter.rs:78-79
    # prints "({level}) PAR: {algorithm:?}").
    if config.work_profiles_enabled():
        name = algo.value if isinstance(algo, Algorithm) else str(algo)
        print(f"({level}) PLAN: {name} len={n}")


def _presorted_split(n: int, hist) -> tuple[int, int] | None:
    """(split, padded_total) when the presorted-prefix path should engage.

    The split is the sorted-prefix length quantized DOWN to sixteenths of
    the padded power-of-two total (a shorter prefix is still sorted, and
    quantizing bounds the jit cache to a handful of suffix shapes).
    Engages when the quantized prefix covers at least half the input.
    """
    if hist is None or n < config.presorted_merge_min:
        return None
    prefix = getattr(hist, "sorted_prefix", 0)
    T = 1 << (n - 1).bit_length()
    q = T // 16
    s = (min(prefix, n) // q) * q
    if s * 2 < n or s >= n or s <= 0:
        return None
    return s, T


def _presorted_merge(words, payloads, split, plan, ctx, stable):
    """Sort only the suffix, then bitonic-merge prefix and suffix.

    Pads (to the power-of-two total) carry all-ones keys plus a validity
    plane appended as the LEAST significant key, so they sort strictly
    after every real element — including real all-ones keys — and slice
    off the tail.  Stability: the prefix keeps its original order, the
    suffix plan honors ``stable``, and ``merge_sorted(stable=True)``
    breaks key ties a-side-first (prefix elements precede suffix elements
    in the input order).
    """
    import jax.numpy as jnp

    from rdst_tpu.ops.merge import merge_sorted

    s, T = split
    n = int(words[0].shape[0])
    nw = len(words)
    suf_w, suf_p = plan(
        [w[s:] for w in words], [p[s:] for p in payloads], ctx
    )
    pad = T - n

    def a_side(p):
        return p[:s]

    def b_side(p, fill):
        if pad == 0:
            return p
        return jnp.concatenate([p, jnp.full((pad,), fill, p.dtype)])

    ones = lambda p: p.dtype.type(np.iinfo(p.dtype).max)
    zero = lambda p: (
        p.dtype.type(0)
        if jnp.issubdtype(p.dtype, jnp.number)
        else np.uint32(0)
    )
    a = (
        [a_side(w) for w in words]
        + [jnp.zeros((s,), jnp.uint32)]
        + [a_side(p) for p in payloads]
    )
    b = (
        [b_side(w, ones(w)) for w in suf_w]
        + [
            jnp.concatenate(
                [jnp.zeros((n - s,), jnp.uint32),
                 jnp.ones((pad,), jnp.uint32)]
            )
            if pad
            else jnp.zeros((n - s,), jnp.uint32)
        ]
        + [b_side(p, zero(p)) for p in suf_p]
    )
    merged = merge_sorted(a, b, nw + 1, stable=stable)
    merged = [p[:n] for p in merged]
    return merged[:nw], merged[nw + 1 :]


def _register_default_plans():
    """Populate the plan registry (lazy imports avoid cycles).

    Mapping of the reference's eight algorithms onto the four plan
    families. The tuners pick the same Algorithm NAMES at the same
    thresholds as the reference (tuner.py); this table decides what each
    name EXECUTES:

      COMPARATIVE          -> variadic lax.sort
      LSB, MT_LSB          -> level-compacted stable sort (sorts/lsb.py)
      LR_LSB, SKA          -> same compaction, skew/low-entropy regime
                              (unstable allowed for SKA, like the
                              reference's in-place ska)
      RECOMBINATING,
      SCANNING             -> the reference's large-uniform picks: the
                              dense lax.sort, entered through the
                              level-compaction pre-pass (packed_sort falls
                              back to the plain sort when nothing
                              compacts, and narrows/drops words when the
                              histogram allows)
      MT_OOP               -> MSB bucketed partition + batched bucket
                              sorts + ragged writeback (sorts/msb.py) —
                              kept as the explicitly requestable bucketed
                              plan (no built-in tuner ladder picks MT_OOP)
      REGIONS              -> low-memory chunked sort + bitonic merge
                              tree (sorts/regions.py)
    """
    from rdst_tpu.sorts.comparative import comparative_sort
    from rdst_tpu.sorts.lsb import packed_sort
    from rdst_tpu.sorts.msb import bucketed_sort
    from rdst_tpu.sorts.regions import chunked_sort

    def comparative_plan(words, payloads, ctx: PlanContext):
        return comparative_sort(words, payloads, stable=ctx.stable)

    def lsb_plan(words, payloads, ctx: PlanContext):
        counts = ctx.hist.counts if ctx.hist is not None else None
        # LSB family is stable by contract (reference lib.rs docs)
        return packed_sort(words, payloads, counts, stable=True)

    def ska_plan(words, payloads, ctx: PlanContext):
        counts = ctx.hist.counts if ctx.hist is not None else None
        return packed_sort(words, payloads, counts, stable=ctx.stable)

    def msb_plan(words, payloads, ctx: PlanContext):
        counts = ctx.hist.counts if ctx.hist is not None else None
        return bucketed_sort(
            words, payloads, counts, stable=ctx.stable, tuner=ctx.tuner,
            parallel=ctx.parallel,
        )

    def regions_plan(words, payloads, ctx: PlanContext):
        # The reference's Regions is a resource policy, not a speed play
        # (regions_sort.rs:3-10). Engage the chunked low-memory machinery
        # only under real memory pressure (config.low_mem_threshold);
        # otherwise Regions' tuner regime (large skewed/low-entropy
        # inputs) runs level compaction, which skips the merge tree's
        # extra passes.
        n = int(words[0].shape[0])
        working_set = n * (len(words) + len(payloads)) * 4
        if working_set < config.low_mem_threshold():
            counts = ctx.hist.counts if ctx.hist is not None else None
            return packed_sort(words, payloads, counts, stable=ctx.stable)
        return chunked_sort(words, payloads, stable=ctx.stable)

    _PLANS[Algorithm.COMPARATIVE] = comparative_plan
    _PLANS[Algorithm.LSB] = lsb_plan
    _PLANS[Algorithm.LR_LSB] = lsb_plan
    _PLANS[Algorithm.MT_LSB] = lsb_plan
    _PLANS[Algorithm.SKA] = ska_plan
    _PLANS[Algorithm.MT_OOP] = msb_plan
    _PLANS[Algorithm.RECOMBINATING] = ska_plan
    _PLANS[Algorithm.SCANNING] = ska_plan
    _PLANS[Algorithm.REGIONS] = regions_plan


_register_default_plans()
