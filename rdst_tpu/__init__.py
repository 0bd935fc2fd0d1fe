"""rdst_tpu — a vectorized sort-and-partition execution engine on JAX/XLA.

A from-scratch JAX/XLA framework with the capabilities of the
reference hybrid radix sort library (nessex/rdst): multi-pass LSB/MSB radix
sorting of integer/float/byte-array/composite keys with pluggable tuners,
generalized to distributed (multi-device mesh) shuffle sorts and a columnar
table engine (sort / filter / aggregate / join).

Public API mirrors the reference surface (reference: src/radix_sort.rs:4-19,
src/radix_sort_builder.rs:53-157) in functional JAX style:

    import rdst_tpu as rt
    y = rt.radix_sort_unstable(x)                     # sorted copy
    y = rt.radix_sort_builder(x).with_low_mem_tuner().sort()
    y, vals = rt.sort_key_value(keys, vals, stable=True)
"""
from rdst_tpu import keys
from rdst_tpu.tuner import (
    Algorithm,
    TuningParams,
    Tuner,
    StandardTuner,
    LowMemoryTuner,
    SingleThreadedTuner,
)
from rdst_tpu.builder import (
    RadixSortBuilder,
    radix_sort_unstable,
    radix_sort_builder,
    sort_key_value,
    argsort,
)
from rdst_tpu.ops.rows import batched_sort, batched_top_k
from rdst_tpu import jit_api
from rdst_tpu.table import Table

__version__ = "0.1.0"

__all__ = [
    "keys",
    "Algorithm",
    "TuningParams",
    "Tuner",
    "StandardTuner",
    "LowMemoryTuner",
    "SingleThreadedTuner",
    "RadixSortBuilder",
    "radix_sort_unstable",
    "radix_sort_builder",
    "sort_key_value",
    "argsort",
    "batched_sort",
    "batched_top_k",
    "jit_api",
    "Table",
]
