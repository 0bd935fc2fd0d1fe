"""Sort execution plans — the XLA equivalents of the reference's eight
algorithms (reference: src/sorts/, SURVEY.md §2.2).

Plan families and the Algorithm values they serve (see sorter.py):

  comparative.py  — variadic lax.sort               (Comparative)
  lsb.py          — level-compacted stable sort     (Lsb, LrLsb, MtLsb,
                                                     Ska, Recombinating,
                                                     Scanning)
  msb.py          — bucketed MSB partition + batched
                    bucket sorts + ragged writeback (MtOop)
  regions.py      — low-memory chunked + merge tree (Regions)
"""
from rdst_tpu.sorts.comparative import comparative_sort
from rdst_tpu.sorts.lsb import packed_sort
from rdst_tpu.sorts.msb import bucketed_sort
from rdst_tpu.sorts.regions import chunked_sort

__all__ = [
    "comparative_sort",
    "packed_sort",
    "bucketed_sort",
    "chunked_sort",
]
