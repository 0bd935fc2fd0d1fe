"""Row-batched sorting: many independent small sorts at once.

The XLA analog of the reference's per-bucket parallel recursion
(reference: sorter.rs:121-139 — 256 sub-buckets dispatched to the rayon
pool): one batched sort along the last axis, and a per-row top_k where
only the first k are wanted.
"""
import numpy as np

import rdst_tpu as rt

rng = np.random.default_rng(0)

# 512 independent series of 1024 f32 scores with row-aligned ids
scores = rng.standard_normal((512, 1024)).astype(np.float32)
ids = np.broadcast_to(np.arange(1024, dtype=np.uint32), scores.shape).copy()

rows_sorted, (ids_sorted,) = rt.batched_sort(scores, [ids], stable=True)
assert np.array_equal(np.asarray(rows_sorted), np.sort(scores, axis=-1))
print("rows sorted:", np.asarray(rows_sorted)[0, :4])

# per-row top-8 by score, ids gathered alongside
top, (top_ids,) = rt.batched_top_k(scores, 8, [ids], largest=True)
want = np.sort(scores, axis=-1)[:, ::-1][:, :8]
assert np.array_equal(np.asarray(top), want)
print("row-0 top-8:", np.asarray(top)[0])
print("row-0 top-8 ids:", np.asarray(top_ids)[0])

# composite keys work too: sort rows by (group, priority) ascending
grp = rng.integers(0, 4, size=(64, 256)).astype(np.uint8)
pri = rng.integers(0, 1000, size=(64, 256)).astype(np.uint32)
(sg, sp), _ = rt.batched_sort((grp, pri))
packed = np.rec.fromarrays([grp, pri])
want = np.sort(packed, axis=-1)
assert np.array_equal(np.asarray(sg), want.f0)
assert np.array_equal(np.asarray(sp), want.f1)
print("composite rows ok")
