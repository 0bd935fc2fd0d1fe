"""Regression tests for the default JAX config (jax_enable_x64 OFF).

The main suite enables x64, which masks silent 64-bit truncation bugs
(found in review: table sort_by of u64 columns returned zeroed uint32;
sort_key_value with f64 payloads crashed or halved; joins dropped
matches). These run in a subprocess with the default config.
"""
import os
import subprocess
import sys
import textwrap

import pytest

SCRIPT = textwrap.dedent(
    """
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert not jax.config.jax_enable_x64
    import numpy as np
    import rdst_tpu as rt
    from rdst_tpu.table import Table
    rng = np.random.default_rng(0)

    # 1. u64 key column through table sort_by
    k = rng.integers(0, 2**64, 3000, dtype=np.uint64)
    t = Table({"k": k, "id": np.arange(3000, dtype=np.uint32)})
    s = t.sort_by("k")
    got = np.asarray(s["k"]).astype(np.uint64)
    assert got.dtype == np.uint64, got.dtype
    assert np.array_equal(got, np.sort(k)), "u64 sort_by truncated"

    # 2. f64 payload through sort_key_value
    keys = rng.integers(0, 1000, 2000).astype(np.uint32)
    vals = rng.standard_normal(2000)
    ks, vs = rt.sort_key_value(keys, vals, stable=True)
    order = np.argsort(keys, kind="stable")
    assert vs.dtype == np.float64
    assert np.array_equal(vs.view(np.uint64), vals[order].view(np.uint64)), \\
        "f64 payload corrupted"

    # 3. join on composite key with duplicated hi field
    left = Table({"a": np.zeros(6, np.uint32),
                  "b": np.array([1, 2, 3, 4, 5, 6], np.uint32),
                  "x": np.arange(6, dtype=np.uint32)})
    right = Table({"a": np.zeros(3, np.uint32),
                   "b": np.array([2, 4, 6], np.uint32),
                   "lab": np.array([20, 40, 60], np.uint32)})
    j, c = left.join(right, on=["a", "b"])
    assert int(c) == 3, f"join dropped matches: {int(c)}"
    assert sorted(np.asarray(j["lab"])[:3].tolist()) == [20, 40, 60]

    # 4. integer aggregate exact past 2**24
    n = 300_000
    g = np.zeros(n, np.uint8)
    v = np.full(n, 1000, np.uint32)  # true sum 3e8 > 2**24
    agg, ng = Table({"g": g, "v": v}).group_aggregate(
        "g", {"s": ("v", "sum")})
    s0 = int(np.asarray(agg["s"])[0])
    assert s0 == n * 1000, f"int sum inexact: {s0} != {n*1000}"

    # 5. bfloat16 keys
    import jax.numpy as jnp
    bf = jnp.asarray(rng.standard_normal(1000), dtype=jnp.bfloat16)
    out = rt.radix_sort_unstable(bf)
    outf = np.asarray(out.astype(jnp.float32))
    assert np.all(np.diff(outf) >= 0), "bf16 sort order wrong"

    # 6. row-batched sort/top_k of u64 keys (host denormalize path)
    w = rng.integers(0, 2**64, size=(16, 128), dtype=np.uint64)
    ks, _ = rt.batched_sort(w)
    assert np.asarray(ks).dtype == np.uint64
    assert np.array_equal(np.asarray(ks), np.sort(w, -1)), "rows u64 sort"
    tk, _ = rt.batched_top_k(w, 5, largest=True)
    assert np.array_equal(
        np.asarray(tk), np.sort(w, -1)[:, ::-1][:, :5]), "rows u64 top_k"

    print("NO-X64 ALL OK")
    """
)


def test_default_config_no_x64():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
        cwd=root,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO-X64 ALL OK" in r.stdout
