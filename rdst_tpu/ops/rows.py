"""Row-batched sorting primitives: sort / top_k along the last axis.

The reference parallelizes recursion across independent sub-buckets
(reference: sorter.rs:121-139 — 256 sub-buckets dispatched to rayon via
``par_bridge``). The XLA analog of "many small independent sorts" is a
batched row sort along the last axis, and a row-wise ``lax.top_k`` where
only the first ``k`` are wanted. These entry points expose both on the
public surface for workloads that are already row-partitioned.

Keys go through the same normalization as every other path
(rdst_tpu.keys), so ordering semantics — signed bias, IEEE float total
order, composite lexicographic fields — are identical to the flat sorts
(reference: radix_key_impl.rs:87-185).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu import keys as _keys

__all__ = ["batched_sort", "batched_top_k"]

_SIGN = np.uint32(0x80000000)


def _normalize_rows(x, byte_keys: bool | None = None):
    """Normalize row-batched keys: flatten (transforms are elementwise),
    normalize 1-D, reshape the word planes back to the batch shape.

    ``byte_keys`` selects how uint8 inputs are read: ``True`` → the last
    axis is the bytes of one ``[u8; N]`` lexicographic key (rows run along
    axis -2); ``False`` → scalar u8 keys with rows along the last axis;
    ``None`` → infer ``True`` only for uint8 arrays with ndim >= 3 (the
    historical convention — ambiguous for batched scalar u8 keys with 2+
    leading batch dims, so pass the flag explicitly there).

    Returns ``(nk_with_batch_shaped_words, batch_shape)``.
    """
    # NOTE: inputs are NOT passed through jnp.asarray here — with x64
    # disabled that would silently truncate 64-bit keys to 32; normalize
    # splits numpy 64-bit inputs into words on the host instead
    # (keys._split_u64, tests/test_no_x64.py).
    if isinstance(x, (tuple, list)):
        shape = np.shape(x[0])
        nk = _keys.normalize(
            tuple(f.reshape(-1) for f in x), composite=True
        )
    else:
        is_u8 = np.dtype(x.dtype) == np.uint8
        if byte_keys and not is_u8:
            raise TypeError("byte_keys=True requires a uint8 array")
        if byte_keys is None:
            byte_keys = is_u8 and x.ndim >= 3
        if byte_keys:
            # [u8; N] byte-array keys: last axis is the key bytes
            shape = x.shape[:-1]
            nk = _keys.normalize(x.reshape(-1, x.shape[-1]))
        else:
            shape = x.shape
            nk = _keys.normalize(x.reshape(-1))
    nk = dataclasses.replace(
        nk, words=tuple(w.reshape(shape) for w in nk.words)
    )
    return nk, shape


def _denormalize_rows(nk: _keys.NormalizedKeys):
    """Invert :func:`_normalize_rows` for (possibly sliced) batch words.

    64-bit key dtypes with x64 off reconstruct on the host (numpy), same
    rule as the builder path (builder.py sort()): the device cannot
    represent uint64 there. Jit users needing 64-bit keys should enable
    x64 or stay in word planes (engine.sort_words).
    """
    from rdst_tpu.builder import _has_64bit_keys, _x64_enabled

    out_shape = nk.words[0].shape
    flat = dataclasses.replace(
        nk, words=tuple(w.reshape(-1) for w in nk.words)
    )
    if _has_64bit_keys(nk) and not _x64_enabled():
        res = _keys.denormalize_host(flat)
    else:
        res = _keys.denormalize(flat)
    if isinstance(res, tuple):
        return tuple(f.reshape(out_shape) for f in res)
    if nk.meta[0] == "bytes":
        return res.reshape(out_shape + (nk.meta[1],))
    return res.reshape(out_shape)


def _check_payload(p) -> jax.Array:
    """Payloads ride through the sort as-is; reject dtypes that
    ``jnp.asarray`` would silently narrow (64-bit values with x64 off)."""
    orig_dtype = np.asarray(p).dtype if not hasattr(p, "dtype") else p.dtype
    a = jnp.asarray(p)
    if np.dtype(a.dtype).itemsize < np.dtype(orig_dtype).itemsize:
        raise TypeError(
            f"payload dtype {orig_dtype} would be narrowed to {a.dtype} "
            "(jax_enable_x64 is off); split it into uint32 planes first"
        )
    return a


def batched_sort(
    x,
    payloads: Sequence[jax.Array] = (),
    *,
    stable: bool = False,
    descending: bool = False,
    byte_keys: bool | None = None,
):
    """Sort every row (last axis) of ``x`` independently.

    ``x``: array of any supported key dtype, or a tuple of arrays
    (composite key, most significant field first); all shapes
    ``(..., n)``. ``payloads``: arrays of shape ``(..., n)`` permuted
    alongside their row's keys.

    uint8 inputs are ambiguous: ``byte_keys=True`` reads the last axis as
    the N bytes of one ``[u8; N]`` lexicographic key (rows then run along
    axis -2, matching reference radix_key_impl.rs:78-85); ``byte_keys=
    False`` means scalar u8 keys. The default (``None``) infers ``True``
    for uint8 arrays with ndim >= 3 — pass the flag explicitly when
    batching scalar u8 keys with 2+ leading batch dims.

    Returns ``(sorted_keys, [sorted_payloads...])`` with ``sorted_keys``
    in the input's dtype (a tuple again for composite keys). Jittable.
    """
    nk, _ = _normalize_rows(x, byte_keys)
    words = list(nk.words)
    if descending:
        words = [~w for w in words]
    operands = tuple(words) + tuple(_check_payload(p) for p in payloads)
    out = jax.lax.sort(
        operands, dimension=-1, num_keys=len(words), is_stable=stable
    )
    sorted_words = list(out[: len(words)])
    if descending:
        sorted_words = [~w for w in sorted_words]
    sorted_nk = dataclasses.replace(nk, words=tuple(sorted_words))
    return _denormalize_rows(sorted_nk), list(out[len(words):])


def _as_i32_key(w: jax.Array, largest: bool) -> jax.Array:
    """Order-preserving uint32 -> int32 map (descending top_k order)."""
    if not largest:
        w = ~w
    return jax.lax.bitcast_convert_type(w ^ _SIGN, jnp.int32)


def _from_i32_key(v: jax.Array, largest: bool) -> jax.Array:
    w = jax.lax.bitcast_convert_type(v, jnp.uint32) ^ _SIGN
    return w if largest else ~w


def batched_top_k(
    x,
    k: int,
    payloads: Sequence[jax.Array] = (),
    *,
    largest: bool = True,
    byte_keys: bool | None = None,
):
    """Per-row top-``k`` by key order (``largest=False`` → bottom-k).

    Single-word keys (≤32-bit dtypes) use ``lax.top_k``; wider /
    composite keys fall back to a row sort + slice. Results are returned
    in sorted order (descending for ``largest=True``). ``byte_keys``
    disambiguates uint8 inputs exactly as in :func:`batched_sort`.

    Returns ``(top_keys, [top_payloads...])``, each shaped ``(..., k)``.
    """
    nk, _ = _normalize_rows(x, byte_keys)
    n = nk.words[0].shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for rows of {n}")
    if nk.n_words == 1:
        vals, idx = jax.lax.top_k(_as_i32_key(nk.words[0], largest), k)
        sorted_nk = dataclasses.replace(
            nk, words=(_from_i32_key(vals, largest),)
        )
        outs = [
            jnp.take_along_axis(
                _check_payload(p), idx.astype(jnp.int32), axis=-1
            )
            for p in payloads
        ]
        return _denormalize_rows(sorted_nk), outs
    sorted_keys, outs = batched_sort(
        x, payloads, descending=largest, byte_keys=byte_keys
    )
    if isinstance(sorted_keys, tuple):
        sorted_keys = tuple(f[..., :k] for f in sorted_keys)
    else:
        sorted_keys = sorted_keys[..., :k]
    return sorted_keys, [p[..., :k] for p in outs]
