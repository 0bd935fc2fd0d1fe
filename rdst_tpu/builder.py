"""Public sorting API: functional equivalents of the reference's surface.

Reference surface (src/radix_sort.rs:4-19, src/radix_sort_builder.rs:53-157):

    vec.radix_sort_unstable()
    vec.radix_sort_builder().with_parallel(false).with_tuner(&t).sort()

JAX is functional, so sorts return new arrays instead of mutating:

    y = rdst_tpu.radix_sort_unstable(x)
    y = rdst_tpu.radix_sort_builder(x).with_low_mem_tuner().sort()
    keys, vals = rdst_tpu.sort_key_value(k, v, stable=True)
    idx = rdst_tpu.argsort(x)

Accepts numpy or jax arrays; returns the same family. 64-bit key dtypes work
without ``jax_enable_x64`` for numpy inputs (split/joined on host).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rdst_tpu import keys as _keys
from rdst_tpu.sorter import Sorter
from rdst_tpu.tuner import (
    Algorithm,
    LowMemoryTuner,
    SingleThreadedTuner,
    SingleAlgoTuner,
    StandardTuner,
    Tuner,
)

__all__ = [
    "RadixSortBuilder",
    "radix_sort_unstable",
    "radix_sort_builder",
    "sort_key_value",
    "argsort",
]


def _x64_enabled() -> bool:
    return jax.config.jax_enable_x64


class RadixSortBuilder:
    """Fluent sort configuration (reference: radix_sort_builder.rs:13-157).

    The reference asserts ``LEVELS != 0`` at construction
    (radix_sort_builder.rs:24-28); normalization enforces the same (every
    supported dtype has >= 1 byte level, and composite keys sum their
    fields').
    """

    def __init__(self, data, payloads: Sequence = ()):
        self._data = data
        self._payloads = list(payloads)
        self._parallel = True
        self._tuner: Tuner = StandardTuner()
        self._stable = False

    # -- reference builder surface (radix_sort_builder.rs:53-132) --

    def with_parallel(self, parallel: bool) -> "RadixSortBuilder":
        """Single-program mode: plans run as one sequential grid program
        (the reference drops to the no-rayon code path,
        radix_sort_builder.rs:53-57)."""
        self._parallel = parallel
        return self

    def with_low_mem_tuner(self) -> "RadixSortBuilder":
        self._tuner = LowMemoryTuner()
        return self

    def with_single_threaded_tuner(self) -> "RadixSortBuilder":
        self._tuner = SingleThreadedTuner()
        return self

    def with_tuner(self, tuner: Tuner) -> "RadixSortBuilder":
        self._tuner = tuner
        return self

    # -- extensions beyond the reference builder --

    def with_stable(self, stable: bool = True) -> "RadixSortBuilder":
        """Stable ordering (the reference's LSB family is stable,
        lib.rs docs; stability only matters with payloads)."""
        self._stable = stable
        return self

    def with_algorithm(self, algorithm: Algorithm) -> "RadixSortBuilder":
        """Pin one algorithm (SingleAlgoTuner, test_utils.rs:40-49)."""
        self._tuner = SingleAlgoTuner(algorithm)
        return self

    # -- execution --

    def _try_host_sort(self, n: int):
        """Host-native fast path for small numpy inputs.

        Small host-resident sorts otherwise pay a device dispatch round
        trip; the C++ runtime (native/rdst_host.cpp — the reference's
        mt_lsb private-range scatter in std::thread form) sorts them
        directly, with the same normalization semantics. Only the
        built-in tuners route here (forcing an Algorithm or a custom
        tuner is a request for the device plans). Returns the result or
        None to continue on the device path.
        """
        from rdst_tpu import config
        from rdst_tpu.native import host as _host

        if n > config.host_sort_max or config.host_sort_max <= 0:
            return None
        if type(self._tuner) not in (
            StandardTuner, LowMemoryTuner, SingleThreadedTuner
        ):
            return None
        data = self._data
        if not isinstance(data, np.ndarray) or data.ndim != 1:
            return None
        dt = np.dtype(data.dtype)
        if dt.kind not in "uif" or dt.itemsize > 8:
            return None
        if not all(
            isinstance(p, np.ndarray) and p.ndim == 1
            and np.dtype(p.dtype).itemsize <= 4
            for p in self._payloads
        ):
            return None

        # normalize to an ascending-unsigned u32/u64 key (host numpy)
        if dt.kind == "u":
            u = data.astype(np.uint64 if dt.itemsize == 8 else np.uint32)
        elif dt.kind == "i":
            b = data.view(f"uint{dt.itemsize * 8}")
            u = (b ^ np.array(1 << (dt.itemsize * 8 - 1), b.dtype)).astype(
                np.uint64 if dt.itemsize == 8 else np.uint32
            )
        else:  # floats: IEEE total-order fold (radix_key_impl.rs:162-185)
            bits = dt.itemsize * 8
            u = _keys._float_fold(data.view(f"uint{bits}"), bits)
            if dt.itemsize < 4:
                u = u.astype(np.uint32)

        u = u.copy()  # host sort is in place; never mutate user arrays
        if len(self._payloads) == 1 and (
            np.dtype(self._payloads[0].dtype).itemsize == 4
        ):
            pw = self._payloads[0].view(np.uint32).copy()
            _host.host_radix_sort(u, pw)
            out_payloads = (pw.view(self._payloads[0].dtype),)
        elif self._payloads:
            order = np.arange(n, dtype=np.uint32)
            _host.host_radix_sort(u, order)
            out_payloads = tuple(p[order] for p in self._payloads)
        else:
            _host.host_radix_sort(u)
            out_payloads = ()

        # invert the normalization
        if dt.kind == "u":
            keys_out = u.astype(dt)
        elif dt.kind == "i":
            w = u.astype(f"uint{dt.itemsize * 8}")
            keys_out = (
                w ^ np.array(1 << (dt.itemsize * 8 - 1), w.dtype)
            ).view(dt)
        else:
            bits = dt.itemsize * 8
            w = u.astype(f"uint{bits}") if dt.itemsize < 4 else u
            keys_out = _keys._float_unfold_xp(w, bits, np).view(dt)
        if self._payloads:
            return keys_out, out_payloads
        return keys_out

    def sort(self):
        """Run the sort; returns sorted keys (and payloads if provided)."""
        data = self._data
        want_numpy = isinstance(data, np.ndarray) or (
            isinstance(data, (list, tuple))
            and any(isinstance(f, np.ndarray) for f in data)
        )
        n = _length_of(data)
        if n <= 1:
            # early-out (radix_sort_builder.rs:150-152)
            if self._payloads:
                return data, tuple(self._payloads)
            return data

        host = self._try_host_sort(n)
        if host is not None:
            return host

        nk = _keys.normalize(data)
        payload_info = [
            _encode_payload(p, allow_narrow=True) for p in self._payloads
        ]
        payload_words = [w for info in payload_info for w in info[0]]

        sorter = Sorter(parallel=self._parallel, tuner=self._tuner)
        out_nk, out_payload_words = sorter.run(
            nk, payload_words, stable=self._stable
        )

        is_64 = _has_64bit_keys(nk)
        if want_numpy or (is_64 and not _x64_enabled()):
            sorted_keys = _keys.denormalize_host(out_nk)
            if want_numpy:
                sorted_keys = _to_numpy(sorted_keys)
        else:
            sorted_keys = _keys.denormalize(out_nk)

        if not self._payloads:
            return sorted_keys
        out_payloads = []
        i = 0
        for (words, decode) in payload_info:
            k = len(words)
            out_payloads.append(decode(out_payload_words[i : i + k]))
            i += k
        if want_numpy:
            out_payloads = [_to_numpy(p) for p in out_payloads]
        return sorted_keys, tuple(out_payloads)


def _length_of(data) -> int:
    if isinstance(data, (list, tuple)):
        return int(data[0].shape[0])
    return int(data.shape[0])


def _has_64bit_keys(nk: _keys.NormalizedKeys) -> bool:
    kind, info = nk.meta
    if kind == "dtype":
        return np.dtype(info).itemsize > 4
    if kind == "composite":
        return any(
            m[0] == "dtype" and np.dtype(m[1]).itemsize > 4 for m, _ in info
        )
    return False


def _to_numpy(x):
    if isinstance(x, tuple):
        return tuple(_to_numpy(v) for v in x)
    return np.asarray(x)


def _encode_payload(p, *, allow_narrow: bool = False):
    """Encode a payload array as uint32 word planes + decoder.

    Payloads ride through radix scatters as opaque words (the reference
    moves whole structs; SortValue is Copy, sort_value.rs:5-13).

    ``allow_narrow=True`` keeps <=16-bit payloads as uint16 operands, so
    the sort moves half the bytes for them. Only the single-device sort
    path opts in; the distributed exchange assumes uint32 planes (its pad
    word is 0xFFFFFFFF).
    """
    dt = np.dtype(p.dtype) if not isinstance(p, (list, tuple)) else None
    if dt is None:
        raise TypeError("payload must be a single array")
    if dt == np.bool_:
        w = jnp.asarray(p).astype(jnp.uint32)

        def decode_bool(ws):
            return ws[0] != 0

        return (w,), decode_bool
    if dt.itemsize == 8:
        if isinstance(p, np.ndarray):
            u = p.view(np.uint64)
            hi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
            lo = jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        else:
            u = jax.lax.bitcast_convert_type(p, jnp.uint64)
            hi = (u >> np.uint64(32)).astype(jnp.uint32)
            lo = (u & np.uint64(0xFFFFFFFF)).astype(jnp.uint32)

        def decode64(ws, dt=dt):
            # without x64, jnp astype(uint64) silently truncates to uint32 —
            # the hi/lo join must happen on the host then
            if _x64_enabled() and not isinstance(ws[0], np.ndarray):
                u = (ws[0].astype(jnp.uint64) << np.uint64(32)) | ws[
                    1
                ].astype(jnp.uint64)
                return jax.lax.bitcast_convert_type(u, np.dtype(dt.name))
            hi = np.asarray(ws[0]).astype(np.uint64)
            lo = np.asarray(ws[1]).astype(np.uint64)
            return ((hi << np.uint64(32)) | lo).view(dt.name)

        return (hi, lo), decode64
    if dt.itemsize <= 4:
        up = f"uint{dt.itemsize * 8}"
        ride = "uint16" if (allow_narrow and dt.itemsize <= 2) else "uint32"
        w = jax.lax.bitcast_convert_type(
            jnp.asarray(p), np.dtype(up)
        ).astype(np.dtype(ride))

        def decode32(ws, dt=dt, up=up):
            w = ws[0].astype(up)
            if isinstance(w, np.ndarray):
                return w.view(dt.name)
            return jax.lax.bitcast_convert_type(w, np.dtype(dt.name))

        return (w,), decode32
    raise TypeError(f"unsupported payload dtype {dt}")


# ---------------------------------------------------------------------------
# module-level convenience API
# ---------------------------------------------------------------------------


def radix_sort_unstable(data):
    """Sorted copy with the default (Standard) tuner — the reference's
    ``vec.radix_sort_unstable()`` (radix_sort.rs:25-27)."""
    return RadixSortBuilder(data).sort()


def radix_sort_builder(data, payloads: Sequence = ()) -> RadixSortBuilder:
    """Builder entry — the reference's ``vec.radix_sort_builder()``
    (radix_sort.rs:29-45)."""
    return RadixSortBuilder(data, payloads)


def sort_key_value(keys_arr, values, *, stable: bool = False):
    """Sort (key, value) pairs. ``values`` may be one array or a sequence."""
    multi = isinstance(values, (list, tuple))
    vals = list(values) if multi else [values]
    k, vs = RadixSortBuilder(keys_arr, vals).with_stable(stable).sort()
    return (k, vs) if multi else (k, vs[0])


def argsort(keys_arr, *, stable: bool = True):
    """Indices that sort ``keys_arr`` (stable by default).

    Stable mode sorts UNSTABLY on the composite (key, iota): the iota
    field makes the order strict, so the unique result IS the stable
    permutation and the iota comes back as the answer.  The sort needs
    no stability guarantee, so stable argsort rides the cheapest
    encoding of itself.
    """
    n = _length_of(keys_arr)
    fields = (
        list(keys_arr) if isinstance(keys_arr, (list, tuple))
        else [keys_arr]
    )
    use_np = any(isinstance(f, np.ndarray) for f in fields)
    idx = (
        np.arange(n, dtype=np.uint32) if use_np
        else jnp.arange(n, dtype=jnp.uint32)
    )
    if not stable:
        _, out = sort_key_value(keys_arr, idx, stable=False)
        return out
    if len(fields) == 1 and isinstance(fields[0], np.ndarray):
        # small single-key numpy inputs keep the host-native fast path
        # (the host LSD radix is stable, so key + iota payload IS the
        # stable permutation — no composite wrapping that would bail it)
        host = RadixSortBuilder(fields[0], [idx])._try_host_sort(n)
        if host is not None:
            return host[1][0]
    out = RadixSortBuilder(tuple(fields + [idx])).sort()
    return out[-1]
