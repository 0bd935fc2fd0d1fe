"""Key normalization: map every supported key dtype to sortable unsigned bit planes.

This is the equivalent of the reference's ``RadixKey`` trait
(reference: src/radix_key.rs:1-21, src/radix_key_impl.rs:1-185). Where the
reference extracts one byte at a time per element (``get_level``), we normalize
whole arrays ONCE into a list of uint32 "words" (most-significant word first)
such that ascending lexicographic order over the words equals the desired sort
order. Digit planes are then extracted with vectorized shift+mask inside
kernels.

Semantics matched exactly:
  * unsigned ints: identity bit pattern           (radix_key_impl.rs:3-46)
  * signed ints:   ``x ^ MIN`` sign-bias          (radix_key_impl.rs:87-130)
  * f32/f64:       IEEE total-order transform
                   ``s ^= ((s>>31 as u32)>>1); s ^ MIN``
                                                  (radix_key_impl.rs:162-185)
  * ``[u8; N]``:   lexicographic / big-endian: level ``l`` reads byte
                   ``N-1-l``                      (radix_key_impl.rs:78-85)
  * u128/i128:     two uint64-worth of planes (4 uint32 words)
                                                  (radix_key_impl.rs:39-46)
  * composite multi-field keys: concatenated byte planes, most-significant
    field first (generalizes examples/impl_radix_key.rs and the struct_sort
    bench's derived keys).

All arithmetic is uint32: every key wider than 4 bytes becomes multiple
uint32 words. The format was chosen for the TPU's 32-bit vector lanes,
which this engine first targeted; whether the GPU prefers packed 64-bit
keys is tracked in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "NormalizedKeys",
    "normalize",
    "denormalize",
    "denormalize_host",
    "num_levels",
    "digit_plane",
    "supported_dtypes",
]

_U32 = jnp.uint32
_MASK8 = np.uint32(0xFF)


def _bitcast(x, dtype, xp=None):
    """Exact bit reinterpretation. jnp's ``.view`` is NOT always exact
    (observed ulp-level corruption on uint64<->float64 on CPU backends), so
    jax arrays always go through lax.bitcast_convert_type."""
    if isinstance(x, np.ndarray):
        return x.view(dtype)
    return jax.lax.bitcast_convert_type(x, jnp.dtype(dtype))


@dataclasses.dataclass(frozen=True)
class NormalizedKeys:
    """A batch of keys normalized to ascending-unsigned uint32 word planes.

    ``words[0]`` is the most significant word. ``n_bytes`` is the number of
    significant bytes (the reference's ``RadixKey::LEVELS``,
    radix_key.rs:2): bytes are packed right-aligned, i.e. the LAST word holds
    byte-levels 0..3, the one before holds 4..7, etc. The most significant
    word may hold fewer than 4 significant bytes (its upper bytes are zero).

    ``meta`` records how to invert the transform (see :func:`denormalize`).
    """

    words: tuple[jax.Array, ...]
    n_bytes: int
    meta: tuple  # ("dtype", np.dtype) | ("bytes", N) | ("composite", metas)

    @property
    def shape(self):
        return self.words[0].shape

    @property
    def n_words(self) -> int:
        return len(self.words)

    def digit(self, level: int, bits: int = 8) -> jax.Array:
        """Extract the digit plane for byte ``level`` (0 = least significant).

        Equivalent of ``RadixKey::get_level(level)`` (radix_key.rs:2-4) but
        vectorized over the whole batch. ``bits`` may be 8 (one byte, the
        reference's radix) or 16 (two adjacent bytes fused — wider digits
        halve the number of passes; the byte pair never straddles a word
        boundary because words hold 4 bytes).
        """
        return digit_plane(self.words, level, bits)


def num_levels(x_or_dtype, *, width: int | None = None) -> int:
    """Number of byte levels for a key dtype (``RadixKey::LEVELS``)."""
    dt = np.dtype(x_or_dtype if not hasattr(x_or_dtype, "dtype") else x_or_dtype.dtype)
    if width is not None:
        return width
    return dt.itemsize


def digit_plane(words: Sequence[jax.Array], level: int, bits: int = 8) -> jax.Array:
    """Extract an 8- or 16-bit digit at byte ``level`` from uint32 words.

    Level 0 is the least significant byte of the last word.
    """
    n_words = len(words)
    widx = n_words - 1 - (level // 4)
    shift = np.uint32((level % 4) * 8)
    w = words[widx]
    if bits == 8:
        return jnp.right_shift(w, shift) & _MASK8
    if bits == 16:
        if level % 4 == 3:
            raise ValueError("16-bit digit must not straddle a word boundary")
        return jnp.right_shift(w, shift) & np.uint32(0xFFFF)
    raise ValueError(f"unsupported digit width {bits}")


# ---------------------------------------------------------------------------
# Per-dtype transforms
# ---------------------------------------------------------------------------


def _split_u64(u) -> tuple[jax.Array, jax.Array]:
    """Split a uint64 array into (hi, lo) uint32 words.

    64-bit numpy inputs are split on the host so the framework works without
    ``jax_enable_x64`` (64-bit keys only ever exist at the API boundary).
    """
    if isinstance(u, np.ndarray):
        hi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        return hi, lo
    hi = (u >> np.uint64(32)).astype(_U32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(_U32)
    return hi, lo


def _normalize_unsigned(x) -> tuple[tuple[jax.Array, ...], int]:
    nbytes = np.dtype(x.dtype).itemsize
    if nbytes <= 4:
        return (jnp.asarray(x).astype(_U32),), nbytes
    if isinstance(x, np.ndarray):
        return _split_u64(x.astype(np.uint64)), nbytes
    return _split_u64(x.astype(jnp.uint64)), nbytes


def _normalize_signed(x) -> tuple[tuple[jax.Array, ...], int]:
    # x ^ MIN == flip the sign bit == reinterpret-as-unsigned + 2^(B-1)
    # (radix_key_impl.rs:87-130).
    dt = np.dtype(x.dtype)
    u = _bitcast(x, f"uint{dt.itemsize * 8}")
    top = np.array(1 << (dt.itemsize * 8 - 1), dtype=u.dtype)
    return _normalize_unsigned(u ^ top)


def _float_fold(u: jax.Array, nbits: int) -> jax.Array:
    """IEEE total-order fold on the unsigned bit pattern.

    ``s ^= ((s >> (nbits-1)) as unsigned) >> 1; s ^= MIN``
    (radix_key_impl.rs:162-185). Negative floats get all bits flipped;
    positive floats get only the sign bit flipped. This is an involution up
    to the final sign-bit xor; see :func:`_float_unfold_xp`.
    """
    sign = u >> np.array(nbits - 1, dtype=u.dtype)  # 0 or 1
    # arithmetic-shift-all-ones emulation: 0 -> 0, 1 -> 0x7FF..F
    mask = sign * np.array((1 << (nbits - 1)) - 1, dtype=u.dtype)
    top = np.array(1 << (nbits - 1), dtype=u.dtype)
    return (u ^ mask) ^ top


def _normalize_float(x) -> tuple[tuple[jax.Array, ...], int]:
    dt = np.dtype(x.dtype) if x.dtype != jnp.bfloat16 else jnp.bfloat16
    if dt == np.float32:
        return (_float_fold(_bitcast(jnp.asarray(x), jnp.uint32), 32),), 4
    if dt == np.float64:
        if isinstance(x, np.ndarray):
            folded = _float_fold(x.view(np.uint64), 64)
        else:
            folded = _float_fold(_bitcast(x, jnp.uint64), 64)
        return _split_u64(folded), 8
    if dt == np.float16:
        return (_float_fold(_bitcast(jnp.asarray(x), jnp.uint16), 16).astype(_U32),), 2
    if dt == jnp.bfloat16:
        u16 = jax.lax.bitcast_convert_type(jnp.asarray(x), jnp.uint16)
        return (_float_fold(u16, 16).astype(_U32),), 2
    raise TypeError(f"unsupported float dtype {dt}")


def _normalize_byte_array(x: jax.Array) -> tuple[tuple[jax.Array, ...], int]:
    """(n, N) uint8 → lexicographic big-endian words (radix_key_impl.rs:78-85).

    Byte level ``l`` must read column ``N-1-l``; we pack columns into uint32
    words so that the LAST word's low byte is column N-1.
    """
    if x.ndim != 2 or x.dtype != jnp.uint8:
        raise TypeError("byte-array keys must be (n, N) uint8")
    n, nb = x.shape
    n_words = -(-nb // 4)
    pad = n_words * 4 - nb
    # zero-pad on the LEFT (most significant side keeps value semantics:
    # shorter arrays compare as if left-padded with 0, consistent with packing)
    xp = jnp.pad(x, ((0, 0), (pad, 0)))
    cols = xp.astype(_U32).reshape(n, n_words, 4)
    shifts = np.array([24, 16, 8, 0], dtype=np.uint32)
    words = jnp.sum(cols << shifts[None, None, :], axis=-1).astype(_U32)
    return tuple(words[:, i] for i in range(n_words)), nb


def supported_dtypes() -> tuple[np.dtype, ...]:
    return tuple(
        np.dtype(t)
        for t in (
            np.uint8, np.uint16, np.uint32, np.uint64,
            np.int8, np.int16, np.int32, np.int64,
            np.float16, np.float32, np.float64,
        )
    )


def normalize(x: jax.Array, *, composite: bool = False) -> NormalizedKeys:
    """Normalize a key array (or sequence of key arrays) to word planes.

    For a sequence, fields are significant most-first (composite key — the
    struct_sort / impl_radix_key pattern) and each field's planes are
    repacked tightly so the composite occupies ``ceil(sum_bytes/4)`` words.
    """
    if composite or isinstance(x, (list, tuple)):
        return _normalize_composite(tuple(x))
    dt = np.dtype(x.dtype)
    if x.ndim == 2 and dt == np.uint8:
        words, nb = _normalize_byte_array(x)
        return NormalizedKeys(words, nb, ("bytes", x.shape[1]))
    if x.ndim != 1:
        raise ValueError("keys must be 1-D (or (n,N) uint8 byte-array keys)")
    if dt.kind == "u":
        words, nb = _normalize_unsigned(x)
    elif dt.kind == "i":
        words, nb = _normalize_signed(x)
    elif dt.kind == "f" or dt == jnp.bfloat16:
        words, nb = _normalize_float(x)
    else:
        raise TypeError(f"unsupported key dtype {dt}")
    return NormalizedKeys(words, nb, ("dtype", dt))


def _normalize_composite(fields: tuple) -> NormalizedKeys:
    parts = [normalize(f) for f in fields]
    total_bytes = sum(p.n_bytes for p in parts)
    n_words = -(-total_bytes // 4)
    n = parts[0].shape[0]
    words = [jnp.zeros((n,), _U32) for _ in range(n_words)]
    # Assemble byte-by-byte: composite level counts down from the most
    # significant byte of the first field.
    level = total_bytes  # one past the top
    for p in parts:
        for b in reversed(range(p.n_bytes)):  # field's own MSB first
            level -= 1
            byte = digit_plane(p.words, b, 8)
            widx = n_words - 1 - (level // 4)
            shift = np.uint32((level % 4) * 8)
            words[widx] = words[widx] | (byte << shift)
    metas = tuple((pp.meta, pp.n_bytes) for pp in parts)
    return NormalizedKeys(tuple(words), total_bytes, ("composite", metas))


# ---------------------------------------------------------------------------
# Inverse transforms
# ---------------------------------------------------------------------------


def _join_u64(hi, lo, xp):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _digit_plane_xp(words, level: int, xp):
    n_words = len(words)
    widx = n_words - 1 - (level // 4)
    shift = np.uint32((level % 4) * 8)
    return (words[widx] >> shift) & _MASK8


def _float_unfold_xp(t, nbits: int, xp):
    top = np.array(1 << (nbits - 1), dtype=t.dtype)
    was_negative = (t >> np.array(nbits - 1, dtype=t.dtype)) == 0
    mask = xp.where(
        was_negative,
        np.array((1 << nbits) - 1, dtype=t.dtype),
        top,
    )
    return t ^ mask


def denormalize(nk: NormalizedKeys) -> jax.Array | tuple:
    """Invert :func:`normalize` on device (requires x64 for 64-bit keys)."""
    return _denormalize_impl(nk.words, nk.n_bytes, nk.meta, jnp)


def denormalize_host(nk: NormalizedKeys):
    """Invert :func:`normalize` on host with numpy — works for 64-bit key
    dtypes even when jax_enable_x64 is off."""
    words = tuple(np.asarray(w) for w in nk.words)
    return _denormalize_impl(words, nk.n_bytes, nk.meta, np)


def _denormalize_impl(words, n_bytes: int, meta: tuple, xp):
    kind, info = meta
    stack = jnp.stack if xp is jnp else np.stack
    if kind == "bytes":
        nb = info
        out = []
        for lvl in reversed(range(nb)):  # most significant byte = column 0
            out.append(_digit_plane_xp(words, lvl, xp).astype(np.uint8))
        return stack(out, axis=1)
    if kind == "composite":
        metas = info
        fields = []
        level = n_bytes
        zeros = jnp.zeros if xp is jnp else np.zeros
        for sub_meta, nb in metas:
            level -= nb
            # extract this field's words (right-aligned within nb bytes)
            fw = []
            for w in range(-(-nb // 4)):
                lo_level = level + w * 4
                word = zeros(words[0].shape, _U32 if xp is jnp else np.uint32)
                for b in range(min(4, nb - w * 4)):
                    word = word | (
                        _digit_plane_xp(words, lo_level + b, xp)
                        << np.uint32(b * 8)
                    )
                fw.append(word)
            fw.reverse()  # most significant first
            fields.append(_denormalize_impl(tuple(fw), nb, sub_meta, xp))
        return tuple(fields)
    dt: np.dtype = info
    if dt.kind == "u":
        if dt.itemsize <= 4:
            return words[0].astype(f"uint{dt.itemsize * 8}")
        return _join_u64(words[0], words[1], xp)
    if dt.kind == "i":
        bits = dt.itemsize * 8
        if dt.itemsize <= 4:
            u = words[0].astype(f"uint{bits}")
        else:
            u = _join_u64(words[0], words[1], xp)
        top = np.array(1 << (bits - 1), dtype=u.dtype)
        return _bitcast(u ^ top, dt.name)
    if dt == np.float32:
        return _bitcast(_float_unfold_xp(words[0], 32, xp), np.float32)
    if dt == np.float64:
        u = _join_u64(words[0], words[1], xp)
        return _bitcast(_float_unfold_xp(u, 64, xp), np.float64)
    if dt == np.float16:
        return _bitcast(
            _float_unfold_xp(words[0].astype(np.uint16), 16, xp), np.float16
        )
    if dt == jnp.bfloat16:
        return _bitcast(
            _float_unfold_xp(words[0].astype(np.uint16), 16, xp),
            jnp.bfloat16,
        )
    raise TypeError(f"cannot denormalize {dt}")
