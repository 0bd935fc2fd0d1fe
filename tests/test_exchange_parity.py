"""Branch parity: the ragged_all_to_all exchange path vs the dense one.

The dense all_to_all is the default on every backend; ``use_ragged=True``
opts into the exact-size ragged exchange. XLA:CPU has no lowering for
ragged-all-to-all, so this suite runs the REAL ragged-branch code
(offset/size computation, ragged call arguments, segment validity mask)
on the 8-device CPU mesh by substituting ``jax.lax.ragged_all_to_all``
with a traceable emulation that implements the primitive's documented
semantics exactly:

    output[output_offsets[s->me] : +recv_sizes[s]] =
        sender_s.operand[input_offsets[me] : +send_sizes[me]]

Both branches must agree BITWISE on every plane and count.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rdst_tpu.parallel import make_mesh
from rdst_tpu.parallel.shuffle import distributed_sort, partition_exchange


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _emulated_ragged_all_to_all(
    operand, output, input_offsets, send_sizes, output_offsets, recv_sizes,
    *, axis_name,
):
    """Reference implementation of ragged_all_to_all semantics, built only
    from dense all_to_all + vector ops (traceable on any backend)."""
    D = send_sizes.shape[0]
    n_local = operand.shape[0]
    cap = output.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (D, cap), 1)
    # (D, cap) send matrix: row d = my left-aligned segment for device d
    idx = jnp.clip(input_offsets[:, None] + pos, 0, max(n_local - 1, 0))
    seg = jnp.where(pos < send_sizes[:, None], operand[idx], operand.dtype.type(0))
    recv = jax.lax.all_to_all(seg, axis_name, split_axis=0, concat_axis=0,
                              tiled=False)  # row s = segment from sender s
    # each sender's placement offset in MY buffer travels with the same
    # all_to_all pattern
    off_t = jax.lax.all_to_all(
        output_offsets.reshape(D, 1), axis_name, split_axis=0,
        concat_axis=0, tiled=False,
    ).reshape(D)
    sz_t = jax.lax.all_to_all(
        send_sizes.reshape(D, 1), axis_name, split_axis=0, concat_axis=0,
        tiled=False,
    ).reshape(D)
    out = output
    posc = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)
    for s in range(D):
        rel = posc - off_t[s]
        sel = (rel >= 0) & (rel < sz_t[s])
        val = jnp.take(recv[s], jnp.clip(rel, 0, cap - 1))
        out = jnp.where(sel, val, out)
    return out


@pytest.fixture()
def patched_ragged(monkeypatch):
    monkeypatch.setattr(
        jax.lax, "ragged_all_to_all", _emulated_ragged_all_to_all
    )


def _planes(rng, n, n_words=2, n_payloads=1):
    words = [
        jnp.asarray(rng.integers(0, 2**32, n, dtype=np.int64)
                    .astype(np.uint32))
        for _ in range(n_words)
    ]
    pay = [jnp.asarray(np.arange(n, dtype=np.uint32) + 7 * i)
           for i in range(n_payloads)]
    return words, pay


@pytest.mark.parametrize("split_uniform", [True, False])
@pytest.mark.parametrize("dist", ["uniform", "hotkey", "lowentropy"])
def test_ragged_vs_dense_exchange_parity(mesh, rng, patched_ragged,
                                         split_uniform, dist):
    n = 1 << 12
    words, pay = _planes(rng, n)
    if dist == "hotkey":
        hot0 = jnp.full((n // 2,), np.uint32(0xDEAD0000))
        hot1 = jnp.full((n // 2,), np.uint32(0xBEEF1111))
        words = [
            jnp.concatenate([hot0, words[0][n // 2 :]]),
            jnp.concatenate([hot1, words[1][n // 2 :]]),
        ]
    elif dist == "lowentropy":
        words = [w % np.uint32(13) for w in words]

    # the hot bucket can be device-atomic (split_uniform=False, or when
    # stray keys share its adaptive window bucket), putting n/2 rows on
    # one device: capacity must absorb it — buffer content in the
    # OVERFLOW regime is unspecified (the API layer raises), so parity
    # is only defined within capacity.
    cf = 6.0 if dist == "hotkey" else 3.0
    kw = dict(mesh=mesh, capacity_factor=cf, stable=True,
              split_uniform=split_uniform)
    w_r, p_r, c_r = distributed_sort(words, pay, use_ragged=True, **kw)
    w_d, p_d, c_d = distributed_sort(words, pay, use_ragged=False, **kw)
    np.testing.assert_array_equal(np.asarray(c_r), np.asarray(c_d))
    cnts = np.asarray(c_r)
    D = cnts.shape[0]
    cap = np.asarray(w_r[0]).shape[0] // D
    assert (cnts <= cap).all(), f"test config overflows: {cnts.max()} > {cap}"
    for a, b in zip(w_r + p_r, w_d + p_d):
        a2 = np.asarray(a).reshape(D, -1)
        b2 = np.asarray(b).reshape(D, -1)
        for d in range(D):  # compare valid slices (pad tails may differ)
            np.testing.assert_array_equal(a2[d, : cnts[d]], b2[d, : cnts[d]])


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dist", ["uniform", "hotkey"])
def test_overlapped_exchange_parity(mesh, rng, dist, stable):
    """The two-phase overlapped exchange (sender-half split + bitonic merge
    combine, SURVEY §7 step 6) is bitwise-identical to the sequential
    path in stable mode and key-identical in unstable mode."""
    n = 1 << 12
    words, pay = _planes(rng, n)
    if dist == "hotkey":
        words = [
            jnp.concatenate(
                [jnp.full((n // 2,), np.uint32(0xDEAD0000)),
                 words[0][n // 2:]]
            ),
            words[1],
        ]
    kw = dict(mesh=mesh, capacity_factor=6.0, stable=stable,
              use_ragged=False)
    w_s, p_s, c_s = distributed_sort(words, pay, **kw)
    w_o, p_o, c_o = distributed_sort(words, pay, overlap_exchange=True,
                                     **kw)
    np.testing.assert_array_equal(np.asarray(c_s), np.asarray(c_o))
    cnts = np.asarray(c_s)
    D = cnts.shape[0]
    planes_s = [np.asarray(a).reshape(D, -1) for a in w_s + p_s]
    planes_o = [np.asarray(a).reshape(D, -1) for a in w_o + p_o]
    for d in range(D):
        if stable:
            for a, b in zip(planes_s, planes_o):
                np.testing.assert_array_equal(a[d, : cnts[d]],
                                              b[d, : cnts[d]])
        else:
            # unstable: keys agree exactly, (key, payload) rows as multisets
            rows_s = sorted(map(tuple, np.stack(
                [a[d, : cnts[d]] for a in planes_s], 1).tolist()))
            rows_o = sorted(map(tuple, np.stack(
                [a[d, : cnts[d]] for a in planes_o], 1).tolist()))
            assert rows_s == rows_o
            for a, b in zip(planes_s[:2], planes_o[:2]):
                np.testing.assert_array_equal(a[d, : cnts[d]],
                                              b[d, : cnts[d]])


def test_ragged_vs_dense_partition_exchange(mesh, rng, patched_ragged):
    n = 1 << 12
    words, pay = _planes(rng, n, n_words=1)
    kw = dict(mesh=mesh, capacity_factor=3.0, stable=True)
    _, _, _, part = distributed_sort(
        words, pay, mesh=mesh, capacity_factor=3.0, stable=True,
        split_uniform=False, return_partition=True, use_ragged=False,
    )
    qwords, qpay = _planes(rng, n, n_words=1)
    w_r, p_r, c_r = partition_exchange(qwords, qpay, part, use_ragged=True,
                                       **kw)
    w_d, p_d, c_d = partition_exchange(qwords, qpay, part, use_ragged=False,
                                       **kw)
    np.testing.assert_array_equal(np.asarray(c_r), np.asarray(c_d))
    cnts = np.asarray(c_r)
    D = cnts.shape[0]
    for a, b in zip(w_r + p_r, w_d + p_d):
        a2 = np.asarray(a).reshape(D, -1)
        b2 = np.asarray(b).reshape(D, -1)
        for d in range(D):
            np.testing.assert_array_equal(a2[d, : cnts[d]], b2[d, : cnts[d]])


def test_default_exchange_by_platform():
    """The dense all_to_all is the default on every platform; the ragged
    exchange is opt-in."""
    import inspect

    for fn in (distributed_sort, partition_exchange):
        assert inspect.signature(fn).parameters["use_ragged"].default is False


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dist", ["uniform", "hotkey", "lowentropy"])
def test_default_exchange_matches_dense(mesh, rng, patched_ragged, dist,
                                        stable):
    """The opt-in ragged exchange equals the default dense one."""
    n = 1 << 12
    words, pay = _planes(rng, n)
    if dist == "hotkey":
        words = [
            jnp.concatenate([jnp.full((n // 2,), np.uint32(0xDEAD0000)),
                             words[0][n // 2:]]),
            words[1],
        ]
    elif dist == "lowentropy":
        words = [w % np.uint32(13) for w in words]
    kw = dict(mesh=mesh, capacity_factor=6.0, stable=stable)
    w_r, p_r, c_r = distributed_sort(words, pay, use_ragged=True, **kw)
    w_d, p_d, c_d = distributed_sort(words, pay, **kw)
    np.testing.assert_array_equal(np.asarray(c_r), np.asarray(c_d))
    cnts = np.asarray(c_r)
    D = cnts.shape[0]
    for a, b in zip(w_r + p_r, w_d + p_d):
        a2 = np.asarray(a).reshape(D, -1)
        b2 = np.asarray(b).reshape(D, -1)
        for d in range(D):
            if stable or a is not p_r[0]:
                np.testing.assert_array_equal(a2[d, : cnts[d]],
                                              b2[d, : cnts[d]])


def test_default_partition_exchange_matches_dense(mesh, rng, patched_ragged):
    n = 1 << 12
    words, pay = _planes(rng, n, n_words=1)
    _, _, _, part = distributed_sort(
        words, pay, mesh=mesh, capacity_factor=3.0, stable=True,
        split_uniform=False, return_partition=True,
    )
    qwords, qpay = _planes(rng, n, n_words=1)
    kw = dict(mesh=mesh, capacity_factor=3.0, stable=True)
    w_r, p_r, c_r = partition_exchange(qwords, qpay, part, use_ragged=True,
                                       **kw)
    w_d, p_d, c_d = partition_exchange(qwords, qpay, part, **kw)
    np.testing.assert_array_equal(np.asarray(c_r), np.asarray(c_d))
    cnts = np.asarray(c_r)
    D = cnts.shape[0]
    for a, b in zip(w_r + p_r, w_d + p_d):
        a2 = np.asarray(a).reshape(D, -1)
        b2 = np.asarray(b).reshape(D, -1)
        for d in range(D):
            np.testing.assert_array_equal(a2[d, : cnts[d]], b2[d, : cnts[d]])


def test_default_exchange_repeat_call_identical(mesh, rng, patched_ragged):
    """A second call on the same device arrays returns the same planes,
    pads included, and leaves the inputs as they were, with either
    exchange: the program holds no state between calls (chip_smoke.py
    --four-cards checks the second call of every case)."""
    n = 1 << 12
    words, pay = _planes(rng, n)
    before = [np.asarray(a).copy() for a in words + pay]
    for use_ragged in (False, True):
        kw = dict(mesh=mesh, capacity_factor=3.0, stable=True,
                  use_ragged=use_ragged)
        first = distributed_sort(words, pay, **kw)
        second = distributed_sort(words, pay, **kw)
        for a, b in zip(first[0] + first[1] + [first[2]],
                        second[0] + second[1] + [second[2]]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(words + pay, before):
            np.testing.assert_array_equal(np.asarray(a), b)
