"""The XLA counting path (the one device path) against the numpy host
counter: window pack + canonical form + sentinel, the per-chunk count,
the bounded run sums with their structurally derived max_run, and the
stream accumulator's overflow detection."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from km_tpu.ops import count as opcount
from km_tpu.ops import encode
from km_tpu.ops.count import (SENTINEL32, count_batches_host,
                              count_chunk_device, pack_keys_device)


def _keys_from_device(hi, lo, cnt):
    hi = np.asarray(hi).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint64)
    cnt = np.asarray(cnt).astype(np.int64)
    keep = cnt > 0
    return (hi[keep] << np.uint64(32)) | lo[keep], cnt[keep]


@pytest.mark.parametrize("k,canonical", [(31, True), (31, False),
                                         (16, True), (21, True)])
def test_xla_pack_matches_host_pack(k, canonical):
    rng = np.random.default_rng(3)
    n = 8192
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    valid = rng.random(n) > 0.02

    fn = jax.jit(pack_keys_device, static_argnames=("k", "canonical"))
    hi, lo = fn(jnp.asarray(codes), jnp.asarray(valid), k=k,
                canonical=canonical)
    got = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
           | np.asarray(lo).astype(np.uint64))

    want = encode.pack_code_windows(codes, k)
    if canonical:
        want = encode.canonical(want, k)
    sentinel = np.uint64((SENTINEL32 << 32) | SENTINEL32)
    want = np.where(opcount.window_valid(valid, k), want, sentinel)
    assert got.shape == (n - k + 1,)
    assert (got == want).all()


@pytest.mark.parametrize("n", [1 << 12, 5000])
@pytest.mark.parametrize("canonical", [True, False])
def test_count_chunk_matches_host(n, canonical):
    """One globally sorted run: every key once with its count, equal to
    host counting at power-of-two and ragged chunk lengths."""
    rng = np.random.default_rng(n)
    k = 21
    # reads off a short reference, so keys repeat
    ref = rng.integers(0, 4, 600, dtype=np.uint8)
    codes = np.resize(ref, n)
    valid = rng.random(n) > 0.03

    fn = jax.jit(count_chunk_device, static_argnames=("k", "canonical"))
    keys, cnt = _keys_from_device(*fn(jnp.asarray(codes), jnp.asarray(valid),
                                      k=k, canonical=canonical))
    hk, hc = count_batches_host([(codes, valid)], k, canonical=canonical)
    assert (keys == hk).all()  # sorted, each key once
    assert (cnt == hc.astype(np.int64)).all()


def test_stream_one_key_fills_every_chunk():
    """A chunk that is one repeated key, merged chunk after chunk: the
    run sum's bound (MERGE_MAX_RUN) must cover the chunk's single entry
    plus the accumulator's, whatever the key's count."""
    k = 31
    n = 1 << 12
    codes = np.zeros(3 * n, np.uint8)  # all 'A': one key, every window
    batches = [(codes, np.ones(3 * n, bool))]
    sk, sc = opcount.count_batches_device_stream(iter(batches), k,
                                                 chunk=n, capacity=64)
    hk, hc = count_batches_host(iter(batches), k)
    assert len(sk) == 1
    assert (sk == hk).all()
    assert (sc == hc).all()


def test_merge_accum_repeated_key_exact():
    """merge_accum_device at the default bound sums a key present in
    the accumulator and once in the chunk runs, and drops zero-count
    entries that carry the same key."""
    C = 8
    sent = np.uint32(SENTINEL32)
    acc_hi = jnp.asarray(np.array([0, 0] + [sent] * 6, np.uint32))
    acc_lo = jnp.asarray(np.array([5, 9] + [sent] * 6, np.uint32))
    acc_cnt = jnp.asarray(np.array([100, 7] + [0] * 6, np.int32))
    # chunk runs: key 5 once with its total, then zero-count copies
    rhi = jnp.zeros(6, jnp.uint32)
    rlo = jnp.asarray(np.array([5, 5, 5, 5, 3, 3], np.uint32))
    rcnt = jnp.asarray(np.array([4096, 0, 0, 0, 2, 0], np.int32))
    hi, lo, cnt, n_unique = jax.jit(
        opcount.merge_accum_device, static_argnames=("C",))(
        acc_hi, acc_lo, acc_cnt, rhi, rlo, rcnt, C=C)
    assert int(n_unique) == 3
    assert list(np.asarray(lo)[:3]) == [3, 5, 9]
    assert list(np.asarray(cnt)[:3]) == [2, 4196, 7]


def test_sharded_exchange_one_key_from_every_sender():
    """Every device's chunk is the same single key: the owner receives
    it once from each of the n_shards senders, and max_run = n_shards
    must sum all of them."""
    from km_tpu.parallel.sharded_table import make_mesh, sharded_count

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    k = 31
    chunk = 1 << 10
    # 8 chunks' worth of one repeated key: one chunk per device
    n = 8 * (chunk - k + 1) + k - 1
    batches = [(np.full(n, 2, np.uint8), np.ones(n, bool))]  # all 'G'
    sk, sc = sharded_count(iter(batches), make_mesh(8), k, chunk=chunk)
    hk, hc = count_batches_host(iter(batches), k)
    assert len(sk) == 1 and (sk == hk).all()
    assert int(sc[0]) == int(hc[0]) == n - k + 1


def test_stream_overflow_between_checks_raises():
    """An overflow in the first chunk, followed by chunks that fit the
    truncated accumulator again, must still raise: the check reads the
    running maximum of n_unique, not its latest value."""
    rng = np.random.default_rng(13)
    k = 21
    chunk = 1 << 11
    distinct = rng.integers(0, 4, 1500, dtype=np.uint8)  # ~1480 keys
    blank = np.zeros(40 * chunk, np.uint8)  # no valid window at all
    batches = [(distinct, np.ones(len(distinct), bool)),
               (blank, np.zeros(len(blank), bool))]
    with pytest.raises(opcount.CountCapacityOverflow):
        opcount.count_batches_device_stream(iter(batches), k, chunk=chunk,
                                            capacity=256)
    # with room, the same stream counts exactly
    sk, sc = opcount.count_batches_device_stream(iter(batches), k,
                                                 chunk=chunk, capacity=2048)
    hk, hc = count_batches_host(iter(batches), k)
    assert (sk == hk).all() and (sc == hc).all()
