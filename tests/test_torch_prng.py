"""The port's threefry PRNG against the installed jax.random."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_key_and_split_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), prng.PRNGKey(seed))
    for num in (2, 4, 10):
        np.testing.assert_array_equal(np.asarray(jax.random.split(key, num)),
                                      prng.split(prng.PRNGKey(seed), num))
    # the trainer's chain: key, sub = split(key); keys = split(sub, M)
    jk, pk = key, prng.PRNGKey(seed)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        pk, psub = prng.split(pk)
        np.testing.assert_array_equal(np.asarray(jax.random.split(jsub, 4)),
                                      prng.split(psub, 4))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("k", [8, 33, 35])
def test_permutation_bit_equal(seed, k):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.permutation(key, k)),
        prng.permutation(prng.PRNGKey(seed), k))


@pytest.mark.parametrize("seed", [0, 9])
def test_uniform_bit_equal_and_normal_close(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(key, (64, 33))),
        prng.uniform(prng.PRNGKey(seed), (64, 33)))
    # normal goes through erf_inv: the same polynomial, but log1p may differ
    # by an ulp between XLA and numpy
    ref = np.asarray(jax.random.normal(key, (5, 5, 8, 16)))
    out = prng.normal(prng.PRNGKey(seed), (5, 5, 8, 16))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


IDS = np.concatenate([np.arange(300), [1000, 4095, 65536, 2**31 - 1]])


def test_fold_in_and_bernoulli_bit_equal():
    key = jax.random.PRNGKey(5)
    ids = jnp.asarray(IDS, jnp.uint32)
    ref = np.asarray(jax.vmap(lambda i: jax.random.fold_in(key, i))(ids))
    out = prng.fold_in(prng.PRNGKey(5), IDS)
    np.testing.assert_array_equal(out, ref)
    # a key batch folded again, as the corruption schedule chains them
    np.testing.assert_array_equal(
        prng.fold_in(out, 17),
        np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 17))(ref)))
    for p in (0.2, 0.5, 0.97):
        ref = np.asarray(jax.vmap(lambda i: jax.random.bernoulli(
            jax.random.fold_in(key, i), p))(ids))
        np.testing.assert_array_equal(
            prng.bernoulli(prng.fold_in(prng.PRNGKey(5), IDS), p), ref)
    np.testing.assert_array_equal(
        prng.bernoulli(prng.PRNGKey(5), 0.4, (7, 9)),
        np.asarray(jax.random.bernoulli(key, 0.4, (7, 9))))


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 2), (0, 3), (0, 5), (-4, 9),
                                   (0, 100_003), (0, 2**31 - 1), (3, 3)])
def test_randint_bit_equal(lo, hi):
    key = jax.random.PRNGKey(2)
    ids = jnp.asarray(IDS, jnp.uint32)
    ref = np.asarray(jax.vmap(lambda i: jax.random.randint(
        jax.random.fold_in(key, i), (), lo, hi))(ids))
    out = prng.randint(prng.fold_in(prng.PRNGKey(2), IDS), (), lo, hi)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        prng.randint(prng.PRNGKey(2), (4, 6), lo, hi),
        np.asarray(jax.random.randint(key, (4, 6), lo, hi)))


@pytest.mark.parametrize("shape", [(), (1,), (5, 5, 1, 3), (70_001,)])
def test_tensor_threefry_and_normal_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    pk = prng.fold_in(prng.PRNGKey(3), 11)
    n = int(np.prod(shape))
    b1, b2 = prng.threefry2x32_t(pk, 0, torch.arange(n, dtype=torch.int64))
    np.testing.assert_array_equal((b1 ^ b2).numpy().astype(np.uint32),
                                  prng.random_bits(pk, (n,)))
    np.testing.assert_array_equal(
        prng.random_bits_t(pk, shape, "cpu").numpy().astype(np.uint32),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    u = prng.uniform_t(pk, shape, "cpu")
    assert u.dtype == torch.float32 and tuple(u.shape) == shape
    np.testing.assert_array_equal(u.numpy(),
                                  np.asarray(jax.random.uniform(key, shape)))
    # other ranges: the host form's two roundings (XLA:CPU fuses them)
    np.testing.assert_array_equal(
        prng.uniform_t(pk, shape, "cpu", -2.5, 3.0).numpy(),
        prng.uniform(pk, shape, -2.5, 3.0))
    out = prng.normal_t(pk, shape, "cpu")
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    ref = np.asarray(jax.random.normal(key, shape))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.numpy(), prng.normal(pk, shape))


def test_tensor_draws_take_a_batch_of_keys():
    keys = prng.fold_in(prng.PRNGKey(4), np.arange(3))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(4), i))(
        jnp.arange(3))
    bits = prng.random_bits_t(keys, (5, 7), "cpu")
    assert tuple(bits.shape) == (3, 5, 7)
    np.testing.assert_array_equal(
        bits.numpy().astype(np.uint32),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5, 7)))(jkeys)))
    np.testing.assert_array_equal(
        prng.normal_t(keys, (5, 7), "cpu").numpy(),
        np.stack([prng.normal(k, (5, 7)) for k in keys]))
    segs = prng.normal_segments_t(
        prng.fold_in(keys[:, None], np.arange(4)), [3, 1, 40, 7], "cpu")
    assert tuple(segs.shape) == (3, 51)
    np.testing.assert_array_equal(segs.numpy(), np.stack([np.concatenate(
        [prng.normal(prng.fold_in(k, s), (n,))
         for s, n in enumerate([3, 1, 40, 7])]) for k in keys]))
