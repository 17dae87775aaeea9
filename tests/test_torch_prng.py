"""The port's threefry PRNG against the installed jax.random."""
import jax
import numpy as np
import pytest

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
