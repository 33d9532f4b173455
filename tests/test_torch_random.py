"""The port's threefry generator is bit-exact with jax.random (jax with
jax_threefry_partitionable, the default), over seeds, shapes and per-lane
bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu_torch import random as jr

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 4649, 2**31 + 7]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    kt = jr.prng_key(torch.tensor(seed))
    _eq(k, kt)
    for n in (2, 3, 12):
        _eq(jax.random.split(k, n), jr.split(kt, n))
    for d in (0, 7, 4649):
        _eq(jax.random.fold_in(k, d), jr.fold_in(kt, d))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (7, 3), (96,)])
def test_uniform(seed, shape):
    k = jax.random.PRNGKey(seed)
    kt = jr.prng_key(torch.tensor(seed))
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(k, shape, dtype=jd)), jr.uniform(kt, shape, td).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_both_widths(seed):
    k = jax.random.PRNGKey(seed)
    kt = jr.prng_key(torch.tensor(seed))
    for maxval in (1, 2, 5, 12, 97):
        for shape in ((100, 2), (64, 3)):
            _eq(jax.random.randint(k, shape, 0, maxval), jr.randint(kt, shape, 0, maxval, bits=64))
            _eq(jax.random.randint(k, shape, 0, maxval, dtype=jnp.int32),
                jr.randint(kt, shape, 0, maxval, bits=32))


def test_randint_per_lane_maxval_under_vmap():
    seeds = np.arange(6, dtype=np.uint32) * 1000 + 3
    maxvals = np.array([0, 1, 3, 12, 96, 40])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    ref = jax.vmap(lambda kk, m: jax.random.randint(kk, (100, 2), 0, jnp.maximum(m, 1)))(
        keys, jnp.asarray(maxvals))
    kt = jr.prng_key(torch.as_tensor(seeds.astype(np.int64)))
    _eq(keys, kt)
    out = jr.randint(kt, (100, 2), 0, torch.clamp(torch.as_tensor(maxvals), min=1), bits=64)
    _eq(ref, out)


def test_lane_streams_match_vmapped_split_chain():
    """The VIO's key chain: split -> fold_in(seed) -> split, per lane."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4, dtype=jnp.uint32))

    def chain(k):
        rng, tkey = jax.random.split(k)
        tkey = jax.random.fold_in(tkey, 4649)
        _, r3 = jax.random.split(jax.random.split(tkey)[0])
        return rng, r3

    ref = jax.vmap(chain)(keys)
    kt = jr.prng_key(torch.arange(4))
    s = jr.split(kt)
    tkey = jr.fold_in(s[:, 1], 4649)
    r3 = jr.split(jr.split(tkey)[:, 0])[:, 1]
    _eq(ref[0], s[:, 0])
    _eq(ref[1], r3)
