"""The port draws the JAX package's random streams bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.ops import rng as jrng
from kdtreepathtraceroptimization_tpu_torch.ops import rng as trng

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _key_words(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)).reshape(-1))


@pytest.mark.parametrize("seed", SEEDS)
def test_bounce_key_matches_jax(seed):
    base_j = jax.random.PRNGKey(seed)
    base_t = trng.prng_key(seed)
    assert base_t == _key_words(base_j)
    for iteration in (0, 1, 2, 100, 65535):
        for depth in range(9):
            want = _key_words(jrng.bounce_key(base_j, iteration, depth))
            assert trng.bounce_key(base_t, iteration, depth) == want, (
                seed, iteration, depth)


@pytest.mark.parametrize("seed, iteration, depth", [
    (0, 1, 0), (0, 1, 3), (12345, 7, 8), (2**31 - 1, 65535, 1)])
def test_uniform_cols_match_jax(seed, iteration, depth):
    kj = jrng.bounce_key(jax.random.PRNGKey(seed), iteration, depth)
    kt = trng.bounce_key(trng.prng_key(seed), iteration, depth)
    n = 4096
    rng = np.random.default_rng(seed % 1000)
    # position lanes, a permutation of pixel ids, and lanes near 2**31
    lanes = [None,
             rng.permutation(n).astype(np.int32),
             (2**31 - 1 - rng.integers(0, 1 << 20, n)).astype(np.int32)]
    for lane in lanes:
        cj = jrng.uniform_cols(kj, n, 8,
                               lane=None if lane is None else jnp.asarray(lane))
        ct = trng.uniform_cols(kt, n, 8,
                               lane=None if lane is None else torch.from_numpy(lane),
                               device="cpu")
        for a, b in zip(cj, ct):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    block_j = jrng.uniforms(kj, n, 5)
    block_t = trng.uniforms(kt, n, 5, device="cpu")
    np.testing.assert_array_equal(np.asarray(block_j), block_t.numpy())
