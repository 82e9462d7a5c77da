"""lightgbm_tpu_torch/utils/threefry.py against ``jax.random`` itself, bit
for bit: ``PRNGKey``, ``fold_in``, 32-bit ``bits`` and float32
``uniform`` under the partitionable threefry scheme this JAX uses by
default (the scheme the JAX package's sampling draws with)."""
import jax
import numpy as np
import pytest

from lightgbm_tpu_torch.utils import threefry

SEEDS = (0, 1, 3, 2 ** 31 - 1)
DRAWS = range(6)
SHAPES = (1, 7, 1000, 2 ** 20 + 3)


def test_partitionable_scheme_is_on():
    """The port copies the partitionable scheme; the JAX it is held
    against must draw with it."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("draw", DRAWS)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_matches_jax_random(seed, draw, n):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    assert tuple(int(v) for v in np.asarray(key)) == tkey
    key = jax.random.fold_in(key, draw)
    tkey = threefry.fold_in(tkey, draw)
    assert tuple(int(v) for v in np.asarray(key)) == tkey
    bits = np.asarray(jax.random.bits(key, (n,)))
    np.testing.assert_array_equal(
        threefry.random_bits(tkey, n).numpy().astype(np.uint32), bits)
    u = np.asarray(jax.random.uniform(key, (n,)))
    tu = threefry.uniform(tkey, n).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(tu.view(np.uint32), u.view(np.uint32))
