"""Port parity: the per-row KV-cache write against the JAX model's scatter.

``models/transformer.py`` writes row b's T new entries at [write_pos[b],
+T) with ``c.at[rows, positions].set(new, mode="drop")`` in the JAX
package: an index in [-Smax, -1] wraps to Smax + i, one at or past Smax or
below -Smax is dropped. The port's ``_cache_writer`` must leave the same
cache for any ``write_pos``, with one gather and one scatter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import transformer as ttfm

SMAX = 16
# each row's write position: at and past the end, twice the length, the
# wrap range's edges, below it, and rows mixed with in-range ones
WRITE_POS = {"smax": [SMAX] * 3, "smax_plus_1": [SMAX + 1] * 3, "two_smax": [2 * SMAX] * 3,
             "minus_1": [-1] * 3, "below_wrap": "below", "mixed": "mixed"}


def _positions(name, T):
    p = WRITE_POS[name]
    if p == "below":
        return [-SMAX - T - 1] * 3
    if p == "mixed":
        return [SMAX - 2, -SMAX - 2, 3]  # the end, straddling -Smax, in range
    return p


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("name", list(WRITE_POS))
def test_cache_write_matches_the_jax_scatter(name, T):
    wp = np.asarray(_positions(name, T), np.int32)
    B, H, D = len(wp), 2, 3
    rng = np.random.default_rng(T)
    cache = rng.standard_normal((B, SMAX, H, D)).astype(np.float32)
    new = rng.standard_normal((B, T, H, D)).astype(np.float32)
    rows = jnp.arange(B)[:, None]
    ref = jnp.asarray(cache).at[rows, jnp.asarray(wp)[:, None] + jnp.arange(T)[None, :]].set(
        jnp.asarray(new), mode="drop")
    got = torch.from_numpy(cache.copy())
    write = ttfm._cache_writer(torch.zeros(B, dtype=torch.int32), torch.from_numpy(wp), B, T, SMAX, "cpu")
    write(got, torch.from_numpy(new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cache_write_rejects_a_block_longer_than_the_cache():
    with pytest.raises(ValueError):
        ttfm._cache_writer(torch.zeros(2, dtype=torch.int32), None, 2, SMAX + 1, SMAX, "cpu")
