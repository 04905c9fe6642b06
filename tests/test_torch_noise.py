"""The port's counter stream against the reference (repro.core.noise).

Inputs are numpy arrays made from a seed and handed to both packages.
Bit-exact: threefry2x32 (13 and 20 rounds), jax key derivation, the tile
stream and the z=inf wire bits. z=1 goes through two f32 erf implementations
(XLA's and torch's differ by up to 3.0e-7), so a differing bit is allowed
only where the uniform lies within 4 f32 ulp of its threshold, and the count
of such bits is reported.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as JN
from repro_torch.core import noise as TN

# The suite runs in parallel worker processes beside the reference's
# tests; one intra-op thread per worker keeps torch from oversubscribing
# the cores they share.
torch.set_num_threads(1)

ERF_ULPS = 4


def _u32(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _jax_threefry(k0, k1, x0, x1, rounds):
    old = JN.THREEFRY_ROUNDS
    JN.THREEFRY_ROUNDS = rounds
    try:
        y0, y1 = JN.threefry2x32(jnp.asarray(k0), jnp.asarray(k1),
                                 jnp.asarray(x0), jnp.asarray(x1))
        return np.asarray(y0), np.asarray(y1)
    finally:
        JN.THREEFRY_ROUNDS = old


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_matches_reference(rounds):
    rng = np.random.RandomState(rounds)
    k0, k1, x0, x1 = (_u32(rng, (4096,)) for _ in range(4))
    want = _jax_threefry(k0, k1, x0, x1, rounds)
    t = [torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, x0, x1)]
    got = TN.threefry2x32(*t, rounds=rounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 33 + 5])
def test_key_derivation_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = TN.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key))
    for i in (0, 1, 5, 123456, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            TN.fold_in(tkey, i).numpy(), np.asarray(jax.random.fold_in(key, i)))
    np.testing.assert_array_equal(TN.split(tkey, 3).numpy(),
                                  np.asarray(jax.random.split(key, 3)))
    np.testing.assert_array_equal(
        TN.client_keys(tkey, 7, 5).numpy(),
        np.asarray(JN.client_keys(key, 7, 5)))


@pytest.mark.parametrize("start", [0, 8192, 8192 * 37])
def test_tile_u01_bit_exact(start):
    k0, k1 = 0x12345678, 0x9ABCDEF0
    want = np.asarray(JN.tile_u01(jnp.uint32(k0), jnp.uint32(k1), start,
                                  8192))
    got = TN.tile_u01(torch.tensor(k0), torch.tensor(k1), start, 8192)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _erf_rule(x, u, sigma, z, got, want):
    """-> number of differing bits; asserts each lies within ERF_ULPS ulp
    of the threshold."""
    diff = np.nonzero(got != want)[0]
    if diff.size:
        r = np.float32(x[diff]) * (np.float32(1) / np.float32(sigma))
        thr = 1.0 - np.asarray(JN.sign_prob(jnp.asarray(r), z))
        ulp = np.spacing(thr.astype(np.float32))
        assert np.all(np.abs(u[diff] - thr) <= ERF_ULPS * ulp), diff
    return diff.size


@pytest.mark.parametrize("z", [0, 1])
@pytest.mark.parametrize("sigma", [0.0, 0.05, 2.0])
def test_stochastic_sign_bits(z, sigma):
    rng = np.random.RandomState(3)
    x = (rng.randn(1 << 16) * 0.1).astype(np.float32)
    u = np.concatenate([np.asarray(JN.tile_u01(jnp.uint32(9), jnp.uint32(4),
                                               t * 8192, 8192))
                        for t in range(8)])
    want = np.asarray(JN.stochastic_sign_bits(
        jnp.asarray(x), jnp.asarray(u), jnp.float32(sigma), z))
    got = TN.stochastic_sign_bits(torch.from_numpy(x), torch.from_numpy(u),
                                  torch.tensor(sigma), z).numpy()
    if z == 0 or sigma == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        flips = _erf_rule(x, u, sigma, z, got, want)
        print(f"z=1 sigma={sigma}: {flips} of {x.size} bits differ "
              f"(all within {ERF_ULPS} ulp of the threshold)")


def test_eta_and_support():
    for z in (0, 1, 2, 3):
        assert TN.eta_z(z) == JN.eta_z(z)
        assert TN.counter_supported(z) == JN.counter_supported(z)
    assert TN.Z_INF == JN.Z_INF
