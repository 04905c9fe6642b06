"""The port's z-sign kernels (E1 encode, R1 sign-reduce) against the
reference's TPU kernels, and against each other on a card.

On the CPU the wrappers run their plain PyTorch versions; those are held
bit-exact against the reference's Pallas kernels in interpret mode (K1
``compress_rng_pallas``, K2 ``compress_rng_pallas_batched``, K3
``sign_reduce_pallas``), against ``jax.vmap`` of the fused encode and
against the jnp twins (``fused_sign_encode_jnp``, ``wire.unpack_sum``).
z=1 goes through XLA's and torch's f32 erf; a differing bit is allowed only
within 4 ulp of its threshold (ops.erf_rule_flips), and the count is
reported. The kernels themselves are held against their plain versions on
the card by tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.kernels.zsign import ops as JO
from repro.kernels.zsign import zsign as JK
from repro_torch.core import noise as TN
from repro_torch.kernels.zsign import ops as TO

# The suite runs in parallel worker processes beside the reference's
# tests; one intra-op thread per worker keeps torch from oversubscribing
# the cores they share.
torch.set_num_threads(1)

TILE = 8192


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 0.05).astype(np.float32)
    x[:, ::11] = 0.0
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   i)) for i in range(n)])
    return x, keys.astype(np.uint32)


def _padded(x):
    n, d = x.shape
    d_pad = -(-d // TILE) * TILE
    return np.pad(x, ((0, 0), (0, d_pad - d)))


def _check(got, want, x2d, keys, sigma, z, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    if z == 1 and sigma > 0:
        n = x2d.shape[0]
        flips, far = TO.erf_rule_flips(
            torch.from_numpy(x2d), torch.from_numpy(keys.astype(np.int64)),
            torch.full((n,), sigma), 1,
            torch.from_numpy(got.reshape(n, -1).copy()),
            torch.from_numpy(want.reshape(n, -1).copy()))
        print(f"{label}: {flips} differing bits, all within the erf rule")
        assert far == 0, label
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("d", [1, 8191, 8193, 3 * TILE + 5])
@pytest.mark.parametrize("z", [0, 1])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_plain_encode_matches_reference_kernels(d, z, sigma):
    for n in (1, 3):
        x, keys = _inputs(n, d, seed=d + n)
        x2d = _padded(x)
        got = TO.zsign_encode(torch.from_numpy(x2d),
                              torch.from_numpy(keys.astype(np.int64)),
                              torch.full((n,), sigma), z).numpy()
        sig = jnp.full((n,), sigma, jnp.float32)
        # K1, one client at a time, interpret mode
        k1 = np.stack([np.asarray(JO.zsign_encode_fused(
            jnp.asarray(x[c]), jnp.asarray(keys[c]), sig[c], z=z,
            interpret=True)) for c in range(n)])
        _check(got, k1, x2d, keys, sigma, z, f"K1 n={n} d={d}")
        # K2, the client-batched Pallas kernel, interpret mode
        k2 = JK.compress_rng_pallas_batched(
            jnp.asarray(x2d.reshape(-1, 1024)), jnp.asarray(keys), sig, z=z,
            interpret=True)
        _check(got, np.asarray(k2).reshape(n, -1), x2d, keys, sigma, z,
               f"K2 n={n} d={d}")
        # jax.vmap of the fused encode (its custom vmap rule)
        vm = jax.vmap(lambda a, k, s: JO.zsign_encode_fused(
            a, k, s, z=z, interpret=True))(jnp.asarray(x), jnp.asarray(keys),
                                           sig)
        _check(got, vm, x2d, keys, sigma, z, f"vmap n={n} d={d}")
        # the jnp twin
        tw = np.stack([np.asarray(JC.fused_sign_encode_jnp(
            jnp.asarray(x[c]), jnp.asarray(keys[c]), sig[c], z=z))
            for c in range(n)])
        _check(got, tw, x2d, keys, sigma, z, f"jnp n={n} d={d}")


def test_noise_off_encode_is_plain_sign_pack():
    x, keys = _inputs(2, 2 * TILE, seed=5)
    got = TO.zsign_encode(torch.from_numpy(x), torch.from_numpy(
        keys.astype(np.int64)), torch.zeros(2), None).numpy()
    want = np.stack([np.asarray(JO.zsign_encode_fused(
        jnp.asarray(x[c]), jnp.asarray(keys[c]), 0.0, z=1, add_noise=False,
        interpret=True)) for c in range(2)])
    np.testing.assert_array_equal(got, want)


def test_fused_single_client_wrapper():
    x, keys = _inputs(1, 3 * TILE + 5, seed=9)
    got = TO.zsign_encode_fused(torch.from_numpy(x[0]),
                                torch.from_numpy(keys[0].astype(np.int64)),
                                0.05, z=0).numpy()
    want = np.asarray(JO.zsign_encode_fused(
        jnp.asarray(x[0]), jnp.asarray(keys[0]), 0.05, z=0, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 8, 13])
@pytest.mark.parametrize("kind", ["f32", "mask", "zero"])
def test_plain_sign_reduce_matches_reference(n, kind):
    rng = np.random.RandomState(n)
    nb = 5 * 1024 + 3
    p = rng.randint(0, 256, (n, nb)).astype(np.uint8)
    w = {"f32": rng.randn(n), "mask": rng.randint(0, 2, n),
         "zero": np.zeros(n)}[kind].astype(np.float32)
    acc = rng.randn(8 * nb).astype(np.float32)
    jp, jw = jnp.asarray(p), jnp.asarray(w)
    tp, tw = torch.from_numpy(p), torch.from_numpy(w)
    got = TO.sign_reduce(tp, tw).numpy().view(np.int32)
    k3 = np.asarray(JO.sign_reduce(jp, jw, interpret=True)).view(np.int32)
    np.testing.assert_array_equal(got, k3)
    np.testing.assert_array_equal(
        got, np.asarray(JC.wire.unpack_sum(jp, jw)).view(np.int32))
    # carried sum: the reference's kernel route adds acc after the reduce
    got_acc = TO.sign_reduce(tp, tw, torch.from_numpy(acc)).numpy()
    want_acc = np.asarray(JC.sign_reduce(jp, jw, "pallas",
                                         acc=jnp.asarray(acc)))
    np.testing.assert_array_equal(got_acc.view(np.int32),
                                  want_acc.view(np.int32))


def test_wrappers_count_only_kernel_launches():
    wrappers = (TO.zsign_encode, TO.sign_reduce, TO.zsign_compress_rows,
                TO.unpack_sum)
    before = [w.launches for w in wrappers]
    x = torch.zeros(2, TILE)
    TO.zsign_encode(x, TN.client_keys(TN.prng_key(0), 0, 2), torch.zeros(2),
                    1)
    TO.sign_reduce(torch.zeros(2, 4, dtype=torch.uint8), torch.ones(2))
    TO.zsign_compress_rows(x, x, torch.ones(2))
    TO.unpack_sum(torch.zeros(2, 4, dtype=torch.uint8))
    assert [w.launches for w in wrappers] == before


def test_unported_encode_modes_raise():
    # finite z > 1 has no counter stream: it takes the dense-noise encode
    with pytest.raises(ValueError, match="dense-noise"):
        TO.zsign_encode(torch.zeros(1, TILE), torch.zeros(1, 2,
                                                          dtype=torch.int64),
                        torch.ones(1), 2)
