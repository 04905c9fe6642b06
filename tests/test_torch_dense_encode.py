"""The dense-noise encode of the port (finite z > 1, the ``reference``
backend, ``zsign_packed``) against the reference.

(a) C1's plain version against the reference's ``zsign_compress`` (K5 in
    interpret mode). Under ``jax.jit`` on the CPU, XLA contracts the
    kernel body's ``x + sigma*noise`` into a multiply-add; the port rounds
    the product and the sum separately, as the source writes them (and as
    C1 does on the card). So a bit may differ only where the fused and the
    unfused y lie on the two sides of 0; the test builds such elements on
    purpose, checks that every differing bit is one of them, and reports
    the count.
(b) U1's plain version against ``zsign_decompress_sum``: bit-exact.
(c) ``sample_z_noise`` draws from a ``torch.Generator``, which cannot give
    jax.random's bits, so it is held to its law: a KS test against the CDF
    of the reference's ``pdf_z`` for z in {2, 3}, and the Monte-Carlo mean
    ``E[Sign(x + sigma*xi)] * eta_z * sigma`` against ``expected_sign``.
(d) A ``zsign_packed(z=2)`` round (and the plain ``zsign(z=2)`` and the
    ``reference`` backend) with both packages fed the SAME numpy noise:
    params bit-identical after 10 rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.kernels.zsign import ops as JO
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.kernels import zsign as TZ
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import train as TT
from repro_torch.models.api import build_model as t_build

torch.set_num_threads(1)

TILE = 8192


def _bits(packed, d):
    return np.unpackbits(np.asarray(packed), bitorder="little")[:d]


@pytest.mark.parametrize("d", [1, 8191, 8193, 3 * TILE + 5])
@pytest.mark.parametrize("sigma", [0.0, 0.37])
def test_plain_compress_matches_reference(d, sigma):
    rng = np.random.RandomState(d)
    x = (rng.randn(d) * 0.05).astype(np.float32)
    noise = rng.randn(d).astype(np.float32)
    sig = np.float32(sigma)
    x[::3] = -(sig * noise[::3])             # unfused y == 0 exactly
    x[1::11] = 0.0
    got = TZ.zsign_compress(torch.from_numpy(x), torch.from_numpy(noise),
                            sigma).numpy()
    want = np.asarray(JO.zsign_compress(jnp.asarray(x), jnp.asarray(noise),
                                        sigma, interpret=True))
    assert got.shape == want.shape == (-(-d // TILE) * 1024,)
    # the tile padding packs +1 on both sides
    np.testing.assert_array_equal(got[-(-d // 8):][1:], want[-(-d // 8):][1:])
    unfused = (x + sig * noise) >= 0
    fused = (x.astype(np.float64) + np.float64(sig) * noise) >= 0
    np.testing.assert_array_equal(_bits(got, d), unfused)
    differ = _bits(got, d) != _bits(want, d)
    assert not (differ & (unfused == fused)).any()
    print(f"zsign_compress d={d} sigma={sigma}: {int(differ.sum())} bits "
          f"differ, every one where fused and unfused y straddle 0")


def test_plain_compress_rows_is_per_client():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2 * TILE).astype(np.float32)
    nz = rng.randn(3, 2 * TILE).astype(np.float32)
    sig = torch.tensor([0.0, 0.5, 2.0])
    got = TO.zsign_compress_rows(torch.from_numpy(x), torch.from_numpy(nz),
                                 sig)
    for c in range(3):
        one = TZ.zsign_compress(torch.from_numpy(x[c]), torch.from_numpy(nz[c]),
                                float(sig[c]))
        assert torch.equal(got[c], one)


@pytest.mark.parametrize("n", [1, 3, 8, 13])
def test_plain_decompress_sum_matches_reference(n):
    rng = np.random.RandomState(n)
    nb = 2 * 1024 + 3
    p = rng.randint(0, 256, (n, nb)).astype(np.uint8)
    p[:, :5] = 0b01010101                    # balanced columns: +0.0
    n_coords = 8 * nb - 5
    got = TZ.zsign_decompress_sum(torch.from_numpy(p), n_coords).numpy()
    want = np.asarray(JO.zsign_decompress_sum(jnp.asarray(p), n_coords,
                                              interpret=True))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _cdf_from_pdf(z):
    """The CDF of the reference's p_z, integrated on a fine grid."""
    t = np.linspace(-4.0, 4.0, 400_001)
    pdf = np.asarray(JN.pdf_z(jnp.asarray(t, jnp.float32), z), np.float64)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2)
                          * (t[1] - t[0])])
    return lambda v: np.interp(v, t, cdf / cdf[-1])


@pytest.mark.parametrize("z", [2, 3])
def test_sample_z_noise_follows_pdf(z):
    xi = TN.sample_z_noise(TN.prng_key(z), (200_000,), z).numpy()
    assert xi.dtype == np.float32 and np.isfinite(xi).all()
    res = stats.kstest(xi, _cdf_from_pdf(z))
    print(f"z={z}: KS statistic {res.statistic:.2e}, p={res.pvalue:.3f}")
    assert res.pvalue > 1e-3
    # the port's pdf is the reference's (torch's and XLA's f32 exp and pow
    # differ by a few ulp)
    t = np.linspace(-3, 3, 101).astype(np.float32)
    np.testing.assert_allclose(TN.pdf_z(torch.from_numpy(t), z).numpy(),
                               np.asarray(JN.pdf_z(jnp.asarray(t), z)),
                               rtol=2e-5, atol=1e-30)


@pytest.mark.parametrize("z", [0, 1, 2, 3])
def test_sample_z_noise_debiased_sign_mean(z):
    sigma = 0.5
    x = np.linspace(-0.6, 0.6, 7).astype(np.float32)
    m = 100_000
    xi = TN.sample_z_noise(TN.prng_key(10 + z), (m,), z).numpy()
    mc = np.array([np.mean(np.where(v + sigma * xi >= 0, 1.0, -1.0))
                   for v in x]) * TN.eta_z(z) * sigma
    want = np.asarray(JN.expected_sign(jnp.asarray(x), sigma, z))
    np.testing.assert_allclose(TN.expected_sign(torch.from_numpy(x), sigma,
                                                z).numpy(), want, rtol=2e-5,
                               atol=1e-7)
    # 5 standard errors of a mean of +/-1 draws
    tol = 5 * TN.eta_z(z) * sigma / np.sqrt(m)
    np.testing.assert_allclose(mc, want, rtol=0, atol=tol)


def test_sample_z_noise_is_a_function_of_the_key():
    k = TN.client_keys(TN.prng_key(4), 0, 2)
    a = TN.sample_z_noise(k[0], (1000,), 2)
    assert torch.equal(a, TN.sample_z_noise(k[0], (1000,), 2))
    assert not torch.equal(a, TN.sample_z_noise(k[1], (1000,), 2))
    u = TN.sample_z_noise(k[0], (1000,), 0)
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0


def test_u01_to_noise_matches_reference():
    u = np.asarray(JN.tile_u01(jnp.uint32(3), jnp.uint32(9), 0, 8192))
    for z in (0, 1):
        got = TN.u01_to_noise(torch.from_numpy(u), z).numpy()
        want = np.asarray(JN.u01_to_noise(jnp.asarray(u), z))
        # z=1: torch's and XLA's f32 erfinv differ by a few ulp
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got = TN.counter_noise(torch.tensor([3, 9]), 10_000, 0).numpy()
    want = np.asarray(JN.counter_noise(jnp.asarray([3, 9], jnp.uint32),
                                       10_000, 0))
    np.testing.assert_array_equal(got, want)


D, N, ROUNDS = 200, 10, 10


def _shared_noise(monkeypatch, z):
    """Both packages draw their dense noise from one numpy table, looked up
    by the client key (the round keys are known in advance)."""
    keys, rng = [], jax.random.PRNGKey(1)
    for _ in range(ROUNDS):
        rng, sub = jax.random.split(rng)
        keys.append(np.asarray(JN.client_keys(sub, 0, N)))
    keys = np.concatenate(keys).astype(np.uint32)
    table = np.random.RandomState(z).standard_normal(
        (len(keys), D)).astype(np.float32)

    def j_sample(key, shape, z_, dtype=jnp.float32):
        hit = jnp.all(jnp.asarray(keys) == key.reshape(1, 2), axis=1)
        return jnp.asarray(table)[jnp.argmax(hit)].reshape(shape)

    def t_sample(key, shape, z_, device=None, dtype=torch.float32):
        hit = np.all(keys.astype(np.int64) == key.numpy().reshape(1, 2), 1)
        assert hit.sum() == 1
        return torch.from_numpy(table[np.argmax(hit)]).reshape(shape)

    monkeypatch.setattr(JN, "sample_z_noise", j_sample)
    monkeypatch.setattr(TN, "sample_z_noise", t_sample)


@pytest.mark.parametrize("spec", ["zsign_packed(z=2,sigma=2.0)",
                                  "zsign(z=2,sigma=2.0)",
                                  "zsign(z=3,sigma=2.0,encode_backend=reference)"])
def test_dense_round_with_shared_noise_bit_identical(spec, monkeypatch):
    _shared_noise(monkeypatch, 2)
    targets = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, N, D)))
    ys = targets[:, :, None]
    jcomp, tcomp = JC.Pipeline(spec), TC.Pipeline(spec)
    jcfg = JF.FedConfig(n_clients=N, client_lr=0.01, server_lr=2.0)
    tcfg = TF.FedConfig(n_clients=N, client_lr=0.01, server_lr=2.0)
    jstep = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), jcomp, jcfg)
    tstep = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), tcomp, tcfg)
    js = JF.init_server_state({"x": jnp.zeros(D)}, jcfg, jcomp,
                              jax.random.PRNGKey(1))
    ts = TF.init_server_state({"x": torch.zeros(D)}, tcfg, tcomp,
                              TN.prng_key(1))
    mask = np.ones((1, N), np.float32)
    mask[0, 3] = 0.0
    for _ in range(ROUNDS):
        js, jm = jstep(js, {"y": jnp.asarray(ys)}, jnp.asarray(mask))
        ts, tm = tstep(ts, {"y": torch.from_numpy(ys)}, mask)
    np.testing.assert_array_equal(ts.params["x"].numpy().view(np.int32),
                                  np.asarray(js.params["x"]).view(np.int32))
    assert float(tm.uplink_bits) == float(jm.uplink_bits) == (N - 1) * D


def test_dense_paths_build_and_route():
    packed = TC.Pipeline("zsign_packed(z=2,sigma=0.01)")
    assert packed.codec.dense_kernel and packed.codec.encode_backend == "cuda"
    assert TC.PackedZSignCompressor(z=2).codec == packed.codec
    ref = TC.Pipeline("zsign(z=1,sigma=0.5,encode_backend=reference)")
    assert ref.codec.encode_backend == "reference"
    assert "reference" in TC.ENCODE_BACKENDS
    TF.RoundContext(encode_backend="reference")


def test_train_run_cpu_zsign_packed_z2(capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--clients", "3",
                          "--local-steps", "2", "--seq-len", "16",
                          "--pipeline", "zsign_packed(z=2,sigma=0.01)"])
    history = TT.run(args)
    d = TW.tree_spec(t_build(t_get_arch("qwen2_0_5b").reduced().model)
                     .init(torch.Generator().manual_seed(0), "cpu")).n_coords
    assert len(history) == 2
    for m in history:
        assert float(m.uplink_bits) == 3 * d
        assert np.isfinite(float(m.loss))
    assert "zsign_packed" in capsys.readouterr().out
