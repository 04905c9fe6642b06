"""DP-SignFedAvg and the Plateau sigma in the port, against the reference.

(a) The RDP accountant (``compute_epsilon``, ``calibrate_noise``) and the
    ``PlateauController`` are pure Python: equal to the reference's results
    exactly, on a grid and on fixed loss sequences.
(b) ``clip_flat`` and its row form ``clip_rows_``: given the reference's
    norm, bit-exact (int32 patterns), the row form leaving the padding zero;
    with torch's own norm (another summation order) each row within its
    norm's ulps plus 2.
(c) The two spellings of the clip stage, ``dp(clip=C)|zsign(z=1,sigma=s)``
    and ``dp(clip=C,noise=s)|zsign``, are one round in the port, and, given
    the reference's norms, bit-identical to the reference's.
(d) ``dp(noise=s)|dense`` draws its noise from a ``torch.Generator`` (not
    jax.random's bits): a KS test of the added noise against N(0, s^2); a
    ``dpgauss`` round against the reference with both fed the same numpy
    noise (the dense wire's f32 sum is a matrix product in torch: params to
    1e-6), with a static and with a dynamic sigma.
(e) The dp build rules and error messages of the reference's pipeline
    tests: the same pipelines, or the same error text.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import compression as JC
from repro.core import dp as JD
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core.plateau import PlateauController as JPlateau
from repro_torch.core import compression as TC
from repro_torch.core import dp as TD
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core.plateau import PlateauController as TPlateau

torch.set_num_threads(1)


def _i32(a):
    return np.asarray(a).view(np.int32)


def _ref_row_norms(p2d, n_coords):
    x = jnp.asarray(p2d[:, :n_coords].detach().cpu().numpy())
    return torch.from_numpy(np.array(jax.vmap(jnp.linalg.norm)(x)))


# ---------------------------------------------------------------------------
# (a) accountant and Plateau controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [0.01, 0.3, 1.0])
def test_compute_epsilon_equal(q):
    for steps in (1, 100, 500):
        for delta in (1e-5, 1e-3):
            for nm in (0.6, 1.0, 3.0, 25.0):
                want = JD.compute_epsilon(q, nm, steps, delta)
                got = TD.compute_epsilon(q, nm, steps, delta)
                assert got == want, (q, steps, delta, nm)
    alphas = (2, 3, 17, 64)
    assert TD.rdp_subsampled_gaussian(q, 1.3, 50, alphas) == \
        JD.rdp_subsampled_gaussian(q, 1.3, 50, alphas)
    with pytest.raises(ValueError, match="alpha"):
        TD.rdp_subsampled_gaussian(q, 1.0, 1, (1,))


@pytest.mark.parametrize("q,steps,eps,delta", [
    (0.3, 200, 2.0, 1e-5), (1.0, 500, 2.0, 1e-5), (0.028, 500, 4.0, 1e-3),
    (1.0, 100, 8.0, 1e-5)])
def test_calibrate_noise_equal(q, steps, eps, delta):
    want = JD.calibrate_noise(q=q, steps=steps, target_eps=eps, delta=delta,
                              hi=200.0)
    got = TD.calibrate_noise(q=q, steps=steps, target_eps=eps, delta=delta,
                             hi=200.0)
    assert got == want
    assert TD.compute_epsilon(q, got, steps, delta) <= eps


def test_calibrate_noise_unreachable_raises():
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="unreachable"):
            mod.calibrate_noise(q=1.0, steps=10_000, target_eps=1e-3,
                                delta=1e-5, hi=1.0)


LOSSES = [
    [10, 9, 8, 7, 7, 7, 7, 7, 7, 7, 7, 7, 6.9999, 7, 7, 7],
    [5, 5, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3],
    [1.0] * 40,
    [3.0, float("nan"), 2.0, float("inf"), 2.0, 2.0, 1.0, 1.0, 1.0, 1.0],
    list(np.linspace(2.0, 1.0, 30) + 0.01 * np.sin(np.arange(30))),
]


@pytest.mark.parametrize("kw", [
    dict(sigma_init=0.01, sigma_bound=0.5, kappa=3, beta=2.0),
    dict(sigma_init=0.1, sigma_bound=1.0, kappa=2, beta=1.5),
    dict(sigma_init=0.01, sigma_bound=1.0, kappa=10),
    dict(sigma_init=0.2, sigma_bound=0.2, kappa=1, rel_improve=0.1)])
def test_plateau_histories_equal(kw):
    for losses in LOSSES:
        j, t = JPlateau(**kw), TPlateau(**kw)
        for loss in losses:
            assert t.update(loss) == j.update(loss)
        assert t.history == j.history
        assert (t.sigma, t.best, t.stale) == (j.sigma, j.best, j.stale) or (
            math.isnan(t.best) and math.isnan(j.best))
    with pytest.raises(ValueError, match="sigma_bound"):
        TPlateau(sigma_init=1.0, sigma_bound=0.5, kappa=2)


# ---------------------------------------------------------------------------
# (b) clip_flat and its row form
# ---------------------------------------------------------------------------

def _clip_rows_input(seed=0):
    rng = np.random.RandomState(seed)
    d, d_pad = 5000, 8192
    x = (rng.randn(5, d) * np.array([[0.001], [1.0], [7.0], [30.0], [0.0]])
         ).astype(np.float32)
    return x, d, d_pad


@pytest.mark.parametrize("max_norm", [1.0, 0.37, 5.0])
def test_clip_given_reference_norm_bit_exact(max_norm):
    x, d, d_pad = _clip_rows_input()
    want = np.stack([np.asarray(JD.clip_flat(jnp.asarray(r), max_norm))
                     for r in x])
    for c in range(x.shape[0]):
        nrm = torch.from_numpy(np.array(jnp.linalg.norm(jnp.asarray(x[c]))))
        got = TD.clip_flat(torch.from_numpy(x[c]), max_norm, nrm=nrm)
        np.testing.assert_array_equal(_i32(got.numpy()), _i32(want[c]))
    p2d = torch.from_numpy(np.pad(x, ((0, 0), (0, d_pad - d))))
    out = TD.clip_rows_(p2d, d, max_norm, nrms=_ref_row_norms(p2d, d))
    assert out is p2d
    np.testing.assert_array_equal(_i32(p2d[:, :d].numpy()), _i32(want))
    assert not p2d[:, d:].any()
    assert torch.linalg.vector_norm(p2d[2, :d]) <= max_norm * (1 + 1e-6)


def test_clip_own_norm_within_ulps():
    x, d, d_pad = _clip_rows_input(seed=1)
    want = np.stack([np.asarray(JD.clip_flat(jnp.asarray(r), 1.0))
                     for r in x])
    p2d = torch.from_numpy(np.pad(x, ((0, 0), (0, d_pad - d))))
    TD.clip_rows_(p2d, d, 1.0)
    ulp = np.abs(_i32(p2d[:, :d].numpy()).astype(np.int64)
                 - _i32(want).astype(np.int64)).max(axis=1)
    nrm = torch.from_numpy(x).norm(dim=1)
    nrm_ulp = np.abs(_i32(TD.row_norms(torch.from_numpy(x), d).numpy())
                     .astype(np.int64)
                     - _i32(_ref_row_norms(torch.from_numpy(x), d).numpy()))
    print(f"clip with the port's own norms: rows off by {ulp.tolist()} ulp, "
          f"their norms by {nrm_ulp.tolist()} ulp")
    # the factor 1/(nrm/C) carries the norm's ulps plus one rounding, the
    # product one more; unclipped rows (norm <= C) are untouched
    assert (ulp <= nrm_ulp + 2).all()
    assert (ulp[(nrm <= 1.0).numpy()] == 0).all()
    for c in range(x.shape[0]):
        got = TD.clip_flat(torch.from_numpy(x[c]), 1.0)
        assert torch.equal(got, p2d[c, :d])


# ---------------------------------------------------------------------------
# (c) the dp clip stage in a round
# ---------------------------------------------------------------------------

D, N, ROUNDS = 200, 10, 10
MASK = np.ones((1, N), np.float32)
MASK[0, 4] = 0.0


def _ys(local_steps=1, seed=0):
    t = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, N, D)))
    return np.repeat(t[:, :, None], local_steps, axis=2)


def _port(spec, ys, *, local_steps=1, slr=2.0, sigmas=None,
          rounds=ROUNDS):
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=N, local_steps=local_steps, client_lr=0.01,
                       server_lr=slr)
    step = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), comp, cfg,
        TF.RoundContext(dynamic_sigma=sigmas is not None))
    st = TF.init_server_state({"x": torch.zeros(D)}, cfg, comp,
                              TN.prng_key(1))
    for t in range(rounds):
        if sigmas is not None:
            st = st._replace(sigma=torch.tensor(sigmas[t],
                                                dtype=torch.float32))
        st, m = step(st, {"y": torch.from_numpy(ys)}, MASK)
    return st, m


def _reference(spec, ys, *, local_steps=1, slr=2.0, sigmas=None,
               rounds=ROUNDS):
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=N, local_steps=local_steps, client_lr=0.01,
                       server_lr=slr)
    step = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), comp, cfg,
        JF.RoundContext(dynamic_sigma=sigmas is not None))
    st = JF.init_server_state({"x": jnp.zeros(D)}, cfg, comp,
                              jax.random.PRNGKey(1))
    for t in range(rounds):
        if sigmas is not None:
            st = st._replace(sigma=jnp.asarray(sigmas[t], jnp.float32))
        st, m = step(st, {"y": jnp.asarray(ys)}, jnp.asarray(MASK))
    return st, m


@pytest.mark.parametrize("local_steps", [1, 2])
def test_dp_stage_clip_spellings_match_reference(local_steps, monkeypatch):
    """``dp(clip=C)|zsign(z=1,sigma=s)`` and the fused
    ``dp(clip=C,noise=s)|zsign`` are one round in the port; given the
    reference's norms, each is the reference's round bit for bit."""
    ys = _ys(local_steps)
    stage, _ = _port("dp(clip=1.0)|zsign(z=1,sigma=0.5)", ys,
                     local_steps=local_steps)
    fused, _ = _port("dp(clip=1.0,noise=0.5)|zsign", ys,
                     local_steps=local_steps)
    np.testing.assert_array_equal(_i32(stage.params["x"].numpy()),
                                  _i32(fused.params["x"].numpy()))
    monkeypatch.setattr(TD, "row_norms", _ref_row_norms)
    for spec in ("dp(clip=1.0)|zsign(z=1,sigma=0.5)",
                 "dp(clip=1.0,noise=0.5)|zsign"):
        tp, tm = _port(spec, ys, local_steps=local_steps)
        js, jm = _reference(spec, ys, local_steps=local_steps)
        np.testing.assert_array_equal(_i32(tp.params["x"].numpy()),
                                      _i32(js.params["x"]))
        assert float(tm.uplink_bits) == float(jm.uplink_bits) == (N - 1) * D


# ---------------------------------------------------------------------------
# (d) the dense DP noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [0.05, 1.7])
def test_dp_dense_noise_law(s):
    n, d = 4, 20_000
    keys = TN.client_keys(TN.prng_key(11), 0, n)
    comp = TC.Pipeline(f"dp(noise={s})|dense")
    assert comp._n_random == 1 and comp._sigma_stage == 0
    got, _ = comp.encode_batch(keys, torch.zeros((n, d)), d)
    for c in range(n):
        p = stats.kstest(got[c].numpy(), "norm", args=(0.0, s)).pvalue
        assert p > 1e-3, (c, p)
    assert not torch.equal(got[0], got[1])
    again, _ = comp.encode_batch(keys, torch.zeros((n, d)), d)
    assert torch.equal(again, got)
    # the dynamic sigma overrides the hand-set noise (the dpgauss law)
    dyn, _ = comp.encode_batch(keys, torch.zeros((n, d)), d,
                               sigma=torch.tensor(3.0 * s))
    p = stats.kstest(dyn[0].numpy(), "norm", args=(0.0, 3.0 * s)).pvalue
    assert p > 1e-3


def _shared_normal(monkeypatch, n_rounds):
    """Both packages draw the dp noise from one numpy table, looked up by
    the client key."""
    keys, rng = [], jax.random.PRNGKey(1)
    for _ in range(n_rounds):
        rng, sub = jax.random.split(rng)
        keys.append(np.asarray(JN.client_keys(sub, 0, N)))
    keys = np.concatenate(keys).astype(np.uint32)
    table = np.random.RandomState(3).standard_normal(
        (len(keys), D)).astype(np.float32)

    def j_normal(key, shape, dtype=jnp.float32):
        hit = jnp.all(jnp.asarray(keys) == key.reshape(1, 2), axis=1)
        return jnp.asarray(table)[jnp.argmax(hit)].reshape(shape)

    def t_sample(key, shape, z, device=None, dtype=torch.float32):
        assert z == 1
        hit = np.all(keys.astype(np.int64) == key.numpy().reshape(1, 2), 1)
        assert hit.sum() == 1
        return torch.from_numpy(table[np.argmax(hit)].copy()).reshape(shape)

    monkeypatch.setattr(jax.random, "normal", j_normal)
    monkeypatch.setattr(TN, "sample_z_noise", t_sample)


@pytest.mark.parametrize("dynamic", [False, True])
def test_dpgauss_round_with_shared_noise(dynamic, monkeypatch):
    ys = _ys()
    sigmas = [0.3 * (1 + t % 3) for t in range(ROUNDS)] if dynamic else None
    tcomp = TC.DPGaussianCompressor(sigma=0.3)
    jcomp = JC.DPGaussianCompressor(sigma=0.3)
    assert tcomp.spec == jcomp.spec == "dp(noise=0.3)|dense"
    _shared_normal(monkeypatch, ROUNDS)
    js, jm = _reference("dp(noise=0.3)|dense", ys, slr=1.0, sigmas=sigmas)
    ts, tm = _port("dp(noise=0.3)|dense", ys, slr=1.0, sigmas=sigmas)
    np.testing.assert_allclose(ts.params["x"].numpy(),
                               np.asarray(js.params["x"]), rtol=0, atol=1e-6)
    assert float(tm.uplink_bits) == float(jm.uplink_bits) == (N - 1) * D * 32
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-6)


# ---------------------------------------------------------------------------
# (e) dp build rules and messages
# ---------------------------------------------------------------------------

def _same_error(spec):
    with pytest.raises(ValueError) as jerr:
        JC.Pipeline(spec)
    with pytest.raises(ValueError) as terr:
        TC.Pipeline(spec)
    assert str(terr.value) == str(jerr.value), spec
    return str(terr.value)


def test_dp_spec_fuses_noise_into_the_codec():
    p = TC.Pipeline("dp(clip=1.5,noise=0.25)|zsign")
    assert isinstance(p.transforms[0], TC.DPTransform)
    assert p.transforms[0].clip == 1.5 and p.transforms[0].noise == 0.0
    assert isinstance(p.codec, TC.SignCodec)
    assert p.codec.z == 1 and p.codec.sigma == 0.25
    assert p.name == "dp(clip=1.5,noise=0.25)|zsign"
    for spec in ["dp(clip=1.0,noise=0.5)|zsign_packed",
                 "dp(clip=1.0,eps=2.0,steps=200,q=0.3)|zsign_packed",
                 "dp(clip=2.0)|dense", "dp(noise=0.4)|dense"]:
        tp, jp = TC.Pipeline(spec), JC.Pipeline(spec)
        assert tp.spec == jp.spec.replace("encode_backend=pallas",
                                          "encode_backend=cuda"), spec
        q = TC.Pipeline(tp.spec)
        assert (q.transforms, q.codec) == (tp.transforms, tp.codec), spec
    # the calibrated sigma is the accountant's multiplier times the clip
    p = TC.Pipeline("dp(clip=1.0,eps=2.0,steps=200,q=0.3)|zsign_packed")
    assert p.transforms[0].calibrated and p.codec.z == 1
    assert p.codec.sigma == TD.calibrate_noise(
        q=0.3, steps=200, target_eps=2.0, delta=1e-5, hi=200.0) * 1.0
    assert p.codec.sigma == JC.Pipeline(
        "dp(clip=1.0,eps=2.0,steps=200,q=0.3)|zsign_packed").codec.sigma


def test_dp_build_errors_match_reference():
    assert "ambiguous noise" in _same_error("dp(noise=0.5)|zsign(sigma=0.5)")
    assert "clip > 0" in _same_error("dp(eps=2.0)|zsign")
    assert "one target" in _same_error("dp(clip=1.0,eps=2.0,noise=0.3)|zsign")
    for bad in ["dp(clip=1.0,noise=0.5)|zsign(z=inf)",
                "dp(clip=1.0,noise=0.5)|stosign",
                "dp(clip=1.0,noise=0.5)|zsign(z=2)"]:
        assert "Gaussian" in _same_error(bad)
    assert "unknown transform stage" in _same_error("zsign|dp")


def test_dynamic_sigma_refused_over_calibrated_dp():
    for spec in ["dp(clip=1.0,eps=2.0,steps=100)|zsign",
                 "dp(clip=1.0,eps=2.0,steps=100)|dense"]:
        p = TC.Pipeline(spec)
        assert p.transforms[0].calibrated
        with pytest.raises(ValueError, match="Plateau") as terr:
            p.with_context(TF.RoundContext(dynamic_sigma=True))
        with pytest.raises(ValueError) as jerr:
            JC.Pipeline(spec).with_context(JF.RoundContext(
                dynamic_sigma=True))
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError, match="Plateau"):
            TF.build_round_step(lambda pr, b: 0.0, p, TF.FedConfig(),
                                TF.RoundContext(dynamic_sigma=True))
    # a hand-set dp noise (the dpgauss law) takes the dynamic sigma
    legacy = TC.DPGaussianCompressor(sigma=0.3)
    cfg = TF.FedConfig(n_clients=2, client_lr=0.01)
    step = TF.build_round_step(
        lambda pr, b: 0.5 * torch.sum((pr["x"] - b["y"]) ** 2), legacy, cfg,
        TF.RoundContext(dynamic_sigma=True))
    st = TF.init_server_state({"x": torch.zeros(8)}, cfg, legacy,
                              TN.prng_key(0), sigma0=0.7)
    st2, _ = step(st, {"y": torch.ones((1, 2, 1, 8))}, np.ones((1, 2)))
    assert torch.isfinite(st2.params["x"]).all()


def test_clip_only_dp_never_consumes_dynamic_sigma():
    p = TC.Pipeline("dp(clip=1.0)|dense")
    assert p._n_random == 0 and p._sigma_stage == "codec"
    flat = 10.0 * torch.ones((1, 32))
    got, _ = p.encode_batch(TN.client_keys(TN.prng_key(0), 0, 1),
                            flat.clone(), 32, sigma=torch.tensor(0.5))
    assert torch.equal(got[0], TD.clip_flat(10.0 * torch.ones(32), 1.0))
