"""The port's xLSTM (``repro_torch.models.xlstm``) against the reference's
``repro.models.xlstm`` on the same numpy inputs and weights (f32).

Tolerances, each relative to the largest |value| compared: block outputs,
decode outputs and states within 1e-5 (matmuls, the cumulative log-gate
sum and the per-chunk reductions run in each framework's order); the LM's
loss within rtol 1e-5 and its gradients within 1e-4 of the largest |grad|
(autograd through 32 steps of sLSTM and the stabilised decay matrix).
At T = 300 and 512 the mLSTM block is ill-conditioned in f32: the decay
exponent F_t - F_s is a difference of cumulative log-gate sums of
magnitude ~0.7 T, so each package lies ~5e-5 from an f64 evaluation of
the same formula. There each must lie within 1e-4 of the f64 evaluation
and within 2e-4 of the other. The gate weights are drawn larger than the
init's 0.02 so that the running max and the -1e30 floor are exercised.

The federated round is the reference's ``test_reduced_fed_round`` case
``xlstm_350m`` (4 clients, E = 2, zsign(z=1,sigma=0.05), the same batch
every round, 5 rounds) run in both packages from the same weights. Given
the port's round-0 pre-encode buffer, the reference's encode sends the
same wire bytes; the per-round losses agree within rtol 1e-4 (a
pseudo-gradient within an ulp of a client's noise threshold may flip its
bit, which moves later rounds by a whole sign step); the loss drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import get_arch as j_get_arch
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro.models import xlstm as JX
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core.tree import tree_leaves
from repro_torch.models import xlstm as TX
from repro_torch.models.api import build_model as t_build
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

REL, GRAD_REL = 1e-5, 1e-4
D, H = 32, 4


def _close(got, want, rel=REL):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _mlstm_lp(seed):
    p = JX.mlstm_init(jax.random.PRNGKey(seed), D, H, 1, jnp.float32)
    lp = {k: np.array(v[0]) for k, v in p.items()}
    rs = np.random.RandomState(seed)
    lp["wif"] = (rs.randn(D, 2 * H) * 0.5).astype(np.float32)
    lp["bif"] = rs.randn(2 * H).astype(np.float32)
    return lp


def _slstm_lp(seed):
    p = JX.slstm_init(jax.random.PRNGKey(seed), D, H, 1, jnp.float32)
    lp = {k: np.array(v[0]) for k, v in p.items()}
    lp["b"] = np.random.RandomState(seed).randn(4 * D).astype(np.float32)
    return lp


def _j(lp):
    return {k: jnp.asarray(v) for k, v in lp.items()}


def _t(lp):
    return {k: torch.from_numpy(v.copy()) for k, v in lp.items()}


_j_mlstm = jax.jit(JX.mlstm_block, static_argnames=("n_heads",))
_j_slstm = jax.jit(JX.slstm_block, static_argnames=("n_heads",))


def _mlstm_f64(x, lp):
    """The mLSTM block's formula in f64 numpy, one (T, T) decay matrix."""
    L = {k: v.astype(np.float64) for k, v in lp.items()}
    x = x.astype(np.float64)
    B, T, _ = x.shape
    hd = D // H

    def heads(a):
        return a.reshape(B, T, H, hd).transpose(0, 2, 1, 3)

    q, k, v = (heads(a) for a in np.split(x @ L["wqkv"], 3, -1))
    i_pre, f_pre = np.split(x @ L["wif"] + L["bif"], 2, -1)
    Fc = np.cumsum(-np.logaddexp(0, -f_pre), axis=1).transpose(0, 2, 1)
    expo = Fc[..., :, None] - Fc[..., None, :] \
        + i_pre.transpose(0, 2, 1)[..., None, :]
    expo = np.where(np.tril(np.ones((T, T), bool)), expo, -np.inf)
    m = expo.max(-1)
    sc = np.einsum("bhtd,bhsd->bhts", q, k / hd ** 0.5) \
        * np.exp(expo - m[..., None])
    y = np.einsum("bhts,bhsd->bhtd", sc, v) \
        / np.maximum(np.abs(sc.sum(-1)), np.exp(-m))[..., None]
    y = y.transpose(0, 2, 1, 3).reshape(B, T, D)
    y = y / np.sqrt(np.mean(y ** 2, -1, keepdims=True) + 1e-6) * L["ln_sk"]
    return y @ L["wo"]


@pytest.mark.parametrize("T", [32, 512, 300])
def test_mlstm_block_matches_reference(T):
    """One key chunk (T = 32), two chunks of 256 (T = 512) and kc = T
    (300 is not a multiple of 256)."""
    rs = np.random.RandomState(T)
    lp = _mlstm_lp(T)
    x = rs.randn(2, T, D).astype(np.float32)
    want = _j_mlstm(jnp.asarray(x), _j(lp), n_heads=H)
    got = TX.mlstm_block(torch.from_numpy(x), _t(lp), n_heads=H)
    assert bool(torch.all(torch.isfinite(got)))
    if T == 32:
        _close(got.numpy(), want)
        return
    exact = _mlstm_f64(x, lp)
    _close(got.numpy(), exact, 1e-4)
    _close(want, exact, 1e-4)
    _close(got.numpy(), want, 2e-4)


def test_mlstm_masked_rows_give_finite_grads():
    """Queries before the second key chunk see only masked exponents there:
    exp(-inf) = 0 and m_prev - m_new = 0, no NaN forward or backward."""
    lp = {k: v.requires_grad_(True) for k, v in _t(_mlstm_lp(1)).items()}
    x = torch.randn(1, 512, D, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y = TX.mlstm_block(x, lp, n_heads=H)
    grads = torch.autograd.grad(y.square().sum(), [x] + list(lp.values()))
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


def test_slstm_block_matches_reference_across_two_chunks():
    rs = np.random.RandomState(2)
    lp = _slstm_lp(2)
    x = rs.randn(2, 512, D).astype(np.float32)
    want = _j_slstm(jnp.asarray(x), _j(lp), n_heads=H)
    got = TX.slstm_block(torch.from_numpy(x), _t(lp), n_heads=H)
    _close(got.numpy(), want)


def test_mlstm_decode_steps_match_reference():
    rs = np.random.RandomState(3)
    lp = _mlstm_lp(3)
    jc = JX.mlstm_cache_init(2, D, H, 1)
    tc = TX.mlstm_cache_init(2, D, H, 1, "cpu")
    js = [jc[k][0] for k in "Cnm"]
    ts = [tc[k][0] for k in "Cnm"]
    for _ in range(6):
        x = rs.randn(2, 1, D).astype(np.float32)
        jy, *js = JX.mlstm_decode_step(jnp.asarray(x), _j(lp), *js,
                                       n_heads=H)
        ty, *ts = TX.mlstm_decode_step(torch.from_numpy(x), _t(lp), *ts,
                                       n_heads=H)
        _close(ty.numpy(), jy)
        for a, b in zip(ts, js):
            _close(a.numpy(), b)


def test_slstm_decode_steps_match_reference():
    rs = np.random.RandomState(4)
    lp = _slstm_lp(4)
    jc = JX.slstm_cache_init(2, D, 1)
    tc = TX.slstm_cache_init(2, D, 1, "cpu")
    js = [jc[k][0] for k in "hcnm"]
    ts = [tc[k][0] for k in "hcnm"]
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for _ in range(6):
        x = rs.randn(2, 1, D).astype(np.float32)
        jy, *js = JX.slstm_decode_step(jnp.asarray(x), _j(lp), *js,
                                       n_heads=H)
        ty, *ts = TX.slstm_decode_step(torch.from_numpy(x), _t(lp), *ts,
                                       n_heads=H)
        _close(ty.numpy(), jy)
        for a, b in zip(ts, js):
            _close(a.numpy(), b)


def _pair():
    jb = j_build(j_get_arch("xlstm_350m").reduced().model)
    tb = t_build(t_get_arch("xlstm_350m").reduced().model)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                device="cpu")
    return jb, tb, jparams, tparams


def test_lm_loss_and_gradients_match_reference():
    jb, tb, jparams, tparams = _pair()
    toks = np.random.RandomState(5).randint(0, tb.cfg.vocab, (2, 32)) \
        .astype(np.int32)
    jloss, jgrad = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jparams, {"tokens": jnp.asarray(toks)})
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tloss = tb.loss_fn(tparams, {"tokens": torch.from_numpy(toks)})
    tgrad = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    tflat = torch.cat([g.reshape(-1) for g in tgrad]).numpy()
    _close(tflat, JW.tree_spec(jgrad).flatten(jgrad), GRAD_REL)


def test_lm_decode_steps_match_reference_and_forward():
    """6 decode steps of the LM against the reference's (logits and every
    cache leaf) and against the port's teacher-forced forward."""
    jb, tb, jparams, tparams = _pair()
    toks = np.random.RandomState(6).randint(0, tb.cfg.vocab, (2, 6))
    jcache, tcache = jb.init_cache(2, 6), tb.init_cache(2, 6, device="cpu")
    full = TX.forward(tparams, torch.from_numpy(toks), tb.cfg).detach()
    outs = []
    for t in range(6):
        jl, jcache = jb.decode_step(jparams, jcache,
                                    jnp.asarray(toks[:, t:t + 1]), t)
        tl, tcache = tb.decode_step(tparams, tcache,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl.numpy(), jl)
        outs.append(tl[:, 0])
    for grp in ("m", "s"):
        for k, v in tcache[grp].items():
            _close(v.numpy(), jcache[grp][k])
    _close(torch.stack(outs, dim=1).numpy(), full.numpy())


def test_cache_bytes_do_not_grow():
    tb = t_build(t_get_arch("xlstm_350m").reduced().model)
    nbytes = [sum(v.numel() * v.element_size() for g in c.values()
                  for v in g.values())
              for c in (tb.init_cache(3, 8, device="cpu"),
                        tb.init_cache(3, 4096, device="cpu"))]
    assert nbytes[0] == nbytes[1] > 0


def test_reduced_fed_round_xlstm(monkeypatch):
    jb, tb, jparams, tparams = _pair()
    spec = "zsign(z=1,sigma=0.05)"
    kw = dict(n_clients=4, local_steps=2, client_lr=0.05, server_lr=0.5)
    jcomp, tcomp = JC.Pipeline(spec), TC.Pipeline(spec)
    jstep = jax.jit(JF.build_round_step(jb.loss_fn, jcomp,
                                        JF.FedConfig(**kw)))
    tstep = TF.build_round_step(tb.loss_fn, tcomp, TF.FedConfig(**kw))
    jst = JF.init_server_state(jparams, JF.FedConfig(**kw), jcomp,
                               jax.random.PRNGKey(1))
    tst = TF.init_server_state(tparams, TF.FedConfig(**kw), tcomp,
                               TN.prng_key(1))
    bspec = JF.make_batch_spec(JF.FedConfig(**kw),
                               jb.train_batch_spec(2, 32))
    toks = np.random.RandomState(2).randint(
        0, tb.cfg.vocab, bspec["tokens"].shape).astype(np.int32)
    mask = np.ones((1, 4), np.float32)
    seen = []
    encode = TC.Pipeline.encode_batch

    def record(self, keys, x2d, *a, **k):
        if not seen:
            seen.append((keys.clone(), x2d.clone()))
        out = encode(self, keys, x2d, *a, **k)
        if len(seen) == 1:
            seen.append(out[0].clone())
        return out

    monkeypatch.setattr(TC.Pipeline, "encode_batch", record)
    jl, tl = [], []
    for _ in range(5):
        jst, jm = jstep(jst, {"tokens": jnp.asarray(toks)},
                        jnp.asarray(mask))
        tst, tm = tstep(tst, {"tokens": torch.from_numpy(toks)}, mask)
        jl.append(float(jm.loss))
        tl.append(float(tm.loss))
    assert all(np.isfinite(tl)) and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    (tkeys, x2d), payload = seen[0], seen[1]
    jkeys = JN.client_keys(jax.random.split(jax.random.PRNGKey(1))[1], 0, 4)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    n = JW.tree_spec(jparams).n_coords
    want = np.stack([np.asarray(JC.fused_sign_encode_jnp(
        jnp.asarray(x2d[c, :n].numpy()), jkeys[c], 0.05, z=1))
        for c in range(4)])
    np.testing.assert_array_equal(payload[:, :want.shape[1]].numpy(), want)
