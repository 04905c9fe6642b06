"""The port's noise controls and control variates against the reference:
sto-sign, the engine's dynamic (Plateau) sigma, ``sigma_sched`` and ``cv``.

(a) Sto-sign (``stosign``, sigma_i = ||p_i||_2, z = inf): fed the
    reference's norms the port's wire bytes are the reference's. With its
    own norms (``torch.linalg.vector_norm`` sums in another order than XLA,
    so a norm can differ by an ulp) a bit may differ only where the
    element's uniform lies between the threshold under the port's sigma and
    the threshold under the reference's (the flip rule); the count is
    reported.
(b) The two decode orders: a static sigma debiases by f32(eta_z * sigma)
    (the product in Python double), a dynamic one by f32(eta_z) * f32(sigma)
    (rounded in f32). Both are held to the reference as int32 patterns, as
    is the local decode an ``ef`` residual subtracts under a dynamic sigma.
(c) ``sigma_sched``: multipliers, the encode of ``sigma_sched|codec``
    against the reference's, the unscaled decode, the build rules.
(d) ``cv``: its slots, its update law, the SCAFFOLD bookkeeping identity,
    the first round equal to the plain codec, ``ef|cv``, its refusals.
(e) Consensus rounds (D = 200 over three leaves, N = 10 with two dead
    clients, E in {1, 2}) against the reference run op by op, for
    ``stosign``, ``dp(clip=1.0,noise=0.5)|zsign``,
    ``sigma_sched(head=2.0,tail=0.5)|ef|zsign``, ``cv|zsign_packed(sigma=
    2.0)`` and ``zsign(z=1,sigma=2.0)`` under a dynamic sigma that changes
    every round: params, state rows and server state bit-identical. Where a
    norm (sto-sign sigma, dp clip) or the EF scale mean(|p|) enters, the
    port is fed the reference's value for the bit-exact run; with its own
    values the rounds are held to the flip rule's consequence (see
    ``test_consensus_own_norms_within_rule``) and to the EF tolerance of
    tests/test_torch_efsign.py. ``sigma_sched|ef|zsign`` with E = 2 is held
    to that EF tolerance too: the reference's local steps run under
    ``lax.scan``, whose multiply-add moves the pseudo-gradient by an ulp,
    and the residual carries it.
(f) ``cv`` under ``stream(shard=K)`` (K in {1, 3, 8}), ``feed=host`` and
    ``client_groups=2``: bit-identical to the port's vmap round and to the
    reference under the same plan.
(g) The launcher's new paths on the CPU, and ``compression.available()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import dp as TD
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import train as TT
from repro_torch.models.api import build_model as t_build

torch.set_num_threads(1)

TILE = 8192


def _i32(a):
    return np.asarray(a).view(np.int32)


def _ref_row_norms(p2d, n_coords):
    """The reference's norms of the port's rows: XLA's batched
    ``jnp.linalg.norm``, as the reference's vmapped round computes them."""
    x = jnp.asarray(p2d[:, :n_coords].detach().cpu().numpy())
    return torch.from_numpy(np.array(jax.vmap(jnp.linalg.norm)(x)))


def _ref_mean_abs_rows(p2d, d, e2d=None):
    """The reference's EF scale mean(|p|) of the port's rows (XLA)."""
    x = p2d[:, :d] if e2d is None else p2d[:, :d] + e2d
    x = jnp.asarray(x.detach().cpu().numpy())
    return torch.from_numpy(np.array(
        jax.vmap(lambda r: jnp.mean(jnp.abs(r)))(x)))


@pytest.fixture
def ref_norms(monkeypatch):
    monkeypatch.setattr(TD, "row_norms", _ref_row_norms)
    monkeypatch.setattr(TC, "_mean_abs_rows", _ref_mean_abs_rows)


def _rows(n, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x *= rng.rand(n, 1).astype(np.float32) * 3
    x[:, ::9] = 0.0
    return x


def _padded(x):
    n, d = x.shape
    d_pad = -(-d // TILE) * TILE
    return torch.from_numpy(np.pad(x, ((0, 0), (0, d_pad - d))))


def _keys(n, seed=3):
    jk = JN.client_keys(jax.random.PRNGKey(seed), 0, n)
    tk = TN.client_keys(TN.prng_key(seed), 0, n)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    return jk, tk


# ---------------------------------------------------------------------------
# (a) sto-sign wire bytes
# ---------------------------------------------------------------------------

def _ref_encode(spec, jkeys, x, **kw):
    comp = JC.Pipeline(spec)
    out = [comp.encode(jkeys[c], jnp.asarray(x[c]), None, **kw)[0]
           for c in range(x.shape[0])]
    return np.stack([np.asarray(o) for o in out])


def _flip_rule_far(x2d, keys, sig_port, sig_ref, got, want):
    """Differing bits of two z = inf encodes of the same rows: -> (count,
    number of them whose uniform lies OUTSIDE the closed interval between
    the two thresholds 1 - P_inf(x / sigma) under the port's and the
    reference's sigma)."""
    diff = got ^ want
    client, byte = torch.nonzero(diff, as_tuple=True)
    if client.numel() == 0:
        return 0, 0
    bits = (diff[client, byte].unsqueeze(-1)
            >> torch.arange(8, dtype=torch.uint8)) & 1
    rows, ks = torch.nonzero(bits, as_tuple=True)
    client, elem = client[rows], byte[rows] * 8 + ks
    u = TO.element_u01(keys, client, elem)
    x = x2d[client, elem]

    def thr(sig):
        return 1.0 - TN.sign_prob(x * torch.reciprocal(sig[client]),
                                  TN.Z_INF)
    a, b = thr(sig_port), thr(sig_ref)
    inside = (u >= torch.minimum(a, b)) & (u <= torch.maximum(a, b))
    return int(elem.numel()), int((~inside).sum())


@pytest.mark.parametrize("d", [200, 3 * TILE + 5])
def test_stosign_bytes_match_reference(d, monkeypatch):
    n = 6
    x = _rows(n, d, seed=d)
    jkeys, tkeys = _keys(n)
    want = _ref_encode("stosign", jkeys, x)
    x2d = _padded(x)
    comp = TC.Pipeline("stosign")
    assert comp.codec.z == TN.Z_INF and comp.codec.sigma_mode == "norm"
    own, _ = comp.encode_batch(tkeys, x2d.clone(), d)
    sig_ref = _ref_row_norms(x2d, d)
    sig_port = TD.row_norms(x2d, d)
    assert len(set(sig_port.tolist())) == n        # one sigma per client
    monkeypatch.setattr(TD, "row_norms", _ref_row_norms)
    given, _ = comp.encode_batch(tkeys, x2d.clone(), d)
    np.testing.assert_array_equal(given.numpy(), want)
    flips, far = _flip_rule_far(x2d, tkeys, sig_port, sig_ref, own,
                                torch.from_numpy(want))
    ulps = np.abs(_i32(sig_port.numpy()) - _i32(sig_ref.numpy()))
    print(f"stosign d={d}: norms differ by {ulps.tolist()} ulp; "
          f"{flips} wire bits differ with the port's own norms")
    assert far == 0 and ulps.max() <= 4


def test_stosign_decode_and_ef_default():
    comp = TC.Pipeline("stosign")
    g = torch.tensor([3.0, -1.0, 0.5])
    assert torch.equal(comp.decode_sum(g, torch.tensor(2.0)), g / 2.0)
    # the dynamic sigma does not reach the norm-mode codec's debias
    assert torch.equal(comp.decode_sum(g, torch.tensor(2.0),
                                       sigma=torch.tensor(0.3)), g / 2.0)
    assert TC.Pipeline("ef|stosign").codec.scale == "none"
    assert TC.StoSignCompressor().codec == comp.codec
    with pytest.raises(ValueError, match="sigma_mode"):
        TC.Pipeline("zsign(sigma_mode=nope)")


# ---------------------------------------------------------------------------
# (b) the static and dynamic decode orders
# ---------------------------------------------------------------------------

SIGMAS = [0.3, 0.015, 2.0, 0.1, 1e-3, 0.7]


@pytest.mark.parametrize("z", [1, 2, "inf"])
def test_static_and_dynamic_decode_orders(z):
    rng = np.random.RandomState(7)
    enc_sum = rng.randint(-9, 10, 4096).astype(np.float32)
    n_live = np.float32(9.0)
    differ = 0
    for s in SIGMAS:
        spec = f"zsign(z={z},sigma={s})"
        jc, tc = JC.Pipeline(spec), TC.Pipeline(spec)
        js = jc.decode_sum(jnp.asarray(enc_sum), jnp.asarray(n_live))
        ts = tc.decode_sum(torch.from_numpy(enc_sum), torch.tensor(n_live))
        np.testing.assert_array_equal(_i32(ts.numpy()), _i32(js))
        jd = jc.decode_sum(jnp.asarray(enc_sum), jnp.asarray(n_live),
                           sigma=jnp.float32(s))
        td = tc.decode_sum(torch.from_numpy(enc_sum), torch.tensor(n_live),
                           sigma=torch.tensor(s, dtype=torch.float32))
        np.testing.assert_array_equal(_i32(td.numpy()), _i32(jd))
        differ += int(not np.array_equal(_i32(ts.numpy()), _i32(td.numpy())))
    if z != "inf":
        # the two orders differ in the last bit for some sigma
        assert differ > 0


def test_dynamic_sigma_encode_and_local_decode_match_reference():
    """``ef|zsign(z=1,sigma=0.5)`` under a dynamic sigma of 0.7: the bits
    and the residual (p - f32(eta_1) * f32(0.7) * signs) are the
    reference's; a dynamic 0 degrades to the noise-free pack."""
    n, d = 4, 2 * TILE + 9
    x = _rows(n, d, seed=1)
    jkeys, tkeys = _keys(n, seed=5)
    spec = "ef|zsign(z=1,sigma=0.5)"
    jc, tc = JC.Pipeline(spec), TC.Pipeline(spec)
    assert tc._sigma_stage == "codec" and tc.codec.scale == "none"
    e0 = (np.random.RandomState(2).randn(n, d) * 0.1).astype(np.float32)
    for s in (0.7, 0.0):
        want, want_e = [], []
        for c in range(n):
            enc, st = jc.encode(jkeys[c], jnp.asarray(x[c]),
                                {"ef": jnp.asarray(e0[c])},
                                sigma=jnp.float32(s))
            want.append(np.asarray(enc))
            want_e.append(np.asarray(st["ef"]))
        state = {"ef": torch.from_numpy(e0.copy())}
        got, new = tc.encode_batch(tkeys, _padded(x), d, state,
                                   sigma=torch.tensor(s))
        flips, far = TO.erf_rule_flips(
            _padded(x) + torch.from_numpy(np.pad(e0, ((0, 0), (0, 3 * TILE
                                                                - d)))),
            tkeys, torch.full((n,), s), 1, got, torch.from_numpy(
                np.stack(want)))
        assert far == 0 and flips == 0
        np.testing.assert_array_equal(_i32(new["ef"].numpy()),
                                      _i32(np.stack(want_e)))


# ---------------------------------------------------------------------------
# (c) sigma_sched
# ---------------------------------------------------------------------------

def _tree_np(seed=0):
    r = np.random.RandomState(seed)
    return {"a": r.randn(3, 4).astype(np.float32),
            "b": r.randn(7).astype(np.float32),
            "c": r.randn(5).astype(np.float32)}


def _specs(tree):
    js = JW.TreeSpec.from_tree({k: jnp.asarray(v) for k, v in tree.items()})
    ts = TW.TreeSpec.from_tree({k: torch.from_numpy(v)
                                for k, v in tree.items()})
    return js, ts


SCHED_BAD = [("sigma_sched|cv|zsign", "cv"), ("cv|sigma_sched|zsign", "cv"),
             ("ef|sigma_sched|zsign", "first stage"),
             ("dp(clip=1.0,noise=0.0)|sigma_sched|zsign", "first stage"),
             ("sigma_sched|sigma_sched|zsign", "at most one"),
             ("sigma_sched(head=-1)|zsign", "positive"),
             ("sigma_sched(head=1,tail=0)|zsign", "positive")]
SCHED_OK = ["sigma_sched|zsign", "sigma_sched(head=2,tail=0.5)|ef|zsign",
            "sigma_sched|dp(clip=1.0,noise=0.0)|zsign_packed",
            "sigma_sched|dense"]


def test_sigma_sched_build_rules():
    for bad, msg in SCHED_BAD:
        with pytest.raises(ValueError, match=msg):
            JC.Pipeline(bad)
        with pytest.raises(ValueError, match=msg):
            TC.Pipeline(bad)
    for ok in SCHED_OK:
        assert TC.Pipeline(ok).needs_tree_spec
        assert TC.Pipeline(ok).spec == JC.Pipeline(ok).spec.replace(
            "encode_backend=pallas", "encode_backend=cuda")
    # the qsgd and topk codecs build under sigma_sched as in the reference
    for later in ("sigma_sched|topk(frac=0.2)", "sigma_sched|qsgd"):
        assert TC.Pipeline(later).spec == JC.Pipeline(later).spec
        assert TC.Pipeline(later).needs_tree_spec
    assert not TC.Pipeline("ef|zsign").needs_tree_spec
    assert (TC.Pipeline("sigma_sched|zsign_packed").wire_bits_per_coord
            == TC.Pipeline("zsign_packed").wire_bits_per_coord == 1.0)


def test_multipliers_match_reference():
    tree = _tree_np()
    js, ts = _specs(tree)
    for head, tail in ((4.0, 0.25), (2.0, 0.5), (1.3, 7.1), (3.0, 3.0)):
        jm = JC.SigmaSchedule(head=head, tail=tail).multipliers(js)
        tm = TC.SigmaSchedule(head=head, tail=tail).multipliers(ts)
        np.testing.assert_array_equal(_i32(tm.numpy()), _i32(jm))
    one = {"w": np.zeros(6, np.float32)}
    jo, to = _specs(one)
    np.testing.assert_array_equal(
        TC.SigmaSchedule(head=3.0, tail=9.0).multipliers(to).numpy(),
        np.full(6, 3.0, np.float32))


@pytest.mark.parametrize("codec", ["zsign(z=1,sigma=0.1)", "zsign_packed",
                                   "zsign(z=inf,sigma=0.3)", "dense"])
def test_sigma_sched_encode_decode_match_reference(codec):
    n = 3
    trees = [_tree_np(s) for s in range(n)]
    js, ts = _specs(trees[0])
    d = ts.n_coords
    flats = np.stack([np.asarray(js.flatten(
        {k: jnp.asarray(v) for k, v in t.items()})) for t in trees])
    jkeys, tkeys = _keys(n, seed=7)
    spec = f"sigma_sched(head=1.7,tail=0.3)|{codec}"
    jc, tc = JC.Pipeline(spec), TC.Pipeline(spec)
    with pytest.raises(ValueError, match="TreeSpec"):
        tc.encode_batch(tkeys, _padded(flats), d)
    want = [jc.encode(jkeys[c], jnp.asarray(flats[c]), None, spec=js)[0]
            for c in range(n)]
    x2d = _padded(flats) if codec != "dense" else torch.from_numpy(
        flats.copy())
    got, _ = tc.encode_batch(tkeys, x2d, d, spec=ts)
    for c in range(n):
        if codec == "dense":
            np.testing.assert_array_equal(_i32(got[c].numpy()),
                                          _i32(want[c]))
        else:
            np.testing.assert_array_equal(got[c].numpy(),
                                          np.asarray(want[c]))
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    jagg = jc.aggregate(jnp.stack(want), jnp.asarray(mask), d)
    tagg = tc.aggregate(got, torch.from_numpy(mask), d)
    with pytest.raises(ValueError, match="TreeSpec"):
        tc.decode_sum(tagg, torch.tensor(2.0))
    jg = np.asarray(jc.decode_sum(jagg, jnp.asarray(2.0), spec=js))[:d]
    tg = tc.decode_sum(tagg, torch.tensor(2.0), spec=ts)[:d].numpy()
    if codec == "dense":
        np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(_i32(tg), _i32(jg))


def test_uniform_multiplier_is_effective_sigma():
    """head == tail == 2 at codec sigma 0.2 IS the plain codec at sigma
    0.1: the same bits, and a bit-identical decoded estimate."""
    flat = np.stack([np.asarray(JW.TreeSpec.from_tree(
        {k: jnp.asarray(v) for k, v in _tree_np().items()}).flatten(
        {k: jnp.asarray(v) for k, v in _tree_np().items()}))])
    _, ts = _specs(_tree_np())
    _, tkeys = _keys(1)
    sched = TC.Pipeline("sigma_sched(head=2,tail=2)|zsign(z=1,sigma=0.2)")
    plain = TC.Pipeline("zsign(z=1,sigma=0.1)")
    enc, _ = sched.encode_batch(tkeys, _padded(flat), ts.n_coords, spec=ts)
    ref, _ = plain.encode_batch(tkeys, _padded(flat), ts.n_coords)
    assert torch.equal(enc, ref)
    one = torch.ones(1)
    g = sched.decode_sum(sched.aggregate(enc, one, ts.n_coords),
                         torch.tensor(1.0), spec=ts)
    g_ref = plain.decode_sum(plain.aggregate(ref, one, ts.n_coords),
                             torch.tensor(1.0))
    d = ts.n_coords
    assert torch.equal(g[:d].view(torch.int32), g_ref[:d].view(torch.int32))


# ---------------------------------------------------------------------------
# (d) control variates: slots, law, refusals
# ---------------------------------------------------------------------------

def test_cv_slots_and_kwargs():
    comp = TC.Pipeline("cv|zsign_packed")
    assert [(s.name, s.shape, s.scope) for s in comp.state_slots(64)] == \
        [(s.name, s.shape, s.scope)
         for s in JC.Pipeline("cv|zsign_packed").state_slots(64)]
    assert set(comp.init_state(64, lead=(2, 3))) == {"cv"}
    assert comp.init_state(64, lead=(2, 3))["cv"].shape == (2, 3, 64)
    server = comp.init_server_state(64)
    assert list(server) == ["cv_server"]
    assert server["cv_server"].shape == (64,)
    assert not bool(server["cv_server"].any())
    assert TC.Pipeline("zsign_packed").init_server_state(64) is None
    cv = TC.Pipeline("cv(eta=0.5,beta=0.25)|zsign").transforms[0]
    assert (cv.eta, cv.beta) == (0.5, 0.25)
    assert TC.Pipeline("cv|zsign_packed").wire_bits_per_coord == 1.0


def test_cv_refusals_and_compositions():
    with pytest.raises(ValueError, match="collision"):
        TC.Pipeline("cv|cv|zsign_packed")
    comp = TC.Pipeline("cv|zsign_packed")
    with pytest.raises(ValueError, match="server"):
        comp.encode_batch(TN.client_keys(TN.prng_key(0), 0, 1),
                          torch.ones((1, TILE)), 64, comp.init_state(
                              64, lead=(1,)))
    # the count-law decodes are refused under cv with the reference's text
    for later in ("cv|zsign(agg=vote)", "cv|zsign_packed(agg=median)",
                  "cv|topk(frac=0.1,agg=coord)"):
        with pytest.raises(ValueError, match="control variates") as jerr:
            JC.Pipeline(later)
        with pytest.raises(ValueError, match="control variates") as terr:
            TC.Pipeline(later)
        assert str(terr.value) == str(jerr.value)
    for ok in ["cv|zsign", "cv|zsign_packed", "cv|dense",
               "ef|cv|zsign_packed", "dp(clip=1.0,noise=0.0)|cv|zsign"]:
        assert TC.Pipeline(ok).spec == JC.Pipeline(ok).spec.replace(
            "encode_backend=pallas", "encode_backend=cuda")
        assert TC.Pipeline(ok)._has_server_state


def test_cv_dense_update_law():
    """cv|dense: q = p - eta*(c_i - c) is the payload, c_i += beta*q, and
    the server adds beta*(n_live/N)*g_dec, all as the reference computes
    them (int32 patterns)."""
    d, eta, beta = 32, 0.5, 0.25
    spec = f"cv(eta={eta},beta={beta})|dense"
    rng = np.random.RandomState(0)
    p, ci, c, g = (rng.randn(d).astype(np.float32) for _ in range(4))
    jc, tc = JC.Pipeline(spec), TC.Pipeline(spec)
    jenc, jst = jc.encode(jax.random.PRNGKey(0), jnp.asarray(p),
                          {"cv": jnp.asarray(ci)},
                          server={"cv_server": jnp.asarray(c)})
    tenc, tst = tc.encode_batch(
        TN.client_keys(TN.prng_key(0), 0, 1),
        torch.from_numpy(p[None].copy()), d,
        {"cv": torch.from_numpy(ci[None].copy())},
        server={"cv_server": torch.from_numpy(c)})
    np.testing.assert_array_equal(_i32(tenc[0].numpy()), _i32(jenc))
    np.testing.assert_array_equal(_i32(tst["cv"][0].numpy()),
                                  _i32(jst["cv"]))
    jsrv = jc.update_server({"cv_server": jnp.asarray(c)}, jnp.asarray(g),
                            jnp.float32(3.0), 8.0)
    tsrv = tc.update_server({"cv_server": torch.from_numpy(c.copy())},
                            torch.from_numpy(g), torch.tensor(3.0), 8.0)
    np.testing.assert_array_equal(_i32(tsrv["cv_server"].numpy()),
                                  _i32(jsrv["cv_server"]))


def test_ef_cv_composition_residual_law():
    """ef|cv over the lossless dense codec: the residual closes over the
    cv-corrected input, so it is exactly zero while the variate moves."""
    d = 32
    comp = TC.Pipeline("ef|cv(eta=0.5,beta=1.0)|dense")
    rng = np.random.RandomState(1)
    p, r0, ci, c = (rng.randn(d).astype(np.float32) for _ in range(4))
    enc, new = comp.encode_batch(
        TN.client_keys(TN.prng_key(0), 0, 1),
        torch.from_numpy(p[None].copy()), d,
        {"ef": torch.from_numpy(r0[None].copy()),
         "cv": torch.from_numpy(ci[None].copy())},
        server={"cv_server": torch.from_numpy(c)})
    q = (p + r0) - np.float32(0.5) * (ci - c)
    np.testing.assert_array_equal(enc[0].numpy(), q)
    assert not new["ef"].any()
    np.testing.assert_array_equal(new["cv"][0].numpy(), ci + q)


# ---------------------------------------------------------------------------
# (e) consensus rounds against the reference, op by op
# ---------------------------------------------------------------------------

LEAVES = (("a", (10, 10)), ("b", (60,)), ("c", (40,)))
D, N, ROUNDS = 200, 10, 12
MASK = np.ones((1, N), np.float32)
MASK[0, [2, 7]] = 0.0


def _jloss(p, b):
    flat = jnp.concatenate([p[k].reshape(-1) for k, _ in LEAVES])
    return 0.5 * jnp.sum((flat - b["y"]) ** 2)


def _tloss(p, b):
    flat = torch.cat([p[k].reshape(-1) for k, _ in LEAVES])
    return 0.5 * torch.sum((flat - b["y"]) ** 2)


def _targets(G, local_steps, seed=0):
    t = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                     (G, N // G, D)))
    return np.repeat(t[:, :, None], local_steps, axis=2)


def _reference(spec, ys, mask, *, G=1, local_steps=1, cohort="vmap",
               sigmas=None, slr=2.0, rounds=ROUNDS):
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=N // G, client_groups=G,
                       local_steps=local_steps, client_lr=0.01,
                       server_lr=slr)
    step = JF.build_round_step(_jloss, comp, cfg, JF.RoundContext(
        cohort=cohort, dynamic_sigma=sigmas is not None))
    st = JF.init_server_state({k: jnp.zeros(s) for k, s in LEAVES}, cfg,
                              comp, jax.random.PRNGKey(1))
    for t in range(rounds):
        if sigmas is not None:
            st = st._replace(sigma=jnp.asarray(sigmas[t], jnp.float32))
        st, m = step(st, {"y": jnp.asarray(ys)}, jnp.asarray(mask))
    return st, m


def _port(spec, ys, mask, *, G=1, local_steps=1, cohort="vmap",
          sigmas=None, slr=2.0, rounds=ROUNDS):
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=N // G, client_groups=G,
                       local_steps=local_steps, client_lr=0.01,
                       server_lr=slr)
    step = TF.build_round_step(_tloss, comp, cfg, TF.RoundContext(
        cohort=cohort, dynamic_sigma=sigmas is not None))
    st = TF.init_server_state({k: torch.zeros(s) for k, s in LEAVES}, cfg,
                              comp, TN.prng_key(1),
                              host_state="feed=host" in cohort)
    for t in range(rounds):
        if sigmas is not None:
            st = st._replace(sigma=torch.tensor(sigmas[t],
                                                dtype=torch.float32))
        st, m = step(st, {"y": torch.from_numpy(ys)}, mask)
    return st, m


def _assert_same(js, jm, ts, tm):
    for k, _ in LEAVES:
        np.testing.assert_array_equal(_i32(ts.params[k].numpy()),
                                      _i32(js.params[k]), err_msg=k)
    for name, jt, tt in (("state", js.comp_state, ts.comp_state),
                         ("server", js.comp_server, ts.comp_server)):
        assert (jt is None) == (tt is None), name
        for k in (jt or {}):
            assert tuple(tt[k].shape) == tuple(jt[k].shape), k
            np.testing.assert_array_equal(_i32(tt[k].numpy()), _i32(jt[k]),
                                          err_msg=f"{name} {k}")
    assert float(tm.uplink_bits) == float(jm.uplink_bits) == (N - 2) * D
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-6)


def _assert_port_same(a, b):
    for k, _ in LEAVES:
        np.testing.assert_array_equal(_i32(a.params[k].numpy()),
                                      _i32(b.params[k].numpy()), err_msg=k)
    for ta, tb in ((a.comp_state, b.comp_state),
                   (a.comp_server, b.comp_server)):
        for k in (ta or {}):
            np.testing.assert_array_equal(_i32(ta[k].numpy()),
                                          _i32(tb[k].numpy()), err_msg=k)


#: a dynamic sigma that changes every round (the Plateau controller's role)
DYN_SIGMAS = [2.0 * 1.5 ** (t // 3) for t in range(ROUNDS)]
CONSENSUS = {
    "stosign": {"spec": "stosign", "slr": 2.0},
    "dp": {"spec": "dp(clip=1.0,noise=0.5)|zsign", "slr": 2.0},
    "sched_ef": {"spec": "sigma_sched(head=2.0,tail=0.5)|ef|zsign",
                 "slr": 1.0},
    "cv": {"spec": "cv|zsign_packed(sigma=2.0)", "slr": 2.0},
    "dynamic": {"spec": "zsign(z=1,sigma=2.0)", "slr": 2.0,
                "sigmas": DYN_SIGMAS},
}


@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("case", sorted(CONSENSUS))
def test_consensus_rounds_match_reference(case, local_steps, ref_norms):
    kw = dict(CONSENSUS[case])
    spec = kw.pop("spec")
    ys = _targets(1, local_steps)
    js, jm = _reference(spec, ys, MASK, local_steps=local_steps, **kw)
    ts, tm = _port(spec, ys, MASK, local_steps=local_steps, **kw)
    if case == "sched_ef" and local_steps == 2:
        # under lax.scan XLA contracts the reference's local step into a
        # multiply-add, which moves the pseudo-gradient by an ulp; the EF
        # residual carries it (tests/test_torch_efsign.py): the EF rule
        for k, _ in LEAVES:
            np.testing.assert_allclose(ts.params[k].numpy(),
                                       np.asarray(js.params[k]), rtol=0,
                                       atol=1e-7)
        e_ref = np.asarray(js.comp_state["ef"])
        np.testing.assert_allclose(ts.comp_state["ef"].numpy(), e_ref,
                                   rtol=0, atol=1e-6 * np.abs(e_ref).max())
    else:
        _assert_same(js, jm, ts, tm)
    if case == "cv":
        assert ts.comp_server["cv_server"].any()
        assert not ts.comp_state["cv"][0, [2, 7]].any()   # dead clients
    if case == "dynamic":
        assert float(ts.sigma) == np.float32(DYN_SIGMAS[-1])


@pytest.mark.parametrize("case", ["stosign", "dp", "sched_ef"])
def test_consensus_own_norms_within_rule(case):
    """With the port's own norms and EF scale: every round, fed the same
    start state, the port's step moves each coordinate like the
    reference's except where a wire bit flips under the flip rule; over the
    whole run the params stay within a few sign steps of the reference at
    a handful of coordinates, and within 1e-7 elsewhere."""
    kw = dict(CONSENSUS[case])
    spec = kw.pop("spec")
    ys = _targets(1, 1)
    js, _ = _reference(spec, ys, MASK, **kw)
    ts, _ = _port(spec, ys, MASK, **kw)
    jp = np.concatenate([np.asarray(js.params[k]).ravel() for k, _ in LEAVES])
    tp = np.concatenate([ts.params[k].numpy().ravel() for k, _ in LEAVES])
    off = np.abs(tp - jp) > 1e-7
    print(f"{case}: {int(off.sum())} of {D} coordinates off after "
          f"{ROUNDS} rounds")
    assert off.sum() <= D // 100
    if case == "sched_ef":
        e_ref = np.asarray(js.comp_state["ef"])
        np.testing.assert_allclose(ts.comp_state["ef"].numpy(), e_ref,
                                   rtol=0, atol=1e-6 * np.abs(e_ref).max())


# ---------------------------------------------------------------------------
# (d, cont.) the SCAFFOLD bookkeeping identity, first round = plain codec
# ---------------------------------------------------------------------------

def test_cv_scaffold_bookkeeping_identity():
    """c_{t+1} - c_t == (1/N) * sum_i (c_i,t+1 - c_i,t) every round under
    partial participation: exact for the dense codec up to the f32 sum
    order, f32-close for the sign mean law."""
    for spec, atol in (("cv|dense", 1e-7),
                       ("cv(eta=0.1,beta=0.5)|zsign_packed(z=1,sigma=0.4)",
                        1e-7)):
        comp = TC.Pipeline(spec)
        cfg = TF.FedConfig(n_clients=N, client_lr=0.01, server_lr=0.3)
        step = TF.build_round_step(_tloss, comp, cfg)
        st = TF.init_server_state({k: torch.zeros(s) for k, s in LEAVES},
                                  cfg, comp, TN.prng_key(1))
        ys = torch.from_numpy(_targets(1, 1))
        for _ in range(4):
            prev_rows = st.comp_state["cv"].clone()
            prev_c = st.comp_server["cv_server"].clone()
            st, _ = step(st, {"y": ys}, MASK)
            lhs = (st.comp_server["cv_server"] - prev_c).numpy()
            rhs = (st.comp_state["cv"] - prev_rows).sum(dim=(0, 1)).numpy()
            np.testing.assert_allclose(lhs, rhs / N, rtol=2e-5, atol=atol)
        assert not st.comp_state["cv"][0, [2, 7]].any()
        assert st.comp_state["cv"][0, [0, 1, 3]].abs().sum() > 0


def test_cv_round_one_matches_plain_codec():
    ys = _targets(1, 1)
    plain, pm = _port("zsign_packed(z=1,sigma=0.7)", ys, MASK, rounds=1)
    cv, cm = _port("cv|zsign_packed(z=1,sigma=0.7)", ys, MASK, rounds=1)
    for k, _ in LEAVES:
        assert torch.equal(plain.params[k], cv.params[k])
    assert float(pm.loss) == float(cm.loss)
    assert float(pm.uplink_bits) == float(cm.uplink_bits)


# ---------------------------------------------------------------------------
# (f) cv under every cohort plan
# ---------------------------------------------------------------------------

CV_SPEC = "cv|zsign_packed(z=1,sigma=2.0)"


@pytest.mark.parametrize("G,cohort", [(1, "stream(shard=1)"),
                                      (1, "stream(shard=3)"),
                                      (1, "stream(shard=8)"),
                                      (1, "stream(shard=3,feed=host)"),
                                      (2, "vmap")])
def test_cv_plans_match_vmap_and_reference(G, cohort):
    ys = _targets(1, 1, seed=4)
    mask = MASK
    ts, tm = _port(CV_SPEC, ys.reshape(G, N // G, 1, D), mask.reshape(G, -1),
                   G=G, cohort=cohort, rounds=4)
    tv, _ = _port(CV_SPEC, ys, mask, rounds=4)
    for k in ts.comp_state:
        ts.comp_state[k] = ts.comp_state[k].reshape(1, N, D)
    _assert_port_same(ts, tv)
    js, jm = _reference(CV_SPEC, ys.reshape(G, N // G, 1, D),
                        mask.reshape(G, -1), G=G, cohort=cohort, rounds=4)
    js = js._replace(comp_state={k: np.asarray(v).reshape(1, N, D)
                                 for k, v in js.comp_state.items()})
    _assert_same(js, jm, ts, tm)


# ---------------------------------------------------------------------------
# (g) the launcher on the CPU
# ---------------------------------------------------------------------------

CLI = [["--compressor", "stosign"], ["--compressor", "dpgauss"],
       ["--plateau"],
       ["--pipeline", "dp(clip=1.0,eps=2.0)|zsign_packed"],
       ["--pipeline", "cv|zsign_packed(sigma=0.01)", "--cohort",
        "stream(shard=2)"],
       ["--pipeline", "sigma_sched(head=2.0,tail=0.5)|zsign(sigma=0.01)"]]


@pytest.mark.parametrize("flags", CLI, ids=lambda f: " ".join(f))
def test_train_run_cpu_noise_controls(flags, capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--clients", "3",
                          "--seq-len", "16"] + flags)
    history = TT.run(args)
    d = TW.tree_spec(t_build(t_get_arch("qwen2_0_5b").reduced().model)
                     .init(torch.Generator().manual_seed(0), "cpu")).n_coords
    bits = 32 if "dpgauss" in flags else 1
    assert len(history) == 2
    for m in history:
        assert float(m.uplink_bits) == 3 * d * bits
        assert np.isfinite(float(m.loss))
    assert "round,loss" in capsys.readouterr().out


def test_available_is_reference_less_item_9():
    # item 9 (qsgd, topk) is ported: the port builds every reference name
    assert TC.available() == JC.available()
    parser_choices = TT.parse_args(["--arch", "x"]).compressor
    assert parser_choices == "zsign"


#: every dp, cv, sigma_sched and stosign spec string of the reference's
#: tests/test_pipeline.py, tests/test_control_variates.py and
#: tests/test_sigma_schedule.py
REFERENCE_SPECS = [
    "dp(clip=1.5,noise=0.25)|zsign", "dp(clip=1.0,noise=0.5)|zsign_packed",
    "stosign", "ef|stosign", "dp(noise=0.5)|zsign(sigma=0.5)",
    "dp(eps=2.0)|zsign", "dp(clip=1.0,noise=0.5)|zsign(z=inf)",
    "dp(clip=1.0,noise=0.5)|stosign",
    "dp(clip=1.0,eps=2.0,steps=100)|zsign",
    "dp(clip=1.0,eps=2.0,steps=100)|dense",
    "dp(clip=1.0,eps=2.0,noise=0.3)|zsign", "dp(clip=1.0)|dense",
    "zsign(sigma_mode=nope)",
    "cv|zsign_packed", "cv(eta=0.5,beta=0.25)|zsign", "cv|zsign(agg=vote)",
    "cv|zsign_packed(agg=median)", "cv|zsign(agg=trimmed(f=1))",
    "cv|topk(frac=0.1,agg=coord)", "cv|zsign", "cv|qsgd", "cv|dense",
    "cv|topk(frac=0.1)", "ef|cv|zsign_packed",
    "dp(clip=1.0,noise=0.0)|cv|zsign", "cv|cv|zsign_packed",
    "cv(eta=0.1,beta=0.5)|zsign_packed(z=1,sigma=0.7)",
    "cv(eta=0.1,beta=0.5)|zsign_packed(z=1,sigma=0.4)",
    "cv|zsign_packed(z=1,sigma=0.5)", "ef|cv(eta=0.5,beta=1.0)|dense",
    "cv(eta=0.1,beta=0.5)|zsign_packed(z=1,sigma=0.5)",
] + [bad for bad, _ in SCHED_BAD] + SCHED_OK + [
    "sigma_sched|topk(frac=0.2)", "sigma_sched|qsgd",
    "sigma_sched(head=2.0,tail=0.5)|zsign(z=1,sigma=0.1)",
    "sigma_sched(head=2.0,tail=0.5)|zsign_packed",
    "sigma_sched(head=2.0,tail=0.5)|qsgd(s=2)",
    "sigma_sched(head=2.0,tail=0.5)|topk(frac=0.3)",
    "sigma_sched(head=2.0,tail=0.5)|dense",
    "sigma_sched(head=2,tail=2)|zsign(z=1,sigma=0.2)",
    "sigma_sched(head=4,tail=0.25)|zsign(z=1,sigma=0.3)",
    "sigma_sched(head=2,tail=2)|zsign(z=1,sigma=0.3)",
    "sigma_sched|zsign_packed"]


@pytest.mark.parametrize("spec", REFERENCE_SPECS)
def test_reference_spec_builds_or_raises_the_same(spec):
    """The port builds what the reference builds (the same canonical
    spec) and raises the reference's ValueError text where it raises
    (qsgd, topk and the robust agg= modes included)."""
    try:
        jp, jerr = JC.Pipeline(spec), None
    except ValueError as e:
        jp, jerr = None, e
    if jerr is not None:
        with pytest.raises(ValueError) as terr:
            TC.Pipeline(spec)
        assert str(terr.value) == str(jerr)
    else:
        assert TC.Pipeline(spec).spec == jp.spec.replace(
            "encode_backend=pallas", "encode_backend=cuda")
