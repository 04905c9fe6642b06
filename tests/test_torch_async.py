"""The port's async deadline rounds against the reference
(repro.core.context.RoundModePolicy, repro.fed.async_server): each case of
the reference's tests/test_async_server.py, held on the same numpy inputs.

(a) The round-mode and latency grammars: the same fields, and the same
    error texts for bad specs.
(b) The latency draws (numpy RandomState in both), staleness lags,
    partitions and simulated close times: equal as arrays.
(c) Rounds of the consensus problem (n = 8, d = 64, loss 0.5*|x - y|^2,
    whose gradient is exact in both frameworks): zero latency is
    bit-identical within the port to the sync stream(feed=host) round
    (params, residuals, loss, participation, uplink bits, shard_clients),
    dead clients included; deadline drops, poly and cutoff stale folds and
    the adversary against the reference's async driver. zsign_packed:
    params bit-identical to the reference. EF: its scale mean(|p|) sums in
    another order than XLA's (tests/test_torch_efsign.py), so params agree
    to 1e-7 and residuals to 1e-6 of their largest magnitude;
    participation and uplink bits are equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import context as JX
from repro.core import fedavg as JF
from repro.fed import async_server as JA
from repro_torch.core import compression as TC
from repro_torch.core import context as TX
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.fed import async_server as TA
from repro_torch.launch import train as TT

torch.set_num_threads(1)


def _i32(a):
    return np.asarray(a).view(np.int32)


def _same_outcome(fn_ref, fn_port, arg):
    """Both raise ValueError with one text, or both return."""
    try:
        want = fn_ref(arg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_port(arg)
        assert str(got.value) == str(e)
        return None, None
    return want, fn_port(arg)


# ---------------------------------------------------------------------------
# (a) grammars
# ---------------------------------------------------------------------------

MODES = ["sync", "async(deadline=2.5)",
         "async(deadline=1.0,min_clients=4,staleness=poly(0.5))",
         "async(deadline=1,staleness=cutoff(3))", " async(deadline=3) ",
         "nope", "async", "async()", "async(deadline=0)",
         "async(deadline=-1)", "sync(deadline=1)",
         "async(deadline=1,staleness=exp(2))", "async(deadline=1,frac=2)",
         "async(deadline=1", "async(deadline)",
         "async(deadline=1,staleness=poly(0.5)",
         "async(deadline=1,min_clients=-2)"]


@pytest.mark.parametrize("spec", MODES)
def test_round_mode_policy_parse(spec):
    want, got = _same_outcome(JX.RoundModePolicy.parse,
                              TX.RoundModePolicy.parse, spec)
    if want is not None:
        assert (got.mode, got.deadline, got.min_clients, got.staleness,
                got.staleness_arg) == (want.mode, want.deadline,
                                       want.min_clients, want.staleness,
                                       want.staleness_arg)
        assert TX.RoundModePolicy.parse(got) is got
    for ctx_kw in [dict(round_mode="async(deadline=0)"),
                   dict(latency="const(t=1)"),
                   dict(round_mode="async(deadline=1)", latency="warp")]:
        with pytest.raises(ValueError) as e_ref:
            JX.RoundContext(**ctx_kw)
        with pytest.raises(ValueError) as e_port:
            TX.RoundContext(**ctx_kw)
        assert str(e_port.value) == str(e_ref.value)
    TX.RoundContext(round_mode="async(deadline=1)", latency="const(t=1)")


def test_stale_weight_closed_form():
    for spec in ["async(deadline=1,staleness=poly(0.7))",
                 "async(deadline=1,staleness=cutoff(2))",
                 "async(deadline=1)", "sync"]:
        j, t = JX.RoundModePolicy.parse(spec), TX.RoundModePolicy.parse(spec)
        for s in range(6):
            assert t.stale_weight(s) == j.stale_weight(s)
    poly = TX.RoundModePolicy.parse("async(deadline=1,staleness=poly(0.7))")
    assert poly.stale_weight(2) == pytest.approx(3.0 ** -0.7)
    cut = TX.RoundModePolicy.parse("async(deadline=1,staleness=cutoff(2))")
    assert [cut.stale_weight(s) for s in [0, 1, 2, 3]] == [1.0, 1.0, 1.0, 0.0]


LATENCIES = ["zero", "linear(base=0.5,step=0.25,seed=3)",
             "lognormal(median=2,sigma=1.5,fail=0.1)", "pareto(xm=1,alpha=2)",
             "const(t=1.5)", "lognormal(median=1,sigma=1,fail=0.2,seed=9)",
             "pareto(xm=0.5,alpha=1.2,fail=0.3,seed=4)",
             "warp", "const(q=1)", "const(t=1", "linear(base)",
             "lognormal(fail=1.5)", "pareto(alpha=0)", "const(t=x)"]


@pytest.mark.parametrize("spec", LATENCIES)
def test_parse_latency(spec):
    want, got = _same_outcome(JA.parse_latency, TA.parse_latency, spec)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert TA.parse_latency(got) is got


@pytest.mark.parametrize("spec", LATENCIES[:7])
def test_latency_model_deterministic(spec):
    j, t = JA.parse_latency(spec), TA.parse_latency(spec)
    for r in (0, 3, 4):
        np.testing.assert_array_equal(t.sample(r, 64), j.sample(r, 64))
    np.testing.assert_array_equal(t.sample(3, 64), t.sample(3, 64))
    m = TA.parse_latency("lognormal(median=1,sigma=1,fail=0.2,seed=9)")
    assert not np.array_equal(m.sample(3, 64), m.sample(4, 64))
    assert np.any(np.isinf(m.sample(3, 64)))
    np.testing.assert_array_equal(
        TA.parse_latency("linear(base=1,step=2)").sample(0, 4),
        [1., 3., 5., 7.])


# ---------------------------------------------------------------------------
# (b) the deadline partition
# ---------------------------------------------------------------------------

def test_staleness_rounds_closed_form():
    lat = np.array([0.2, 1.0, 1.1, 2.0, 2.1, 5.0, np.inf])
    for dl in (1.0, 0.7, 2.5):
        np.testing.assert_array_equal(TA.staleness_rounds(lat, dl),
                                      JA.staleness_rounds(lat, dl))
    np.testing.assert_array_equal(
        TA.staleness_rounds(np.array([1.1, 2.0, 2.1, 5.0, np.inf]), 1.0),
        [1., 1., 2., 4., np.inf])


def _same_partition(spec, lat, live):
    got = TA.partition_round(TX.RoundModePolicy.parse(spec), lat, live)
    want = JA.partition_round(JX.RoundModePolicy.parse(spec), lat, live)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    return got


def test_partition_round_min_clients_extends_deadline():
    spec = "async(deadline=0.5,min_clients=4)"
    on_time, _, _, close = _same_partition(spec, np.arange(8.0),
                                           np.ones(8, bool))
    np.testing.assert_array_equal(on_time, [1, 1, 1, 1, 0, 0, 0, 0])
    assert close == 3.0
    on_time, _, _, _ = _same_partition(spec, np.arange(8.0),
                                       np.arange(8) >= 2)
    assert int(np.sum(on_time)) == 4 and not on_time[:2].any()
    rs = np.random.RandomState(0)
    for spec in ["async(deadline=1.5,min_clients=6,staleness=poly(0.5))",
                 "async(deadline=1.0,staleness=cutoff(2))",
                 "async(deadline=0.8,min_clients=30,staleness=poly(2))"]:
        lat = np.where(rs.rand(20) < 0.2, np.inf, rs.lognormal(0, 1, 20))
        _same_partition(spec, lat, rs.rand(20) > 0.1)


def test_partition_round_drops_failed_clients():
    on_time, s, w, _ = _same_partition("async(deadline=2,staleness=poly(1))",
                                       np.array([0.5, np.inf, 3.0, 1.0]),
                                       np.ones(4, bool))
    np.testing.assert_array_equal(on_time, [1, 0, 0, 1])
    assert w[1] == 0.0 and s[1] == 0
    assert s[2] == 1 and w[2] == pytest.approx(0.5)


def test_simulate_close_times_beats_sync_barrier_on_heavy_tail():
    for spec, lat, rounds, total in [
            ("async(deadline=2.0,staleness=poly(0.5))",
             "lognormal(median=1.0,sigma=1.0,seed=3)", 50, 64),
            ("async(deadline=1.0,min_clients=5)",
             "pareto(xm=0.5,alpha=1.5,fail=0.1,seed=2)", 20, 16),
            ("async(deadline=2.0,staleness=poly(0.5))", "zero", 3, 8)]:
        got = TA.simulate_close_times(TX.RoundModePolicy.parse(spec),
                                      TA.parse_latency(lat), rounds, total)
        want = JA.simulate_close_times(JX.RoundModePolicy.parse(spec),
                                       JA.parse_latency(lat), rounds, total)
        np.testing.assert_array_equal(got, want)
    pol = TX.RoundModePolicy.parse("async(deadline=2.0,staleness=poly(0.5))")
    ct = TA.simulate_close_times(
        pol, TA.parse_latency("lognormal(median=1.0,sigma=1.0,seed=3)"),
        rounds=50, total=64)
    assert np.percentile(ct[:, 0], 90) <= pol.deadline + 1e-12
    assert np.percentile(ct[:, 0], 90) < 0.5 * np.percentile(ct[:, 1], 90)
    np.testing.assert_array_equal(
        TA.simulate_close_times(pol, TA.parse_latency("zero"), 3, 8), 0.0)


# ---------------------------------------------------------------------------
# (c) rounds: the async driver against the sync round and the reference
# ---------------------------------------------------------------------------

def _ys(n, d, seed=5):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (1, n, 1, d)))


def _reference(spec, ctx_kw, ys, mask, rounds):
    n = ys.shape[1]
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=n, client_lr=0.01, server_lr=0.3)
    step = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), comp, cfg,
        JX.RoundContext(**ctx_kw))
    st = JF.init_server_state({"x": jnp.zeros(ys.shape[-1])}, cfg, comp,
                              jax.random.PRNGKey(1))
    ms = []
    for _ in range(rounds):
        st, m = step(st, {"y": jnp.asarray(ys)}, jnp.asarray(mask))
        ms.append(m)
    return st, ms


def _port(spec, ctx_kw, ys, mask, rounds):
    n = ys.shape[1]
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=n, client_lr=0.01, server_lr=0.3)
    step = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), comp, cfg,
        TX.RoundContext(**ctx_kw))
    st = TF.init_server_state({"x": torch.zeros(ys.shape[-1])}, cfg, comp,
                              TN.prng_key(1),
                              host_state="feed=host" in ctx_kw.get("cohort",
                                                                   ""))
    ms = []
    for _ in range(rounds):
        st, m = step(st, {"y": torch.from_numpy(ys)}, mask)
        ms.append(m)
    return st, ms


def _port_same(a, ma, b, mb):
    np.testing.assert_array_equal(_i32(a.params["x"].numpy()),
                                  _i32(b.params["x"].numpy()))
    for k in (a.comp_state or {}):
        np.testing.assert_array_equal(_i32(a.comp_state[k].numpy()),
                                      _i32(b.comp_state[k].numpy()))
    for x, y in zip(ma, mb):
        for f in ("loss", "participation", "uplink_bits", "shard_clients"):
            assert float(getattr(x, f)) == float(getattr(y, f)), f


def _against_reference(spec, js, jms, ts, tms):
    x = ts.params["x"].numpy()
    if spec.startswith("zsign"):
        np.testing.assert_array_equal(_i32(x), _i32(js.params["x"]))
    else:
        np.testing.assert_allclose(x, np.asarray(js.params["x"]), rtol=0,
                                   atol=1e-7)
    if js.comp_state is not None:
        e_ref = np.asarray(js.comp_state["ef"])
        e = ts.comp_state["ef"].numpy()
        assert e.shape == e_ref.shape
        np.testing.assert_allclose(e, e_ref, rtol=0,
                                   atol=1e-6 * np.abs(e_ref).max())
    for jm, tm in zip(jms, tms):
        assert float(tm.participation) == float(jm.participation)
        assert float(tm.uplink_bits) == float(jm.uplink_bits)
        assert int(tm.shard_clients) == int(jm.shard_clients)
        np.testing.assert_allclose(float(tm.loss), float(jm.loss),
                                   rtol=1e-5)


MASK8 = np.ones((1, 8), np.float32)
MASK8[0, [1, 4, 6]] = 0.0


@pytest.mark.parametrize("spec", ["zsign_packed(z=1,sigma=0.7)", "ef|zsign"])
@pytest.mark.parametrize("shard", [3, 8])
def test_async_zero_latency_bit_identical_to_sync(spec, shard):
    """Zero latency and a deadline covering every client: the async round
    IS the sync stream(feed=host) round, dead clients included."""
    ys = _ys(8, 64)
    sync_kw = dict(cohort=f"stream(shard={shard},feed=host)")
    async_kw = {**sync_kw, "round_mode": "async(deadline=1.0)"}
    ref, mref = _port(spec, sync_kw, ys, MASK8, 3)
    got, mgot = _port(spec, async_kw, ys, MASK8, 3)
    _port_same(ref, mref, got, mgot)
    js, jms = _reference(spec, async_kw, ys, MASK8, 3)
    _against_reference(spec, js, jms, got, mgot)


def test_async_deadline_drops_exactly_the_late_clients():
    """linear(base=0,step=1), deadline 2.5, staleness none: clients 0..2 are
    on time and 3..7 never compute, as a sync round that masks them out."""
    ys = _ys(8, 64)
    kw = dict(cohort="stream(shard=3,feed=host)",
              round_mode="async(deadline=2.5)",
              latency="linear(base=0,step=1)")
    got, mg = _port("ef|zsign", kw, ys, np.ones((1, 8), np.float32), 3)
    mask = np.ones((1, 8), np.float32)
    mask[0, 3:] = 0.0
    ref, _ = _port("ef|zsign", dict(cohort="stream(shard=3,feed=host)"), ys,
                   mask, 3)
    np.testing.assert_array_equal(_i32(got.params["x"].numpy()),
                                  _i32(ref.params["x"].numpy()))
    np.testing.assert_array_equal(_i32(got.comp_state["ef"].numpy()),
                                  _i32(ref.comp_state["ef"].numpy()))
    assert [float(m.participation) for m in mg] == [3.0, 3.0, 3.0]
    js, jms = _reference("ef|zsign", kw, ys, np.ones((1, 8), np.float32), 3)
    _against_reference("ef|zsign", js, jms, got, mg)


@pytest.mark.parametrize("spec", ["ef|zsign", "zsign_packed(z=1,sigma=0.7)"])
def test_async_staleness_fold_matches_closed_form_law(spec):
    """poly(1.0): clients 3..5 arrive one round late at weight 1/2, 6..7 two
    rounds late at 1/3; participation is the folded weight, round by
    round, as the reference's f32 sum."""
    pol = TX.RoundModePolicy.parse("async(deadline=2.5,staleness=poly(1.0))")
    for i, s_want in [(3, 1), (4, 1), (5, 1), (6, 2), (7, 2)]:
        assert max(1, math.ceil(i / 2.5) - 1) == s_want
        assert pol.stale_weight(s_want) == pytest.approx(1 / (1 + s_want))
    ys = _ys(8, 64)
    kw = dict(cohort="stream(shard=3,feed=host)",
              round_mode="async(deadline=2.5,staleness=poly(1.0))",
              latency="linear(base=0,step=1)")
    ts, tms = _port(spec, kw, ys, np.ones((1, 8), np.float32), 3)
    want = [3.0, 3.0 + 3 * 0.5, 3.0 + 3 * 0.5 + 2 / 3]
    for m, w in zip(tms, want):
        assert float(m.participation) == pytest.approx(w, rel=1e-6)
    js, jms = _reference(spec, kw, ys, np.ones((1, 8), np.float32), 3)
    _against_reference(spec, js, jms, ts, tms)


def test_stale_fold_crosses_a_pending_block(monkeypatch):
    """10 EF clients in shards of 3 (12 slots: 4 rows pend after the shard
    pass) with every late client folding (poly): the stale one-row folds
    close an 8-row block partway through the stale list, and the rounds
    still match the reference."""
    steps = []
    real = TW._sign_fold_step

    def spy(packed, weights, acc, *a, **k):
        out = real(packed, weights, acc, *a, **k)
        steps.append((packed.shape[0], acc.pend_n, out.pend_n))
        return out

    monkeypatch.setattr(TW, "_sign_fold_step", spy)
    ys = _ys(10, 64, seed=7)
    kw = dict(cohort="stream(shard=3,feed=host)",
              round_mode="async(deadline=2.5,staleness=poly(1.0))",
              latency="linear(base=0,step=1)")
    mask = np.ones((1, 10), np.float32)
    ts, tms = _port("ef|zsign", kw, ys, mask, 4)
    # a one-row stale fold that closes a block: 7 pending rows -> 0
    assert (1, 7, 0) in steps
    js, jms = _reference("ef|zsign", kw, ys, mask, 4)
    _against_reference("ef|zsign", js, jms, ts, tms)


def test_async_cutoff_staleness_keeps_late_payloads_whole():
    """cutoff(2) folds late payloads at weight 1: participation recovers the
    full cohort, only delayed."""
    ys = _ys(8, 64)
    kw = dict(cohort="stream(shard=3,feed=host)",
              round_mode="async(deadline=2.5,staleness=cutoff(2))",
              latency="linear(base=0,step=1)")
    spec = "zsign_packed(z=1,sigma=0.7)"
    ts, tms = _port(spec, kw, ys, np.ones((1, 8), np.float32), 4)
    assert [float(m.participation) for m in tms] == [3.0, 6.0, 8.0, 8.0]
    js, jms = _reference(spec, kw, ys, np.ones((1, 8), np.float32), 4)
    _against_reference(spec, js, jms, ts, tms)
    # the 0/1-mask route (R1's add mode on a card), under the vmap plan
    kw = {**kw, "cohort": "vmap", "weights_are_mask": True}
    ts, tms = _port(spec, kw, ys, MASK8, 4)
    js, jms = _reference(spec, kw, ys, MASK8, 4)
    _against_reference(spec, js, jms, ts, tms)
    assert int(tms[0].shard_clients) == 0


def test_async_composes_with_adversary():
    """Dropout hits the mask before the latency partition, sign_flip
    corrupts the same bytes under sync and async; deterministic; and the
    reference's rounds under each attack."""
    ys = _ys(8, 64)
    ones = np.ones((1, 8), np.float32)
    kw = dict(cohort="stream(shard=3,feed=host)",
              round_mode="async(deadline=2.5,staleness=poly(1.0))",
              latency="linear(base=0,step=1)")
    for adv in ["sign_flip(f=2)", "dropout(f=3)"]:
        a, ma = _port("ef|zsign", {**kw, "adversary": adv}, ys, ones, 3)
        b, mb = _port("ef|zsign", {**kw, "adversary": adv}, ys, ones, 3)
        _port_same(a, ma, b, mb)
        js, jms = _reference("ef|zsign", {**kw, "adversary": adv}, ys, ones,
                             3)
        _against_reference("ef|zsign", js, jms, a, ma)
    sync_kw = dict(cohort="stream(shard=3,feed=host)",
                   adversary="sign_flip(f=2)")
    ref, mref = _port("ef|zsign", sync_kw, ys, ones, 3)
    got, mgot = _port("ef|zsign", {**sync_kw,
                                   "round_mode": "async(deadline=1.0)"},
                      ys, ones, 3)
    _port_same(ref, mref, got, mgot)


def test_async_poly_rejects_weights_are_mask_pipelines():
    ctx_kw = dict(round_mode="async(deadline=1,staleness=poly(0.5))",
                  weights_are_mask=True)
    with pytest.raises(ValueError) as e_ref:
        JF.build_round_step(lambda p, b: jnp.sum(p["x"]),
                            JC.Pipeline("zsign_packed(z=1,sigma=0.7)"),
                            JF.FedConfig(n_clients=8),
                            JX.RoundContext(**ctx_kw))
    with pytest.raises(ValueError, match="weights_are_mask") as e_port:
        TF.build_round_step(lambda p, b: torch.sum(p["x"]),
                            TC.Pipeline("zsign_packed(z=1,sigma=0.7)"),
                            TF.FedConfig(n_clients=8),
                            TX.RoundContext(**ctx_kw))
    assert str(e_port.value) == str(e_ref.value)
    # the scale-weighted EF pipeline keeps f32 weights: poly is allowed
    TF.build_round_step(lambda p, b: torch.sum(p["x"]),
                        TC.Pipeline("ef|zsign"), TF.FedConfig(n_clients=8),
                        TX.RoundContext(**ctx_kw))


@pytest.mark.parametrize("flags,part", [
    (["--round-mode", "async(deadline=1.0,staleness=cutoff(2))",
      "--latency", "linear(base=0.0,step=0.5)",
      "--cohort", "stream(shard=2,feed=host)"], [3.0, 5.0]),
    (["--pipeline", "ef|zsign", "--round-mode",
      "async(deadline=1.0,staleness=poly(0.5))",
      "--latency", "linear(base=0.0,step=0.5)"], None)])
def test_train_cli_async(flags, part, capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--clients", "5",
                          "--seq-len", "16"] + flags)
    steps = []
    history = TT.run(args, on_build=steps.append)
    assert len(history) == 2
    assert all(math.isfinite(float(m.loss)) for m in history)
    # the step the run built, whose queue holds the rows still late
    assert len(steps) == 1 and isinstance(steps[0].pending, dict)
    got = [float(m.participation) for m in history]
    if part is not None:
        assert got == part
    else:
        assert got[0] == 3.0 and got[1] == pytest.approx(3.0 + 2 * 2 ** -0.5)
    assert "round_mode=async" in capsys.readouterr().out
    # --debug-wire checks the sampler's 0/1 mask on the async driver too
    checked = TT.run(TT.parse_args(["--device", "cpu", "--arch",
                                    "qwen2_0_5b", "--reduced", "--rounds",
                                    "2", "--clients", "5", "--seq-len", "16",
                                    "--debug-wire"] + flags))
    assert [float(m.participation) for m in checked] == got


@pytest.mark.parametrize("ctx_kw", [
    dict(cohort="stream(shard=3,feed=host)"),
    dict(cohort="stream(shard=3,feed=host)",
         round_mode="async(deadline=1.0,staleness=cutoff(2))",
         latency="linear(base=0,step=1)")])
def test_debug_wire_checks_host_loop_masks(ctx_kw):
    """debug_wire holds the host-fed and async drivers to the 0/1 mask
    with the reference's message; a 0/1 mask passes unchanged."""
    ys = _ys(8, 64)
    on = dict(ctx_kw, debug_wire=True)
    a, ma = _port("zsign_packed(z=1,sigma=0.7)", on, ys, MASK8, 2)
    b, mb = _port("zsign_packed(z=1,sigma=0.7)",
                  dict(ctx_kw, debug_wire=False), ys, MASK8, 2)
    _port_same(a, ma, b, mb)
    half = MASK8.copy()
    half[0, 2] = 0.5
    with pytest.raises(ValueError) as e:
        _port("zsign_packed(z=1,sigma=0.7)", on, ys, half, 1)
    assert str(e.value) == TW.MASK_MEMBERSHIP_MSG
