"""The port's cohort plans against the reference (repro.core.fedavg,
repro.core.context, repro.core.wire, repro.fed.sampling).

(a) ``CohortPolicy.parse``, ``resolve_cohort`` and ``auto_shard_size``: the
    same fields, plans and errors as the reference.
(b) The partition-invariant f32 fold (``SignFoldAcc``): the port's LUT fold
    and R1's plain fold mode against the reference's ``_sign_fold_step`` +
    ``sign_fold_finalize``, for every split of 13 clients into up to 3
    shards, as int32 bit patterns (zero signs included).
(c) Rounds of the quickstart consensus problem (D=200, loss 0.5*|x - y|^2,
    whose gradient is exact in both frameworks) under ``stream(shard=K)``,
    ``feed=host`` and ``client_groups > 1``, against the reference's round
    run op by op under the same plan (its shard and group loops are
    ``lax.scan``s). zsign: params bit-identical. EF (``ef|zsign``): the
    scale mean(|p|) differs by an ulp or two between XLA and torch (see
    tests/test_torch_efsign.py), so params agree to 1e-7 and residuals to
    1e-6 of their largest magnitude; within the port every plan is
    bit-identical to its vmap plan, params and residuals. The dense
    ``identity`` wire sums its f32 rows with a matrix product, whose float
    order is torch's: params agree to 1e-6.
(d) Dead clients keep their residual rows and the wrapped padding rows of
    the last shard stay inert; ``shard_clients`` is the reference's.
(e) ``CohortSampler``: the reference's ``(idx, w)``, shard rows and device
    partitions for the same seed in all three tiers, and a streamed round
    with importance weights.
(f) The noise-free pack of the EF wire and of the dense path (E1 with
    z=None on a card): the reference's ``pack_flat`` bytes.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import context as JX
from repro.core import fedavg as JF
from repro.core import wire as JW
from repro.fed import sampling as JS
from repro_torch.core import compression as TC
from repro_torch.core import context as TX
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.fed import sampling as TS
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import train as TT

torch.set_num_threads(1)

D = 200


def _i32(a):
    return np.asarray(a).view(np.int32)


# ---------------------------------------------------------------------------
# (a) policy grammar and plan resolution
# ---------------------------------------------------------------------------

SPECS = ["auto", "vmap", "stream", "stream()", " stream(shard=16,unroll=2) ",
         "stream(shard=0)", "stream(shard=auto)", "stream(devices=auto)",
         "stream(shard=auto,devices=auto,unroll=2)", "stream(feed=host)",
         "stream(shard=8,feed=device)", "stream(shard=6,feed=host)",
         "stream(devices=1,shard=3)",
         # invalid in both packages
         "nope", "stream(shard=a)", "vmap(shard=2)", "stream(shard=2,unroll=0)",
         "stream(frac=2)", "stream(unroll=auto)", "vmap(devices=2)",
         "auto(feed=host)", "stream(feed=nope)", "stream(devices=2,feed=host)",
         "stream(shard=-1)", "stream(devices=-2)", "stream(shard)",
         "stream(shard=4", "stream(unroll=-3)"]


@pytest.mark.parametrize("spec", SPECS)
def test_cohort_policy_parse_matches_reference(spec):
    try:
        want = JX.CohortPolicy.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TX.CohortPolicy.parse(spec)
        assert str(got.value) == str(e)
        return
    got = TX.CohortPolicy.parse(spec)
    assert (got.mode, got.shard, got.unroll, got.devices, got.feed) == \
        (want.mode, want.shard, want.unroll, want.devices, want.feed)
    assert TX.CohortPolicy.parse(got) is got


@pytest.mark.parametrize("spec", ["stream(devices=2)",
                                  "stream(shard=4,devices=8)"])
def test_multi_device_stream_parses_and_resolves_as_in_reference(
        spec, monkeypatch):
    """stream(devices=D): the reference's fields; with one device (no
    torch.distributed group, one jax device) both packages refuse D > 1
    with the same text up to how to start D devices; with 8 (8 jax
    devices, a group of 8 ranks) both resolve to the same plans, devices
    clamped to the shard count."""
    want, got = JX.CohortPolicy.parse(spec), TX.CohortPolicy.parse(spec)
    assert (got.mode, got.shard, got.devices) == \
        (want.mode, want.shard, want.devices)
    assert TX.RoundContext(cohort=spec).cohort == spec
    with pytest.raises(ValueError) as je:
        JF.resolve_cohort(spec, 64, 494_032_768)
    with pytest.raises(ValueError) as te:
        TF.resolve_cohort(spec, 64, 494_032_768)
    head = f"cohort plan wants devices={want.devices} but only 1 are visible"
    assert str(je.value).startswith(head) and str(te.value).startswith(head)
    monkeypatch.setattr(jax, "device_count", lambda: 8)
    monkeypatch.setattr(TW, "rank_world", lambda group=None: (0, 8))
    for total in (1, 8, 10, 32, 64):
        for n_coords in (100, 1 << 20, 494_032_768):
            assert tuple(TF.resolve_cohort(spec, total, n_coords)) == \
                tuple(JF.resolve_cohort(spec, total, n_coords))


def test_cohort_constants_match_reference():
    for name in ("STREAM_AUTO_MIN_ELEMS", "STREAM_DEFAULT_SHARD",
                 "STREAM_SHARD_AUTO", "COHORT_DEVICES_AUTO",
                 "STREAM_SHARD_BUDGET_BYTES", "STREAM_SHARD_MIN",
                 "STREAM_SHARD_MAX", "COHORT_FEEDS", "COHORT_MODES"):
        assert getattr(TX, name) == getattr(JX, name), name


@pytest.mark.parametrize("policy", [
    "auto", "vmap", "stream", "stream(shard=4)", "stream(shard=64)",
    "stream(shard=auto)", "stream(devices=auto)", "stream(feed=host)",
    "stream(shard=5,unroll=3)", "stream(shard=auto,feed=host)"])
def test_resolve_cohort_matches_reference(policy):
    for total in (1, 8, 10, 32, 100, 4096):
        for n_coords in (0, 100, 1 << 14, 1 << 20, 494_032_768):
            want = JF.resolve_cohort(policy, total, n_coords)
            got = TF.resolve_cohort(policy, total, n_coords)
            assert tuple(got) == tuple(want), (policy, total, n_coords)
    assert TF.resolve_cohort("vmap", 8, 1) == TF.VMAP_PLAN


def test_auto_shard_size_matches_reference():
    for d in (0, 1, 100, 1 << 14, 1 << 20, 1 << 24, 494_032_768, 1 << 34):
        assert TF.auto_shard_size(d) == JF.auto_shard_size(d), d
    # qwen2-0.5B: 16 and 32 clients stream at 8 a shard
    plan = TF.resolve_cohort("auto", 32, 494_032_768)
    assert (plan.mode, plan.shard) == ("stream", 8)


# ---------------------------------------------------------------------------
# (b) the partition-invariant f32 fold
# ---------------------------------------------------------------------------

def _splits(n, parts):
    """Every split of n clients into 1..parts non-empty shards."""
    for k in range(1, parts + 1):
        for cuts in itertools.combinations(range(1, n), k - 1):
            b = (0,) + cuts + (n,)
            yield [b[i + 1] - b[i] for i in range(k)]


def _fold_weights(kind, n, rng):
    if kind == "random":
        return rng.randn(n).astype(np.float32)
    if kind == "zeros":                  # +0.0 and -0.0 weights only
        return np.where(rng.rand(n) < 0.5, 0.0, -0.0).astype(np.float32)
    if kind == "cancel":                 # +w, -w in every block
        w = rng.randn((n + 1) // 2).astype(np.float32)
        return np.stack([w, -w], 1).reshape(-1)[:n]
    # zero-weight first block (sums +-0.0) then random
    w = rng.randn(n).astype(np.float32)
    w[:8] = -0.0
    return w


@pytest.mark.parametrize("kind", ["random", "zeros", "cancel", "zero_block"])
def test_sign_fold_matches_reference_every_split(kind):
    n, nb = 13, 37
    rng = np.random.RandomState(len(kind))
    packed = rng.randint(0, 256, (n, nb)).astype(np.uint8)
    if kind == "cancel":
        packed[1::2] = packed[0::2][:n // 2]      # same bits, opposite w
    w = _fold_weights(kind, n, rng)
    one_shot = _i32(JW.unpack_sum(jnp.asarray(packed), jnp.asarray(w)))
    tp, tw = torch.from_numpy(packed), torch.from_numpy(w)
    n_splits = 0
    for split in _splits(n, 3):
        jacc = JW.sign_fold_init(nb)
        lut = TW.sign_fold_init(nb)
        r1 = TW.sign_fold_init(nb)
        lo = 0
        for k in split:
            jacc = JW.unpack_sum(jnp.asarray(packed[lo:lo + k]),
                                 jnp.asarray(w[lo:lo + k]), jacc)
            lut = TW.unpack_sum(tp[lo:lo + k], tw[lo:lo + k], lut)
            r1 = TO.sign_fold_step(tp[lo:lo + k], tw[lo:lo + k], r1)
            assert lut.pend_n == r1.pend_n == int(jacc.pend_n)
            lo += k
        want = _i32(JW.sign_fold_finalize(jacc))
        np.testing.assert_array_equal(want, one_shot)
        np.testing.assert_array_equal(
            _i32(TW.sign_fold_finalize(lut).numpy()), want)
        np.testing.assert_array_equal(
            _i32(TO.sign_fold_finalize(r1).numpy()), want)
        n_splits += 1
    assert n_splits == 1 + 12 + 66


def test_fold_through_compression_dispatch():
    """compression.sign_reduce routes a SignFoldAcc to the fold; the flat
    carry keeps the kernel route's ``acc + sum`` order."""
    rng = np.random.RandomState(3)
    packed = torch.from_numpy(rng.randint(0, 256, (11, 20)).astype(np.uint8))
    w = torch.from_numpy(rng.randn(11).astype(np.float32))
    acc = TW.sign_fold_init(20)
    for lo, hi in ((0, 3), (3, 10), (10, 11)):
        acc = TC.sign_reduce(packed[lo:hi], w[lo:hi], acc=acc)
    got = TC.sign_fold_finalize(acc)
    want = JW.unpack_sum(jnp.asarray(packed.numpy()), jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(_i32(got.numpy()), _i32(want))
    flat = torch.from_numpy(rng.randn(160).astype(np.float32))
    np.testing.assert_array_equal(
        _i32(TC.sign_reduce(packed, w, "cuda", acc=flat).numpy()),
        _i32((flat + TO.sign_reduce_plain(packed, w)).numpy()))


@pytest.mark.parametrize("weights", ["mask", "f32"])
def test_unpack_sum_dense_oracle(weights):
    rng = np.random.RandomState(7)
    packed = rng.randint(0, 256, (9, 16)).astype(np.uint8)
    w = (rng.randint(0, 2, 9) if weights == "mask"
         else rng.randn(9)).astype(np.float32)
    acc = rng.randn(128).astype(np.float32)
    want = JW.unpack_sum_dense(jnp.asarray(packed), jnp.asarray(w),
                               jnp.asarray(acc))
    got = TC.sign_reduce(torch.from_numpy(packed), torch.from_numpy(w),
                         "dense", acc=torch.from_numpy(acc))
    if weights == "mask":
        np.testing.assert_array_equal(_i32(got.numpy()), _i32(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (c) rounds under each plan, against the reference
# ---------------------------------------------------------------------------

def _targets(G, N, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (G, N, 1, D)))


def _reference(spec, G, N, cohort, ys, mask, rounds, slr, ctx_kw=None):
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=N, client_groups=G, client_lr=0.01,
                       server_lr=slr)
    step = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), comp, cfg,
        JF.RoundContext(cohort=cohort, **(ctx_kw or {})))
    st = JF.init_server_state({"x": jnp.zeros(D)}, cfg, comp,
                              jax.random.PRNGKey(1))
    for _ in range(rounds):
        st, m = step(st, {"y": jnp.asarray(ys)}, jnp.asarray(mask))
    return st, m


def _port(spec, G, N, cohort, ys, mask, rounds, slr, ctx_kw=None):
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=N, client_groups=G, client_lr=0.01,
                       server_lr=slr)
    step = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), comp, cfg,
        TF.RoundContext(cohort=cohort, **(ctx_kw or {})))
    st = TF.init_server_state({"x": torch.zeros(D)}, cfg, comp,
                              TN.prng_key(1))
    for _ in range(rounds):
        st, m = step(st, {"y": torch.from_numpy(ys)}, mask)
    return st, m


SPEC_SLR = {"zsign(z=1,sigma=2.0)": 2.0, "ef|zsign": 1.0,
            "ef|zsign(use_kernel=true)": 1.0, "identity": 1.0}


def _check(spec, js, jm, ts, tm):
    if spec.startswith("zsign"):
        np.testing.assert_array_equal(_i32(ts.params["x"].numpy()),
                                      _i32(js.params["x"]))
    else:
        atol = 1e-6 if spec == "identity" else 1e-7
        np.testing.assert_allclose(ts.params["x"].numpy(),
                                   np.asarray(js.params["x"]), rtol=0,
                                   atol=atol)
    if js.comp_state is not None:
        e_ref = np.asarray(js.comp_state["ef"])
        e = ts.comp_state["ef"]
        assert tuple(e.shape) == e_ref.shape
        np.testing.assert_allclose(e.numpy(), e_ref, rtol=0,
                                   atol=1e-6 * np.abs(e_ref).max())
    assert float(tm.uplink_bits) == float(jm.uplink_bits)
    assert int(tm.shard_clients) == int(jm.shard_clients)
    assert tm.shard_clients.dtype == torch.int32
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)


def _same_state(a, b):
    np.testing.assert_array_equal(_i32(a.params["x"].numpy()),
                                  _i32(b.params["x"].numpy()))
    if a.comp_state is not None:
        np.testing.assert_array_equal(_i32(a.comp_state["ef"].numpy()),
                                      _i32(b.comp_state["ef"].numpy()))


#: 10 clients, 2 of them dead
MASK10 = np.ones((1, 10), np.float32)
MASK10[0, [2, 7]] = 0.0


@pytest.mark.parametrize("shard", [1, 3, 8])
@pytest.mark.parametrize("spec", ["zsign(z=1,sigma=2.0)", "ef|zsign"])
def test_stream_rounds_match_reference(spec, shard):
    ys = _targets(1, 10)
    cohort = f"stream(shard={shard})"
    js, jm = _reference(spec, 1, 10, cohort, ys, MASK10, 4, SPEC_SLR[spec])
    ts, tm = _port(spec, 1, 10, cohort, ys, MASK10, 4, SPEC_SLR[spec])
    _check(spec, js, jm, ts, tm)
    assert int(tm.shard_clients) == shard
    # within the port the streamed round IS the vmap round, bit for bit
    tv, _ = _port(spec, 1, 10, "vmap", ys, MASK10, 4, SPEC_SLR[spec])
    _same_state(ts, tv)


@pytest.mark.parametrize("spec", ["zsign(z=1,sigma=2.0)", "ef|zsign",
                                  "ef|zsign(use_kernel=true)"])
def test_host_feed_matches_device_feed(spec):
    ys = _targets(1, 10, seed=2)
    host, hm = _port(spec, 1, 10, "stream(shard=3,feed=host)", ys, MASK10,
                     3, SPEC_SLR[spec])
    dev, dm = _port(spec, 1, 10, "stream(shard=3)", ys, MASK10, 3,
                    SPEC_SLR[spec])
    _same_state(host, dev)
    assert float(hm.loss) == float(dm.loss)
    js, jm = _reference(spec, 1, 10, "stream(shard=3,feed=host)", ys,
                        MASK10, 3, SPEC_SLR[spec])
    _check(spec, js, jm, host, hm)


@pytest.mark.parametrize("G,N", [(2, 5), (3, 4)])
@pytest.mark.parametrize("spec", ["zsign(z=1,sigma=2.0)", "ef|zsign",
                                  "ef|zsign(use_kernel=true)", "identity"])
def test_group_scan_matches_reference(spec, G, N):
    ys = _targets(G, N, seed=G)
    mask = np.ones((G, N), np.float32)
    mask[1, 1] = 0.0
    js, jm = _reference(spec, G, N, "vmap", ys, mask, 3, SPEC_SLR[spec])
    ts, tm = _port(spec, G, N, "vmap", ys, mask, 3, SPEC_SLR[spec])
    _check(spec, js, jm, ts, tm)
    # the same clients as one flat group
    flat, _ = _port(spec, 1, G * N, "vmap", ys.reshape(1, G * N, 1, D),
                    mask.reshape(1, -1), 3, SPEC_SLR[spec])
    if spec == "identity":
        np.testing.assert_allclose(ts.params["x"].numpy(),
                                   flat.params["x"].numpy(), rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(_i32(ts.params["x"].numpy()),
                                      _i32(flat.params["x"].numpy()))


def test_sequential_clients_and_streamed_groups():
    """``--clients 1 --groups 8`` (one client a group, E1 with n = 1) and a
    (2, 4) cohort under stream(shard=3) are the 8-client vmap round."""
    spec = "zsign(z=1,sigma=2.0)"
    ys = _targets(1, 8, seed=4)
    mask = np.ones((1, 8), np.float32)
    ref, _ = _port(spec, 1, 8, "vmap", ys, mask, 3, 2.0)
    seq, _ = _port(spec, 8, 1, "vmap", ys.reshape(8, 1, 1, D),
                   mask.reshape(8, 1), 3, 2.0)
    st, sm = _port(spec, 2, 4, "stream(shard=3)", ys.reshape(2, 4, 1, D),
                   mask.reshape(2, 4), 3, 2.0)
    _same_state(seq, ref)
    _same_state(st, ref)
    js, _ = _reference(spec, 8, 1, "vmap", ys.reshape(8, 1, 1, D),
                       mask.reshape(8, 1), 3, 2.0)
    np.testing.assert_array_equal(_i32(seq.params["x"].numpy()),
                                  _i32(js.params["x"]))


@pytest.mark.parametrize("spec", ["ef|zsign", "ef|zsign(use_kernel=true)"])
def test_stream_dead_clients_keep_residual_and_padding_is_inert(spec):
    """10 clients in shards of 4: the last shard wraps to clients 0 and 1
    under a zero mask. Dead clients keep their rows bit-exactly, live ones
    update, and the wrapped rows never leak: every row equals the vmap
    plan's, and the reference's within the EF tolerance."""
    n, d = 10, 24
    y = np.array(jax.random.normal(jax.random.PRNGKey(7), (1, n, 1, d)))
    mask0 = np.ones((1, n), np.float32)
    mask = mask0.copy()
    mask[0, [2, 9]] = 0.0
    outs = {}
    for cohort in ("vmap", "stream(shard=4)"):
        comp = TC.Pipeline(spec)
        cfg = TF.FedConfig(n_clients=n, client_lr=0.01, server_lr=0.3)
        step = TF.build_round_step(
            lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), comp, cfg,
            TF.RoundContext(cohort=cohort))
        st = TF.init_server_state({"x": torch.zeros(d)}, cfg, comp,
                                  TN.prng_key(1))
        st, _ = step(st, {"y": torch.from_numpy(y)}, mask0)
        before = st.comp_state["ef"].clone()
        st, m = step(st, {"y": torch.from_numpy(y)}, mask)
        after = st.comp_state["ef"]
        assert after.shape == (1, n, d) and float(m.participation) == n - 2
        for i in range(n):
            if i in (2, 9):
                np.testing.assert_array_equal(_i32(after[0, i].numpy()),
                                              _i32(before[0, i].numpy()))
            else:
                assert not torch.equal(after[0, i], before[0, i]), i
        outs[cohort] = _i32(after.numpy()).copy()
    np.testing.assert_array_equal(outs["vmap"], outs["stream(shard=4)"])


@pytest.mark.parametrize("G,N,cohort", [
    (1, 10, "vmap"), (1, 10, "stream(shard=4)"), (2, 5, "stream(shard=3)"),
    (1, 10, "stream(shard=auto)"), (2, 5, "vmap"), (1, 10, "auto")])
def test_shard_clients_matches_reference(G, N, cohort):
    ys = _targets(G, N)
    mask = np.ones((G, N), np.float32)
    _, jm = _reference("zsign(z=1,sigma=2.0)", G, N, cohort, ys, mask, 1,
                       2.0)
    _, tm = _port("zsign(z=1,sigma=2.0)", G, N, cohort, ys, mask, 1, 2.0)
    assert int(tm.shard_clients) == int(jm.shard_clients)
    assert tm.shard_clients.dtype == torch.int32


# ---------------------------------------------------------------------------
# (e) the massive-cohort sampler
# ---------------------------------------------------------------------------

def _samplers(tier, seed):
    total, k = 103, 17
    scores = np.random.RandomState(seed).rand(total) + 0.1
    kw = dict(total_clients=total, per_round=k, tier=tier, seed=seed,
              scores=scores if tier == "importance" else None, rate=0.2)
    return JS.CohortSampler(**kw), TS.CohortSampler(**kw)


@pytest.mark.parametrize("tier", ["uniform", "importance", "arrival"])
def test_cohort_sampler_matches_reference(tier):
    js, ts = _samplers(tier, seed=5)
    for _ in range(3):
        (ji, jw), (ti, tw) = js.sample(), ts.sample()
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(_i32(tw), _i32(jw))
        for shard in (1, 8, 13):
            for a, b in zip(js.iter_shards(ji, jw, shard),
                            ts.iter_shards(ti, tw, shard)):
                np.testing.assert_array_equal(_i32(b), _i32(a))
        for a, b in zip(js.device_partitions(ji, jw, shard=8, devices=3),
                        ts.device_partitions(ti, tw, shard=8, devices=3)):
            np.testing.assert_array_equal(_i32(b), _i32(a))
        np.testing.assert_array_equal(ts.dense(ti, tw, (1, 103)),
                                      js.dense(ji, jw, (1, 103)))
    state = {"ef": np.arange(103 * 4, dtype=np.float32).reshape(1, 103, 4)}
    for a, b in zip(js.partition_state_rows(state, shard=8, devices=2),
                    ts.partition_state_rows(state, shard=8, devices=2)):
        np.testing.assert_array_equal(b["ef"], a["ef"])
    np.testing.assert_array_equal(ts.mask((1, 103)), js.mask((1, 103)))


def test_cohort_sampler_validation_matches_reference():
    for kw in (dict(total_clients=4, per_round=5),
               dict(total_clients=4, per_round=2, tier="nope"),
               dict(total_clients=4, per_round=2, tier="importance"),
               dict(total_clients=4, per_round=2, tier="arrival", rate=0.0)):
        with pytest.raises(ValueError) as want:
            JS.CohortSampler(**kw)
        with pytest.raises(ValueError) as got:
            TS.CohortSampler(**kw)
        assert str(got.value) == str(want.value)


def test_importance_sampled_stream_round_matches_reference():
    """Importance weights (1/(k p_i), fractional) through stream(shard=5):
    the f32-weighted zsign reduce takes the SignFoldAcc fold. The weighted
    sum and the rest of the round are bit-identical to the reference."""
    total = 24
    ts = TS.CohortSampler(total_clients=total, per_round=9,
                          tier="importance", seed=9,
                          scores=np.random.RandomState(9).rand(total) + 0.1)
    mask = ts.mask((1, total))
    assert 0 < mask.sum() and len(set(mask[mask > 0].tolist())) > 1
    ys = _targets(1, total, seed=9)
    spec = "zsign(z=1,sigma=2.0)"
    js, jm = _reference(spec, 1, total, "stream(shard=5)", ys, mask, 2, 2.0)
    tst, tm = _port(spec, 1, total, "stream(shard=5)", ys, mask, 2, 2.0)
    _check(spec, js, jm, tst, tm)
    tv, _ = _port(spec, 1, total, "vmap", ys, mask, 2, 2.0)
    _same_state(tst, tv)


# ---------------------------------------------------------------------------
# (f) the noise-free pack, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [8192 + 5, 3 * 8192])
def test_noise_free_pack_is_reference_pack_flat(d):
    rng = np.random.RandomState(d)
    n = 3
    x = rng.randn(n, d).astype(np.float32)
    x[:, ::11] = 0.0
    x[:, 1::13] = -0.0
    d_pad = -(-d // 8192) * 8192
    x2d = torch.from_numpy(np.pad(x, ((0, 0), (0, d_pad - d))))
    keys = TN.client_keys(TN.prng_key(1), 0, n)
    payload, _ = TC.SignCodec(scale="mean_abs").encode_with_decode_batch(
        keys, x2d.clone(), d)
    dense = TC.SignCodec(encode_backend="reference").encode_with_decode_batch(
        keys, x2d.clone(), d)[0]
    for c in range(n):
        want = np.asarray(JW.pack_flat(jnp.asarray(x[c])))
        np.testing.assert_array_equal(payload["packed"][c, :want.size].numpy(),
                                      want)
        np.testing.assert_array_equal(dense[c, :want.size].numpy(), want)


@pytest.mark.parametrize("flags,shard", [
    (["--clients", "20", "--cohort", "stream(shard=6)"], 6),
    (["--clients", "4", "--groups", "3"], 0),
    (["--clients", "7", "--cohort", "stream(shard=3,feed=host)",
      "--pipeline", "ef|zsign(use_kernel=true)"], 3),
    (["--clients", "2", "--groups", "3", "--compressor", "efsign"], 0)])
def test_train_cli_cohort_plans(flags, shard, capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--local-steps", "1",
                          "--seq-len", "8"] + flags)
    seen = []
    history = TT.run(args, on_round=lambda t, b, a, m, s: seen.append(a))
    total = args.clients * args.groups
    d = TW.tree_spec(seen[0].params).n_coords
    for m in history:
        assert int(m.shard_clients) == shard
        assert float(m.participation) == total
        assert float(m.uplink_bits) == total * d
        assert np.isfinite(float(m.loss))
    if seen[-1].comp_state is not None:
        ef = seen[-1].comp_state["ef"]
        assert ef.shape == (args.groups, args.clients, d)
        assert all(bool(torch.any(ef[g, c] != 0))
                   for g in range(args.groups) for c in range(args.clients))
    assert "cohort=" in capsys.readouterr().out
