"""The robust sign laws (agg=vote|trimmed|median) and the wire adversary
in the port against the reference.

Everything here is integer-derived or counter-derived, so it is held bit
for bit: the (signed count, n_live) vote pair and its decode for every
law (n not a multiple of 8, dead clients, over-trim, all-dead
coordinates), its shard fold, the R1 route of the pair against the
popcount route, the spec grammar and its errors, the adversary's
selection, dropout mask and payload corruption (byte_corrupt and collude
bytes are the reference's draws), and consensus rounds of the robust
specs and of every attack against the reference run op by op. The plans
of the port (vmap, group scan, stream, host feed) give one result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import context as JCtx
from repro.core import wire as JW
from repro.fed import adversary as JA
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import context as TCtx
from repro_torch.core import dp as TD
from repro_torch.core import fedavg as TF
from repro_torch.core import wire as TW
from repro_torch.fed import adversary as TA
from repro_torch.launch import train as TT
from repro_torch.models.api import build_model as t_build
from torch_consensus import (MASK, N, assert_port_same, assert_state_equal,
                             flat_params, i32, port, ref_row_norms, reference,
                             targets)

torch.set_num_threads(1)


def _packed(n, nb, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, nb)).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# the vote pair and its decode
# ---------------------------------------------------------------------------

#: (n clients, bytes, dead clients): n not a multiple of 8, a dead client,
#: an all-dead cohort (every coordinate decodes to 0), and n + pad > 255
#: (the int32 accumulator)
PAIR_CASES = {"n13_dead": (13, 37, [2, 7]), "n5": (5, 16, []),
              "all_dead": (6, 8, list(range(6))), "n249": (249, 4, [0])}
#: every law; trimmed also over-trimmed (f = 50 > (n - 1) / 2)
LAWS = [("mean", 0), ("vote", 0), ("trimmed", 1), ("trimmed", 3),
        ("trimmed", 50), ("median", 0)]


def _mask(n, dead):
    m = np.ones(n, np.float32)
    m[dead] = 0.0
    return m


@pytest.mark.parametrize("law,f", LAWS)
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_vote_pair_and_decode_bit_exact(case, law, f):
    n, nb, dead = PAIR_CASES[case]
    packed, mask = _packed(n, nb, n * 31 + nb), _mask(n, dead)
    jpair = np.asarray(JW.vote_accumulator(jnp.asarray(packed),
                                           jnp.asarray(mask)))
    tpair = TW.vote_accumulator(torch.from_numpy(packed),
                                torch.from_numpy(mask))
    assert tpair.dtype == torch.int32 and tpair.shape == (2, 8 * nb)
    np.testing.assert_array_equal(tpair.numpy(), jpair)
    want = np.asarray(JW.vote_decode(jnp.asarray(jpair), law, f))
    got = TW.vote_decode(tpair, law, f).numpy()
    np.testing.assert_array_equal(i32(got), i32(want))
    if case == "all_dead":
        assert not got.any()


def test_vote_decode_edge_cases():
    pair = torch.tensor([[0, 3, -3, 1], [0, 3, 3, 3]], dtype=torch.int32)
    assert TW.vote_decode(pair, "vote").tolist() == [0.0, 1.0, -1.0, 1.0]
    over = TW.vote_decode(pair, "trimmed", 50)
    assert torch.equal(over, TW.vote_decode(pair, "median"))
    with pytest.raises(ValueError) as terr:
        TW.vote_decode(pair, "bogus")
    with pytest.raises(ValueError) as jerr:
        JW.vote_decode(jnp.asarray(pair.numpy()), "bogus")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n", [248, 249])
def test_mask_bit_count_accumulator_rule(n):
    """uint8 while n + pad <= 255, int32 beyond, as in the reference."""
    packed, mask = _packed(n, 5, n), _mask(n, [3])
    want = np.asarray(JW._mask_bit_count(jnp.asarray(packed),
                                         jnp.asarray(mask)))
    got = TW._mask_bit_count(torch.from_numpy(packed), torch.from_numpy(mask))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shard", [1, 7, 64])
def test_vote_pair_shard_fold_bit_exact(shard):
    n = 70
    packed = torch.from_numpy(_packed(n, 24, 9))
    mask = torch.from_numpy(_mask(n, [0, 13, 64]))
    acc = None
    for lo in range(0, n, shard):
        acc = TW.vote_accumulator(packed[lo:lo + shard], mask[lo:lo + shard],
                                  acc)
    one = np.asarray(JW.vote_accumulator(jnp.asarray(packed.numpy()),
                                         jnp.asarray(mask.numpy())))
    np.testing.assert_array_equal(acc.numpy(), one)


@pytest.mark.parametrize("n", [5, 13])
def test_r1_route_pair_equals_popcount_route(n):
    """The kernel route (R1's masked sign sum cast to int32; here R1's
    plain version, the tensors being on the CPU) equals the popcount route
    and the reference, with and without a carried pair."""
    packed = torch.from_numpy(_packed(n, 40, n))
    mask = torch.from_numpy(_mask(n, [1]))
    r1 = TC.vote_pair(packed, mask, "cuda")
    pop = TC.vote_pair(packed, mask, "torch")
    assert r1.dtype == pop.dtype == torch.int32
    assert torch.equal(r1, pop)
    assert torch.equal(TC.vote_pair(packed, mask, "cuda", r1),
                       TC.vote_pair(packed, mask, "torch", pop))
    np.testing.assert_array_equal(r1.numpy(), np.asarray(
        JW.vote_accumulator(jnp.asarray(packed.numpy()),
                            jnp.asarray(mask.numpy()))))


# ---------------------------------------------------------------------------
# the codec: grammar, errors, aggregate, decode
# ---------------------------------------------------------------------------

AGG_SPECS = ["zsign_packed(agg=vote)", "zsign(agg=trimmed(f=2))",
             "ef|zsign(agg=vote)", "zsign(agg=median)",
             "zsign(agg=trimmed,trim_f=3)", "stosign(agg=median)",
             "zsign(z=1,sigma=0.01,agg=trimmed(f=2))",
             "zsign(agg=trimmed(f=2),trim_f=2)", "ef|zsign",
             # the reference's refusals
             "zsign(agg=vote,scale=mean_abs)", "zsign(agg=bogus)",
             "zsign(agg=trimmed)", "zsign(agg=vote,trim_f=2)",
             "zsign(agg=trimmed(f=x))", "zsign(agg=trimmed(f=2),trim_f=3)",
             "zsign(agg=trimmed(f=2)", "zsign(agg=trimmed(f=2)))",
             "cv|zsign(agg=trimmed(f=1))"]


@pytest.mark.parametrize("spec", AGG_SPECS)
def test_agg_spec_builds_or_raises_like_reference(spec):
    try:
        jp, jerr = JC.Pipeline(spec), None
    except ValueError as e:
        jp, jerr = None, e
    if jerr is not None:
        with pytest.raises(ValueError) as terr:
            TC.Pipeline(spec)
        assert str(terr.value) == str(jerr)
        return
    tp = TC.Pipeline(spec)
    want = jp.spec.replace("encode_backend=pallas", "encode_backend=cuda")
    assert tp.spec == want
    assert TC.Pipeline(tp.spec).spec == tp.spec
    assert tp.codec.scale == jp.codec.scale


def test_robust_aggregate_refusal_and_fold_init():
    packed = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError) as terr:
        TC.Pipeline("zsign(agg=vote)").aggregate(packed, torch.ones(4), 64)
    with pytest.raises(ValueError) as jerr:
        JC.Pipeline("zsign(agg=vote)").aggregate(
            jnp.zeros((4, 8), jnp.uint8), jnp.ones(4), 64)
    assert str(terr.value) == str(jerr.value)
    ctx = TF.RoundContext(weights_are_mask=True)
    for spec in ("zsign(agg=vote)", "zsign(agg=trimmed(f=1))",
                 "ef|zsign(agg=median)"):
        comp = TC.Pipeline(spec).with_context(ctx)
        assert comp.fold_init(packed) is None
        acc = comp.zero_acc(packed, 60)
        assert acc.dtype == torch.int32 and acc.shape == (2, 64)
    assert isinstance(TC.Pipeline("zsign").fold_init(packed),
                      TW.SignFoldAcc)


@pytest.mark.parametrize("spec", ["zsign(z=1,sigma=0.3,agg=trimmed(f=1))",
                                  "zsign(agg=vote)",
                                  "zsign(z=inf,sigma=0.2,agg=median)",
                                  "zsign(z=1,sigma=0.3,agg=mean)"])
def test_robust_decode_sum_matches_reference(spec):
    n, nb = 9, 16
    packed, mask = _packed(n, nb, 4), _mask(n, [5])
    jc = JC.Pipeline(spec).with_context(JCtx.RoundContext(
        weights_are_mask=True))
    tc = TC.Pipeline(spec).with_context(TF.RoundContext(
        weights_are_mask=True))
    jagg = jc.aggregate(jnp.asarray(packed), jnp.asarray(mask), 8 * nb)
    tagg = tc.aggregate(torch.from_numpy(packed), torch.from_numpy(mask),
                        8 * nb)
    np.testing.assert_array_equal(i32(tagg.numpy()), i32(jagg))
    want = np.asarray(jc.decode_sum(jagg, jnp.asarray(8.0)))
    got = tc.decode_sum(tagg, torch.tensor(8.0)).numpy()
    np.testing.assert_array_equal(i32(got), i32(want))


def test_debug_wire_checks_the_mask(monkeypatch):
    good = torch.tensor([1.0, 0.0, 1.0])
    TW.check_mask_membership(good)
    with pytest.raises(ValueError, match="membership") as err:
        TW.check_mask_membership(torch.tensor([1.0, 0.5, 1.0]))
    assert str(err.value).startswith("debug_wire: mask violates")
    with pytest.raises(ValueError, match="membership"):
        TW.check_mask_membership(torch.tensor([1.0, -1.0]))
    monkeypatch.setenv("REPRO_DEBUG_WIRE", "1")
    assert TF.RoundContext().debug_wire and JCtx.RoundContext().debug_wire
    monkeypatch.setenv("REPRO_DEBUG_WIRE", "")
    assert not TF.RoundContext().debug_wire
    assert TC.Pipeline("zsign(agg=vote)").with_context(
        TF.RoundContext(debug_wire=True)).codec.debug_wire
    # the engine checks the round's host mask before anything runs
    ys = targets()
    bad = MASK.copy()
    bad[0, 0] = 0.5
    with pytest.raises(ValueError, match="membership"):
        port("zsign(agg=vote)", ys, bad, rounds=1, debug_wire=True)
    port("zsign(agg=vote)", ys, MASK, rounds=1, debug_wire=True)


# ---------------------------------------------------------------------------
# the adversary
# ---------------------------------------------------------------------------

ADV_ERRORS = ["sign_flip(f=0)", "warp(f=1)", "sign_flip(f=two)",
              "sign_flip(f=1,x=2)", "sign_flip(f=1", "sign_flip(f)",
              "byte_corrupt(f=1,p=0)", "sign_flip(f=1,rotate=maybe)",
              "sign_flip(f=1,every=0)"]


@pytest.mark.parametrize("spec", ADV_ERRORS)
def test_adversary_parse_errors_match_reference(spec):
    with pytest.raises(ValueError) as jerr:
        JA.parse_adversary(spec)
    with pytest.raises(ValueError) as terr:
        TA.parse_adversary(spec)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as terr:
        TCtx.RoundContext(adversary=spec)
    assert str(terr.value) == str(jerr.value)


def test_adversary_bind_and_unbound_refusals():
    for spec, total in (("sign_flip(f=9)", 8), ("collude(f=4)", 4),
                        ("sign_flip(f=1)", 0)):
        with pytest.raises(ValueError) as jerr:
            JA.parse_adversary(spec).bind(total)
        with pytest.raises(ValueError) as terr:
            TA.parse_adversary(spec).bind(total)
        assert str(terr.value) == str(jerr.value)
    assert TA.parse_adversary("dropout(f=8)").bind(8).total == 8
    assert TA.parse_adversary("none") is None
    with pytest.raises(ValueError) as jerr:
        JA.parse_adversary("sign_flip(f=2)")._selected(
            jnp.arange(4, dtype=jnp.int32), jnp.int32(0))
    with pytest.raises(ValueError) as terr:
        TA.parse_adversary("sign_flip(f=2)")._selected(torch.arange(4), 0)
    assert str(terr.value) == str(jerr.value)


SELECT_SPECS = ["collude(f=3,rotate=true,seed=9)", "sign_flip(f=4)",
                "sign_flip(f=4,every=3,start=6)", "dropout(f=5,rotate=true)",
                "byte_corrupt(f=2,every=2,start=1,rotate=true)"]


@pytest.mark.parametrize("spec", SELECT_SPECS)
def test_adversary_selection_and_drop_mask_match_reference(spec):
    ja, ta = JA.parse_adversary(spec).bind(16), \
        TA.parse_adversary(spec).bind(16)
    idx = np.arange(20)                  # 16 clients + 4 stream-pad slots
    mask = np.ones((2, 8), np.float32)
    mask[1, 3] = 0.0
    for r in range(12):
        want = np.asarray(ja._selected(jnp.asarray(idx, jnp.int32),
                                       jnp.int32(r)))
        got = ta._selected(torch.from_numpy(idx), r).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[16:].any()
        np.testing.assert_array_equal(
            ta.drop_mask(torch.from_numpy(mask), r).numpy(),
            np.asarray(ja.drop_mask(jnp.asarray(mask), jnp.int32(r))))


CORRUPT_KINDS = ["sign_flip(f=2)", "byte_corrupt(f=2,p=0.3,seed=4)",
                 "collude(f=3,rotate=true,seed=2)", "dropout(f=2)"]
PAYLOADS = ["packed", "packed_scale", "coo", "dense"]


def _payload(form, n, seed):
    rng = np.random.RandomState(seed)
    if form == "packed":
        return rng.randint(0, 256, (n, 4100)).astype(np.uint8)
    if form == "packed_scale":
        return {"packed": rng.randint(0, 256, (n, 64)).astype(np.uint8),
                "scale": rng.rand(n).astype(np.float32)}
    if form == "coo":
        return {"values": rng.randn(n, 7).astype(np.float32),
                "indices": rng.randint(0, 99, (n, 7)).astype(np.int32)}
    return rng.randn(n, 33).astype(np.float32)


def _tree(x, fn):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


@pytest.mark.parametrize("form", PAYLOADS)
@pytest.mark.parametrize("spec", CORRUPT_KINDS)
def test_adversary_corrupt_matches_reference(spec, form):
    """Every kind on every payload form, two rounds, clients at global
    offsets 6..10 (a shard) of 12: the same bytes or values (byte_corrupt
    and collude are the reference's draws), or the same ValueError."""
    ja, ta = JA.parse_adversary(spec).bind(12), \
        TA.parse_adversary(spec).bind(12)
    idx = np.arange(6, 11)
    for r in (0, 3):
        x = _payload(form, 5, r + 7)
        try:
            want = ja.corrupt(_tree(x, jnp.asarray), jnp.asarray(idx,
                                                                 jnp.int32),
                              jnp.int32(r))
        except ValueError as e:
            with pytest.raises(ValueError) as terr:
                ta.corrupt(_tree(x, torch.tensor), torch.from_numpy(idx), r)
            assert str(terr.value) == str(e)
            continue
        got = ta.corrupt(_tree(x, torch.tensor), torch.from_numpy(idx), r)
        if isinstance(want, dict):
            for k in want:
                np.testing.assert_array_equal(
                    got[k].numpy().view(np.uint8),
                    np.asarray(want[k]).view(np.uint8), err_msg=k)
        else:
            np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                          np.asarray(want).view(np.uint8))
    if "dropout" not in spec:
        with pytest.raises(ValueError) as jerr:
            ja.corrupt({"bogus": jnp.zeros((5, 2))}, jnp.asarray(idx), 0)
        with pytest.raises(ValueError) as terr:
            ta.corrupt({"bogus": torch.zeros((5, 2))},
                       torch.from_numpy(idx), 0)
        assert str(terr.value) == str(jerr.value)


def test_byte_corrupt_hits_a_share_near_p():
    ta = TA.parse_adversary("byte_corrupt(f=2,p=0.1)").bind(8)
    honest = torch.from_numpy(_packed(8, 200_000, 1))
    got = ta.corrupt(honest.clone(), torch.arange(8), 0)
    share = (got != honest).float().mean(1)
    assert torch.equal(got[2:], honest[2:])
    # hit w.p. 0.1, and a hit keeps the byte w.p. 1/256
    np.testing.assert_allclose(share[:2].numpy(), 0.1 * 255 / 256,
                               atol=0.003)


# ---------------------------------------------------------------------------
# consensus rounds against the reference, op by op
# ---------------------------------------------------------------------------

ROBUST = {"vote": "zsign(agg=vote)",
          "trimmed": "zsign(z=1,sigma=2.0,agg=trimmed(f=1))",
          "median": "stosign(agg=median)",
          "ef_vote": "ef|zsign(agg=vote)"}
ATTACKS = ["sign_flip(f=3)", "byte_corrupt(f=2,p=0.2)",
           "collude(f=3,rotate=true)", "dropout(f=2,every=2)"]




@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("case", sorted(ROBUST))
def test_robust_consensus_matches_reference(case, local_steps, monkeypatch):
    """Params and EF residuals bit for bit. Sto-sign's sigma is each
    client's norm, whose f32 summation order differs between XLA and
    torch: the port is given the reference's norms (as in the sto-sign
    tests), every other step is its own. One stated exception, the EF
    rule of tests/test_torch_efsign.py: with E = 2 XLA contracts the
    reference's local step under lax.scan into a multiply-add, which moves
    a pseudo-gradient coordinate by an ulp, and the EF residual carries
    it: residuals agree to 1e-6 of their largest entry there."""
    monkeypatch.setattr(TD, "row_norms", ref_row_norms)
    spec = ROBUST[case]
    ys = targets(1, local_steps)
    slr = 0.5 if "sigma" not in spec else 2.0
    js, jm = reference(spec, ys, local_steps=local_steps, slr=slr)
    ts, tm = port(spec, ys, local_steps=local_steps, slr=slr)
    np.testing.assert_array_equal(i32(flat_params(ts, True)),
                                  i32(flat_params(js, False)))
    if case == "ef_vote" and local_steps == 2:
        e_ref = np.asarray(js.comp_state["ef"])
        np.testing.assert_allclose(ts.comp_state["ef"].numpy(), e_ref,
                                   rtol=0, atol=1e-6 * np.abs(e_ref).max())
    else:
        assert_state_equal(js, ts)
    assert float(tm.uplink_bits) == float(jm.uplink_bits)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-6)


@pytest.mark.parametrize("adv", ATTACKS)
def test_attacked_vote_round_matches_reference(adv):
    ys = targets()
    js, jm = reference("zsign(agg=vote)", ys, adversary=adv, slr=0.5)
    ts, tm = port("zsign(agg=vote)", ys, adversary=adv, slr=0.5)
    np.testing.assert_array_equal(i32(flat_params(ts, True)),
                                  i32(flat_params(js, False)))
    assert float(tm.participation) == float(jm.participation)


# ---------------------------------------------------------------------------
# the plans of the port give one result
# ---------------------------------------------------------------------------

PLANS = [(1, "stream(shard=1)"), (1, "stream(shard=3)"),
         (1, "stream(shard=7)"), (1, "stream(shard=4,feed=host)"),
         (2, "vmap")]


@pytest.mark.parametrize("G,cohort", PLANS)
@pytest.mark.parametrize("spec,adv", [
    ("zsign_packed(z=1,sigma=2.0,agg=trimmed(f=2))", "none"),
    ("ef|zsign(agg=vote)", "byte_corrupt(f=2,p=0.2)"),
    ("zsign(agg=median)", "collude(f=3,rotate=true)")])
def test_robust_plans_bit_identical(spec, adv, G, cohort):
    ys = targets(seed=4)
    kw = dict(adversary=adv, slr=0.5, rounds=4)
    base, _ = port(spec, ys, **kw)
    got, _ = port(spec, ys.reshape(G, N // G, 1, -1), G=G, cohort=cohort,
                  **kw)
    assert_port_same(base, got)


# ---------------------------------------------------------------------------
# a reduced qwen2 round, and the launcher
# ---------------------------------------------------------------------------

def test_reduced_qwen_vote_round_matches_reference():
    """One reduced-qwen2 round of zsign(agg=vote), 3 clients, E = 2, the
    same weights and tokens. The pseudo-gradients agree to f32 matmul
    order, so a wire bit can flip where a client's noisy value sits at the
    threshold (the erf rule); the decoded update is sign(count) in
    {-1, 0, +1}, and fewer than 1e-3 of the coordinates move differently."""
    from test_torch_round import (CLR, SIGMA, SLR, _qwen_round_inputs)
    from repro.core import fedavg as JF
    from repro_torch.core import noise as TN
    from repro_torch.models.api import params_from_numpy
    jb, tb, jparams, tokens = _qwen_round_inputs()
    spec = f"zsign(z=1,sigma={SIGMA},agg=vote)"
    jcfg = JF.FedConfig(n_clients=3, local_steps=2, client_lr=CLR,
                        server_lr=SLR)
    jcomp = JC.Pipeline(spec)
    jstep = jax.jit(JF.build_round_step(
        jb.loss_fn, jcomp, jcfg, JF.RoundContext(weights_are_mask=True)))
    js1, jm = jstep(JF.init_server_state(jparams, jcfg, jcomp,
                                         jax.random.PRNGKey(1)),
                    {"tokens": jnp.asarray(tokens)}, jnp.ones((1, 3)))
    tcfg = TF.FedConfig(n_clients=3, local_steps=2, client_lr=CLR,
                        server_lr=SLR)
    tcomp = TC.Pipeline(spec)
    tstep = TF.build_round_step(tb.loss_fn, tcomp, tcfg,
                                TF.RoundContext(weights_are_mask=True))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                "cpu")
    ts1, tm = tstep(TF.init_server_state(tparams, tcfg, tcomp,
                                         TN.prng_key(1)),
                    {"tokens": torch.tensor(tokens).long()},
                    np.ones((1, 3), np.float32))
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4)
    spec_j = JW.tree_spec(jparams)
    p0 = np.asarray(spec_j.flatten(jparams))
    unit = np.float32(SLR * CLR)
    sj = np.rint((p0 - np.asarray(spec_j.flatten(js1.params))) / unit)
    st = np.rint((p0 - TW.tree_spec(ts1.params).flatten(
        ts1.params).numpy()) / unit)
    assert set(np.unique(sj)) <= {-1, 0, 1}
    assert set(np.unique(st)) <= {-1, 0, 1}
    frac = float(np.mean(sj != st))
    print(f"reduced qwen2 vote round: {frac:.2e} of the coordinates differ")
    assert frac < 1e-3


CLI = [["--pipeline", "zsign(z=1,sigma=0.01,agg=vote)", "--adversary",
        "sign_flip(f=1)"],
       ["--pipeline", "zsign_packed(z=1,sigma=0.01,agg=trimmed(f=1))",
        "--cohort", "stream(shard=2)", "--debug-wire"],
       ["--pipeline", "zsign(agg=median)", "--adversary",
        "byte_corrupt(f=1,p=0.1)"],
       ["--compressor", "zsign", "--adversary", "dropout(f=1)"]]


@pytest.mark.parametrize("flags", CLI, ids=lambda f: " ".join(f))
def test_train_run_cpu_robust_and_adversary(flags, capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--clients", "3",
                          "--seq-len", "16"] + flags)
    history = TT.run(args)
    d = TW.tree_spec(t_build(t_get_arch("qwen2_0_5b").reduced().model)
                     .init(torch.Generator().manual_seed(0), "cpu")).n_coords
    live = 2 if "dropout(f=1)" in flags else 3
    assert len(history) == 2
    for m in history:
        assert float(m.participation) == live
        assert float(m.uplink_bits) == live * d
        assert np.isfinite(float(m.loss))
    assert "round,loss" in capsys.readouterr().out
