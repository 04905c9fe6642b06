"""QSGD and top-k with the COO scatter-sum in the port against the
reference.

Bit for bit: the COO scatter-sum (duplicate indices across clients, with
and without a carried sum; clients are scattered one at a time, so every
coordinate adds in client order as XLA's ``.at[].add`` does on the CPU),
the top-k selected set and payload order against ``lax.top_k`` on inputs
with many ties at the k-th magnitude (bf16-rounded values and zeros) for
every ``chunk``, QSGD's Bernoulli bits (the reference's threefry draw) and
its q given the reference's norm, and top-k consensus rounds (mean and
coord laws, with EF). Stated tolerances, each with its cause: QSGD rounds
run with the reference's norms, and the dense wire's f32 sum order
differs from XLA's einsum (the dpgauss rule of
tests/test_torch_dp_plateau.py, 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import noise as JN
from repro.core import wire as JW
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import dp as TD
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.launch import train as TT
from repro_torch.models.api import build_model as t_build
from torch_consensus import (N, assert_port_same, assert_state_equal,
                             flat_params, i32, port, ref_row_norms, reference,
                             targets)

torch.set_num_threads(1)




# ---------------------------------------------------------------------------
# the COO scatter-sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_acc", [False, True])
def test_scatter_sum_coo_bit_exact(with_acc):
    rng = np.random.RandomState(3)
    n, k, d = 7, 40, 97
    idx = np.stack([rng.choice(d, k, replace=False) for _ in range(n)])
    idx[:, :5] = idx[0, :5]                 # duplicates across clients
    vals = (rng.randn(n, k) * 10 ** rng.uniform(-3, 3, (n, k))).astype(
        np.float32)
    w = np.array([1, 0, 1, 1, 0.5, 1, 2], np.float32)
    acc = rng.randn(d).astype(np.float32) if with_acc else None
    want = np.asarray(JW.scatter_sum_coo(
        jnp.asarray(vals), jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(w), d, None if acc is None else jnp.asarray(acc)))
    got = TW.scatter_sum_coo(
        torch.from_numpy(vals), torch.from_numpy(idx.astype(np.int32)),
        torch.from_numpy(w), d,
        None if acc is None else torch.from_numpy(acc.copy()))
    np.testing.assert_array_equal(i32(got.numpy()), i32(want))


def test_dense_masked_sum_is_a_client_order_fold():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(6, 50).astype(np.float32))
    w = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 0.0])
    whole = TW.dense_masked_sum(x, w)
    parts = TW.dense_masked_sum(x[3:], w[3:], TW.dense_masked_sum(x[:3],
                                                                  w[:3]))
    assert torch.equal(whole.view(torch.int32), parts.view(torch.int32))
    want = np.asarray(JW.dense_masked_sum(jnp.asarray(x.numpy()),
                                          jnp.asarray(w.numpy())))
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# top-k: set and order under ties
# ---------------------------------------------------------------------------

def _tied_rows(n, d, seed):
    """Rows with many equal magnitudes: bf16-rounded values (8 bits of
    mantissa), a third of them zero, signs mixed."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    x[rng.rand(n, d) < 0.33] = 0.0
    x[:, ::17] = -x[:, ::17]
    return x


@pytest.mark.parametrize("frac", [0.01, 0.2, 0.6])
@pytest.mark.parametrize("chunk", [0, 4096, 65536])
def test_topk_set_and_order_match_lax_top_k(chunk, frac):
    n, d = 3, 20_011
    x = _tied_rows(n, d, seed=int(frac * 100) + chunk)
    codec = f"topk(frac={frac},chunk={chunk})"
    jc, tc = JC.Pipeline(codec), TC.Pipeline(codec)
    got, _ = tc.encode_batch(None, torch.from_numpy(x.copy()), d)
    k = max(1, int(d * frac))
    assert got["values"].shape == (n, k)
    assert got["indices"].dtype == torch.int32
    for c in range(n):
        want, _ = jc.encode(None, jnp.asarray(x[c]), None)
        np.testing.assert_array_equal(got["indices"][c].numpy(),
                                      np.asarray(want["indices"]))
        np.testing.assert_array_equal(i32(got["values"][c].numpy()),
                                      i32(want["values"]))
        # the k-th magnitude is tied: the tie rule is what is tested
        a = np.abs(x[c])
        kth = np.sort(a)[::-1][k - 1]
        assert (a == kth).sum() > 1


def test_topk_selects_among_n_coords_only():
    """Padding zeros past n_coords tie with real zeros; k and the
    selection come from the first n_coords entries."""
    x = np.zeros((1, 64), np.float32)
    x[0, :10] = [3, 0, 0, -3, 1, 0, 0, 0, 0, 2]
    tc = TC.TopKCodec(frac=0.5)
    payload, _ = tc.encode_with_decode_batch(None, torch.from_numpy(x), 10)
    assert payload["indices"][0].tolist() == [0, 3, 9, 4, 1]


def test_topk_resolve_chunk_and_wire():
    for d, k in ((10, 1), (494_032_768, 4_940_327), (1 << 20, 100)):
        assert TC.TopKCodec._resolve_chunk(d, k) == \
            JC.TopKCodec._resolve_chunk(d, k)
    wf = TC.Pipeline("topk").wire_format()
    assert (wf.dtype, wf.bits_per_coord, wf.layout) == \
        ("float32", 0.64, "sparse_coo")
    assert TC.Pipeline("topk").pad_multiple() == 1
    assert TC.Pipeline("topk").stacks_group_payloads()
    assert TC.TopKCompressor().spec == JC.TopKCompressor().spec
    assert TC.QSGDCompressor(s=3).spec == JC.QSGDCompressor(s=3).spec


@pytest.mark.parametrize("agg", ["mean", "coord"])
def test_topk_aggregate_and_decode_match_reference(agg):
    rng = np.random.RandomState(2)
    n, d = 6, 300
    x = rng.randn(n, d).astype(np.float32)
    spec = f"topk(frac=0.1,agg={agg})"
    jc, tc = JC.Pipeline(spec), TC.Pipeline(spec)
    mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    enc, _ = tc.encode_batch(None, torch.from_numpy(x.copy()), d)
    jenc = [jc.encode(None, jnp.asarray(x[c]), None)[0] for c in range(n)]
    jstack = {k: jnp.stack([e[k] for e in jenc]) for k in jenc[0]}
    jagg = jc.aggregate(jstack, jnp.asarray(mask), d)
    # the stream fold: two shards into one carried accumulator
    acc = tc.zero_acc({k: v[:3] for k, v in enc.items()}, d)
    acc = tc.aggregate({k: v[:3] for k, v in enc.items()},
                       torch.from_numpy(mask[:3]), d, acc=acc)
    acc = tc.aggregate({k: v[3:] for k, v in enc.items()},
                       torch.from_numpy(mask[3:]), d, acc=acc)
    one = tc.aggregate(enc, torch.from_numpy(mask), d)
    np.testing.assert_array_equal(i32(one.numpy()), i32(jagg))
    np.testing.assert_array_equal(i32(acc.numpy()), i32(jagg))
    want = np.asarray(jc.decode_sum(jagg, jnp.asarray(5.0)))
    got = tc.decode_sum(one, torch.tensor(5.0)).numpy()
    np.testing.assert_array_equal(i32(got), i32(want))
    if agg == "coord":
        assert one.shape == (2, d) and float(one[1].max()) <= 5


# ---------------------------------------------------------------------------
# QSGD
# ---------------------------------------------------------------------------

def test_qsgd_bits_are_the_reference_draw():
    key = JN.client_keys(jax.random.PRNGKey(4), 0, 3)[2]
    tkey = TN.client_keys(TN.prng_key(4), 0, 3)[2]
    n = 5000
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = torch.cat([TN.bits_to_uniform(TN.random_bits(tkey, lo, lo + 1000))
                     for lo in range(0, n, 1000)])
    np.testing.assert_array_equal(i32(got.numpy()), i32(want))


@pytest.mark.parametrize("s", [1, 4])
def test_qsgd_q_bit_exact_given_the_reference_norm(s, monkeypatch):
    """q equals the reference's bit for bit once the port is given the
    reference's norms; -0.0 inputs keep their sign as jnp.sign does."""
    rng = np.random.RandomState(s)
    n, d = 4, 3001
    x = (rng.randn(n, d) * rng.rand(n, 1) * 3).astype(np.float32)
    x[:, ::7] = 0.0
    x[:, 3::11] = -0.0
    jkeys = JN.client_keys(jax.random.PRNGKey(6), 0, n)
    tkeys = TN.client_keys(TN.prng_key(6), 0, n)
    jc = JC.Pipeline(f"qsgd(s={s})")
    want = np.stack([np.asarray(jc.encode(jkeys[c], jnp.asarray(x[c]),
                                          None)[0]) for c in range(n)])
    monkeypatch.setattr(TD, "row_norms", ref_row_norms)
    tc = TC.Pipeline(f"qsgd(s={s})")
    got, _ = tc.encode_batch(tkeys, torch.from_numpy(x.copy()), d)
    np.testing.assert_array_equal(i32(got.numpy()), i32(want))
    nrm = np.linalg.norm(x.astype(np.float64), axis=1, keepdims=True)
    lv = np.abs(got.numpy()) / nrm * s
    np.testing.assert_allclose(lv, np.rint(lv), atol=1e-5)


def test_qsgd_own_norm_level_flips():
    """With the port's own norm (another f32 summation order) q agrees to
    the norm's ulps; a level flips only where r - floor(r) lies within
    those ulps of u. The flips are counted: none on these inputs."""
    rng = np.random.RandomState(8)
    n, d = 4, 20_000
    x = rng.randn(n, d).astype(np.float32)
    jkeys = JN.client_keys(jax.random.PRNGKey(9), 0, n)
    tkeys = TN.client_keys(TN.prng_key(9), 0, n)
    jc = JC.Pipeline("qsgd(s=2)")
    want = np.stack([np.asarray(jc.encode(jkeys[c], jnp.asarray(x[c]),
                                          None)[0]) for c in range(n)])
    got, _ = TC.Pipeline("qsgd(s=2)").encode_batch(
        tkeys, torch.from_numpy(x.copy()), d)
    got = got.numpy()
    nrm = np.linalg.norm(x.astype(np.float64), axis=1, keepdims=True)
    flips = np.abs(np.rint(got / nrm * 2) - np.rint(want / nrm * 2)) > 0
    print(f"qsgd own norm: {int(flips.sum())} level flips of {n * d}")
    assert flips.sum() == 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# consensus rounds against the reference, op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("spec,slr", [("topk(frac=0.1)", 1.0),
                                      ("ef|topk(frac=0.1,agg=coord)", 1.0),
                                      ("topk(frac=0.1,agg=coord)", 1.0),
                                      ("ef|topk(frac=0.1)", 1.0)])
def test_topk_consensus_matches_reference(spec, slr, local_steps):
    """Params and EF residuals bit for bit at E = 1. At E = 2 the rule of
    tests/test_torch_efsign.py: XLA contracts the reference's local step
    into a multiply-add under lax.scan, which moves a pseudo-gradient
    coordinate by an ulp; top-k sends the values themselves, and the ulps
    add up over the 12 rounds: the params agree to rtol 1e-6 (atol 1e-7)
    and EF residuals to 1e-6 of their largest entry."""
    ys = targets(1, local_steps)
    js, jm = reference(spec, ys, local_steps=local_steps, slr=slr)
    ts, tm = port(spec, ys, local_steps=local_steps, slr=slr)
    if local_steps == 2:
        np.testing.assert_allclose(flat_params(ts, True),
                                   flat_params(js, False), rtol=1e-6,
                                   atol=1e-7)
        if spec.startswith("ef"):
            e_ref = np.asarray(js.comp_state["ef"])
            np.testing.assert_allclose(ts.comp_state["ef"].numpy(), e_ref,
                                       rtol=0,
                                       atol=1e-6 * np.abs(e_ref).max())
    else:
        np.testing.assert_array_equal(i32(flat_params(ts, True)),
                                      i32(flat_params(js, False)))
        assert_state_equal(js, ts)
    assert float(tm.uplink_bits) == float(jm.uplink_bits)


@pytest.mark.parametrize("adv", ["sign_flip(f=2)", "dropout(f=3)"])
@pytest.mark.parametrize("spec", ["topk(frac=0.1)", "qsgd(s=4)"])
def test_attacked_sparse_and_dense_rounds(spec, adv, monkeypatch):
    """The two attacks the COO and dense wires take, against the
    reference: top-k bit for bit; QSGD (given the reference's norms) to
    the dense wire's sum-order rule, 1e-6."""
    monkeypatch.setattr(TD, "row_norms", ref_row_norms)
    ys = targets()
    js, jm = reference(spec, ys, adversary=adv, slr=1.0)
    ts, tm = port(spec, ys, adversary=adv, slr=1.0)
    if spec.startswith("topk"):
        np.testing.assert_array_equal(i32(flat_params(ts, True)),
                                      i32(flat_params(js, False)))
    else:
        np.testing.assert_allclose(flat_params(ts, True),
                                   flat_params(js, False), rtol=0, atol=1e-6)
    assert float(tm.participation) == float(jm.participation)


@pytest.mark.parametrize("s", [1, 4])
def test_qsgd_consensus_close_to_reference(s, monkeypatch):
    """Given the reference's norms every client's q is the reference's bit
    for bit; the server's f32 sum over clients runs in another order than
    XLA's einsum: params within 1e-6 after 12 rounds (the dense wire's
    rule)."""
    monkeypatch.setattr(TD, "row_norms", ref_row_norms)
    ys = targets()
    js, jm = reference(f"qsgd(s={s})", ys, slr=1.0)
    ts, tm = port(f"qsgd(s={s})", ys, slr=1.0)
    np.testing.assert_allclose(flat_params(ts, True), flat_params(js, False),
                               rtol=0, atol=1e-6)
    assert float(tm.uplink_bits) == float(jm.uplink_bits)


# ---------------------------------------------------------------------------
# the plans of the port give one result
# ---------------------------------------------------------------------------

PLANS = [(1, "stream(shard=1)"), (1, "stream(shard=3)"),
         (1, "stream(shard=4,feed=host)"), (2, "vmap")]


@pytest.mark.parametrize("G,cohort", PLANS)
@pytest.mark.parametrize("spec", ["topk(frac=0.1)",
                                  "ef|topk(frac=0.1,agg=coord)",
                                  "qsgd(s=2)"])
def test_sparse_and_qsgd_plans_bit_identical(spec, G, cohort):
    ys = targets(seed=4)
    base, _ = port(spec, ys, slr=1.0, rounds=4)
    got, _ = port(spec, ys.reshape(G, N // G, 1, -1), G=G, cohort=cohort,
                  slr=1.0, rounds=4)
    assert_port_same(base, got)


# ---------------------------------------------------------------------------
# a reduced qwen2 round, and the launcher
# ---------------------------------------------------------------------------

def test_reduced_qwen_topk_round_matches_reference():
    """One reduced-qwen2 round of ef|topk(frac=0.01), 3 clients, E = 2,
    the same weights and tokens. The pseudo-gradients agree to f32 matmul
    order (rtol 1e-4 on the loss), so the kept sets agree except near the
    k-th magnitude: fewer than 1e-3 of the coordinates are kept by one side
    only, and the update agrees to 1e-4 of its largest entry elsewhere."""
    from test_torch_round import CLR, SLR, _qwen_round_inputs
    from repro.core import fedavg as JF
    from repro_torch.core import fedavg as TF
    from repro_torch.models.api import params_from_numpy
    jb, tb, jparams, tokens = _qwen_round_inputs()
    spec = "ef|topk(frac=0.01)"
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
    uj = p0 - np.asarray(spec_j.flatten(js1.params))
    ut = p0 - TW.tree_spec(ts1.params).flatten(ts1.params).numpy()
    one_side = (uj != 0) != (ut != 0)
    frac = float(one_side.mean())
    print(f"reduced qwen2 top-k round: {frac:.2e} of the coordinates kept "
          "by one side only")
    assert frac < 1e-3
    both = (uj != 0) & (ut != 0)
    np.testing.assert_allclose(ut[both], uj[both], rtol=0,
                               atol=1e-4 * np.abs(uj).max())


CLI = [["--compressor", "topk", "--topk-frac", "0.02"],
       ["--compressor", "qsgd", "--qsgd-s", "2"],
       ["--pipeline", "topk(frac=0.01,agg=coord)", "--cohort",
        "stream(shard=2,feed=host)"]]


@pytest.mark.parametrize("flags", CLI, ids=lambda f: " ".join(f))
def test_train_run_cpu_sparse_and_qsgd(flags, capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--clients", "3",
                          "--seq-len", "16"] + flags)
    history = TT.run(args)
    d = TW.tree_spec(t_build(t_get_arch("qwen2_0_5b").reduced().model)
                     .init(torch.Generator().manual_seed(0), "cpu")).n_coords
    # ceil(log2(2s + 1)) = 3 bits a coordinate at s = 2
    bits = {"topk": 64 * 0.02, "qsgd": 3.0}.get(flags[1], 64 * 0.01)
    assert len(history) == 2
    for m in history:
        assert float(m.uplink_bits) == float(
            torch.tensor(3.0) * float(d * bits))
        assert np.isfinite(float(m.loss))
    assert "round,loss" in capsys.readouterr().out
