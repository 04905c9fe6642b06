"""Whole z-SignFedAvg rounds in the port against the reference.

(a) The quickstart consensus problem (D=200, N=10, client_lr 0.01,
    loss = 0.5*sum((p - y)^2)): its gradient p - y is exact in both
    frameworks, so after 20 rounds the port's params are BIT-IDENTICAL to
    the reference's. z=1 would be subject to the erf rule; on this seed no
    bit flips, and the test asserts identity. The reference round runs op
    by op, in the order its source writes: under ``jax.jit`` XLA folds the
    decode's three constant factors (eta_z*sigma, client_lr, server_lr)
    into one and fuses the server step into a multiply-add on the CPU,
    which moves the last bit of some coordinates.
(b) One round of reduced qwen2-0.5B (f32), 3 clients, E=2, the same weights
    and tokens: fed the reference's own flat pseudo-gradients the port's
    wire bytes are identical (up to the erf rule); end to end the loss
    agrees to rtol 1e-4 (f32 matmul order), and fewer than 1e-3 of the wire
    bits differ, each costing exactly one sign step of the decoded update.
(c) ``launch.train.run`` on the CPU: uplink bits = n_live * d per round.
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
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import train as TT
from repro_torch.models.api import build_model as t_build
from repro_torch.models.api import params_from_numpy

# The suite runs in parallel worker processes beside the reference's
# tests; one intra-op thread per worker keeps torch from oversubscribing
# the cores they share.
torch.set_num_threads(1)

D, N, ROUNDS = 200, 10, 20


@pytest.mark.parametrize("spec,slr", [("zsign", 0.05),
                                      ("zsign(z=1,sigma=2.0)", 2.0),
                                      ("zsign(z=inf,sigma=2.0)", 2.5)])
@pytest.mark.parametrize("local_steps", [1, 2])
def test_consensus_params_bit_identical(spec, slr, local_steps):
    targets = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, N, D)))
    ys = np.repeat(targets[:, :, None], local_steps, axis=2)

    jcomp = JC.Pipeline(spec)
    jcfg = JF.FedConfig(n_clients=N, local_steps=local_steps,
                        client_lr=0.01, server_lr=slr)
    jstep = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), jcomp, jcfg)
    js = JF.init_server_state({"x": jnp.zeros(D)}, jcfg, jcomp,
                              jax.random.PRNGKey(1))

    tcomp = TC.Pipeline(spec)
    tcfg = TF.FedConfig(n_clients=N, local_steps=local_steps,
                        client_lr=0.01, server_lr=slr)
    tstep = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), tcomp, tcfg)
    ts = TF.init_server_state({"x": torch.zeros(D)}, tcfg, tcomp,
                              TN.prng_key(1))

    jb, tb = {"y": jnp.asarray(ys)}, {"y": torch.from_numpy(ys)}
    mask = np.ones((1, N), np.float32)
    for _ in range(ROUNDS):
        js, jm = jstep(js, jb, jnp.asarray(mask))
        ts, tm = tstep(ts, tb, mask)
    np.testing.assert_array_equal(ts.params["x"].numpy().view(np.int32),
                                  np.asarray(js.params["x"]).view(np.int32))
    np.testing.assert_array_equal(ts.rng.numpy(), np.asarray(js.rng))
    assert float(tm.uplink_bits) == float(jm.uplink_bits)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)


@pytest.mark.parametrize("spec,slr", [("zsign(z=1,sigma=2.0)", 2.0),
                                      ("zsign(z=inf,sigma=2.0)", 2.5)])
def test_consensus_close_to_jitted_reference(spec, slr):
    """Against the jitted reference (constant folding + FMA in the server
    step) the params stay within 1e-6 after 20 rounds."""
    ys = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                    (1, N, D)))[:, :, None]
    jcomp, tcomp = JC.Pipeline(spec), TC.Pipeline(spec)
    jcfg = JF.FedConfig(n_clients=N, client_lr=0.01, server_lr=slr)
    tcfg = TF.FedConfig(n_clients=N, client_lr=0.01, server_lr=slr)
    jstep = jax.jit(JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), jcomp, jcfg))
    tstep = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), tcomp, tcfg)
    js = JF.init_server_state({"x": jnp.zeros(D)}, jcfg, jcomp,
                              jax.random.PRNGKey(1))
    ts = TF.init_server_state({"x": torch.zeros(D)}, tcfg, tcomp,
                              TN.prng_key(1))
    for _ in range(ROUNDS):
        js, _ = jstep(js, {"y": jnp.asarray(ys)}, jnp.ones((1, N)))
        ts, _ = tstep(ts, {"y": torch.from_numpy(ys)},
                      np.ones((1, N), np.float32))
    np.testing.assert_allclose(ts.params["x"].numpy(),
                               np.asarray(js.params["x"]), rtol=0, atol=1e-6)


def _qwen_round_inputs():
    jarch = j_get_arch("qwen2_0_5b").reduced()
    jb = j_build(jarch.model)
    tb = t_build(t_get_arch("qwen2_0_5b").reduced().model)
    jparams = jb.init(jax.random.PRNGKey(0))
    tokens = np.asarray(JTokenStream(vocab=jarch.model.vocab).round_batch(
        0, (1, 3, 2, 2), 32))
    return jb, tb, jparams, tokens


SIGMA, CLR, SLR = 0.01, 0.05, 0.5


def test_reduced_qwen_round_wire_bytes_from_reference_gradients():
    jb, _, jparams, tokens = _qwen_round_inputs()
    spec = JW.tree_spec(jparams)
    grad = jax.jit(jax.grad(jb.loss_fn))
    flats = []
    for c in range(3):
        x = jparams
        for e in range(2):
            g = grad(x, {"tokens": jnp.asarray(tokens[0, c, e])})
            x = jax.tree.map(lambda w, gw: w - CLR * gw, x, g)
        flats.append(np.asarray(spec.flatten(jax.tree.map(
            lambda a, b: (a - b) / CLR, jparams, x))))
    flats = np.stack(flats)
    sub = jax.random.split(jax.random.PRNGKey(1))[1]
    jkeys = JN.client_keys(sub, 0, 3)
    want = np.stack([np.asarray(JC.fused_sign_encode_jnp(
        jnp.asarray(flats[c]), jkeys[c], SIGMA, z=1)) for c in range(3)])

    tkeys = TN.client_keys(TN.split(TN.prng_key(1))[1], 0, 3)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    d_pad = -(-spec.n_coords // 8192) * 8192
    x2d = torch.from_numpy(np.pad(flats,
                                  ((0, 0), (0, d_pad - spec.n_coords))))
    comp = TC.ZSignCompressor(z=1, sigma=SIGMA)
    got, _ = comp.encode_batch(tkeys, x2d, spec.n_coords)
    flips, far = TO.erf_rule_flips(x2d, tkeys, torch.full((3,), SIGMA), 1,
                                   got, torch.from_numpy(want))
    print(f"reduced qwen2 wire: {flips} bits differ (erf rule)")
    assert far == 0


def test_reduced_qwen_round_end_to_end():
    jb, tb, jparams, tokens = _qwen_round_inputs()
    jcomp = JC.ZSignCompressor(z=1, sigma=SIGMA)
    jcfg = JF.FedConfig(n_clients=3, local_steps=2, client_lr=CLR,
                        server_lr=SLR)
    jstep = jax.jit(JF.build_round_step(
        jb.loss_fn, jcomp, jcfg, JF.RoundContext(weights_are_mask=True)))
    js0 = JF.init_server_state(jparams, jcfg, jcomp, jax.random.PRNGKey(1),
                               sigma0=SIGMA)
    js1, jm = jstep(js0, {"tokens": jnp.asarray(tokens)},
                    jnp.ones((1, 3)))

    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                "cpu")
    tcomp = TC.ZSignCompressor(z=1, sigma=SIGMA)
    tcfg = TF.FedConfig(n_clients=3, local_steps=2, client_lr=CLR,
                        server_lr=SLR)
    tstep = TF.build_round_step(tb.loss_fn, tcomp, tcfg,
                                TF.RoundContext(weights_are_mask=True))
    ts0 = TF.init_server_state(tparams, tcfg, tcomp, TN.prng_key(1),
                               sigma0=SIGMA)
    ts1, tm = tstep(ts0, {"tokens": torch.tensor(tokens).long()},
                    np.ones((1, 3), np.float32))

    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4)
    spec = JW.tree_spec(jparams)
    p0 = np.asarray(spec.flatten(jparams))
    pj = np.asarray(spec.flatten(js1.params))
    pt = TW.tree_spec(ts1.params).flatten(ts1.params).numpy()
    # each coordinate moves by S * unit, S = the sum of 3 client signs
    unit = SLR * CLR * JN.eta_z(1) * SIGMA / 3
    sj = np.rint((p0 - pj) / unit)
    st = np.rint((p0 - pt) / unit)
    assert set(np.unique(sj)) <= {-3, -1, 1, 3}
    flipped_bits = np.abs(sj - st).sum() / 2
    frac = flipped_bits / (3 * spec.n_coords)
    print(f"reduced qwen2 round: {int(flipped_bits)} of {3 * spec.n_coords} "
          f"wire bits differ ({frac:.2e})")
    assert frac < 1e-3
    same = sj == st
    np.testing.assert_allclose(pt[same], pj[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("participation", [1.0, 0.5])
def test_train_run_cpu_uplink_bits(participation, capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--clients", "4",
                          "--local-steps", "1", "--seq-len", "16",
                          "--participation", str(participation)])
    history = TT.run(args)
    assert len(history) == 2
    d = TW.tree_spec(t_build(t_get_arch("qwen2_0_5b").reduced().model)
                     .init(torch.Generator().manual_seed(0), "cpu")).n_coords
    for m in history:
        n_live = float(m.participation)
        assert n_live == 4 * participation
        assert float(m.uplink_bits) == n_live * d
        assert np.isfinite(float(m.loss))
    assert "round,loss" in capsys.readouterr().out


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = TT.parse_args(["--arch", "qwen2_0_5b", "--reduced", "--rounds",
                          "1"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TT.run(args)


def test_unported_paths_raise():
    # qsgd (item 9) and the robust agg= laws (item 12) are ported now: the
    # same canonical spec as the reference
    for spec in ("qsgd(s=4)", "zsign(agg=vote)"):
        assert TC.Pipeline(spec).spec == JC.Pipeline(spec).spec
    # DP-SignFedAvg is ported now: dp noise fuses into the codec's sigma
    assert TC.Pipeline("dp(clip=1.0,noise=0.1)|zsign").codec.sigma == 0.1
    # stream(devices=D) is ported: without a torch.distributed group the
    # world is one rank, so D = 2 asks for more ranks than exist
    with pytest.raises(ValueError, match="wants devices=2 but only 1"):
        TF.resolve_cohort("stream(devices=2)", 64, 494_032_768)
    assert TF.resolve_cohort("stream(devices=auto)", 64, 494_032_768) == \
        TF.CohortPlan("stream", 8, 1, 1, "device")
    # the streaming plan and the group scan are ported now
    assert TF.resolve_cohort("auto", 64, 494_032_768) == TF.CohortPlan(
        "stream", 8, 1, 1, "device")
    assert TF.resolve_cohort("auto", 8, 494_032_768) == TF.VMAP_PLAN
    TF.build_round_step(lambda p, b: 0, TC.Pipeline("zsign"),
                        TF.FedConfig(client_groups=2))
