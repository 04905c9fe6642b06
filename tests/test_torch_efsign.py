"""The EF-SignSGD path of the port against the reference.

(a) F1's plain version (``ef_sign_update`` / ``ef_sign_encode`` on the CPU)
    against the reference's K4 wrappers in interpret mode: payload, q and
    e' bit-exact as int32 patterns, given the same (g, e, scale).
(b) ``ef|zsign`` (generic pre-encode -> codec -> post-encode loop) and
    ``ef|zsign(use_kernel=true)`` (the fused F1 path) in the port: the same
    bytes, scale and residual over 5 encodes.
(c) The consensus problem (D=200, N=10, 20 rounds, E in {1, 2}) against the
    reference run op by op. The scale mean(|p|) is reduced by torch and by
    XLA in different orders (and XLA multiplies the sum by f32(1/d) where
    torch divides), so it differs in the last bit or two, and so does every
    value it scales: the residuals agree to 1e-6 of their largest magnitude
    and the params to 1e-7 after 20 rounds. No wire bit differs: with
    E = 1 the test rebuilds the reference's bits of every round from its
    state, Sign(x - y + e), and counts the differing ones (0 of 40,000).
    With E = 2 the reference's local steps run under ``lax.scan``, where
    XLA contracts ``w - gamma*g`` into a multiply-add, which moves the
    pseudo-gradient by an ulp as well.
(d) A dead client keeps its residual bit-exactly.
(e) ``weights_are_mask`` never reaches the scale-weighted reduce: an EF
    round under RoundContext(weights_are_mask=True) equals the LUT-path sum
    (the popcount path is valid for 0/1 weights only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.fed import client_state as JS
from repro.kernels.efsign import ops as JE
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.fed import client_state as TS
from repro_torch.kernels.efsign import ops as TE
from repro_torch.kernels.efsign import ref as TR
from repro_torch.launch import train as TT
from repro_torch.models.api import build_model as t_build

torch.set_num_threads(1)

D, N, ROUNDS = 200, 10, 20


def _i32(a):
    return np.asarray(a).view(np.int32)


def _ge(d, seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(d).astype(np.float32)
    e = (rng.randn(d) * 0.3).astype(np.float32)
    g[::7] = -e[::7]                      # p == 0 exactly: packs as +1
    return g, e


@pytest.mark.parametrize("d", [64, 8192, 50_000])
@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_plain_ef_matches_reference_kernel(d, scale):
    g, e = _ge(d, seed=d)
    jq, je = JE.ef_sign_update(jnp.asarray(g), jnp.asarray(e), scale,
                               interpret=True)
    tq, te = TE.ef_sign_update(torch.from_numpy(g), torch.from_numpy(e),
                               scale)
    np.testing.assert_array_equal(_i32(tq.numpy()), _i32(jq))
    np.testing.assert_array_equal(_i32(te.numpy()), _i32(je))
    jp, je2 = JE.ef_sign_encode(jnp.asarray(g), jnp.asarray(e), scale,
                                interpret=True)
    tp, te2 = TE.ef_sign_encode(torch.from_numpy(g), torch.from_numpy(e),
                                scale)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_i32(te2.numpy()), _i32(je2))
    # the plain oracle agrees too
    rq, re_ = TR.ef_sign_update_ref(torch.from_numpy(g), torch.from_numpy(e),
                                    scale)
    np.testing.assert_array_equal(_i32(rq.numpy()), _i32(jq))
    np.testing.assert_array_equal(_i32(re_.numpy()), _i32(je))


def test_plain_ef_rows_live_and_in_place():
    n, d = 3, 2 * 8192 + 37
    gs, es = zip(*(_ge(d, seed=s) for s in range(n)))
    g = torch.from_numpy(np.pad(np.stack(gs), ((0, 0), (0, 3 * 8192 - d))))
    e = torch.from_numpy(np.stack(es))
    scale = torch.tensor([0.1, 0.5, 1.0])
    live = torch.tensor([1.0, 0.0, 1.0])
    e_in = e.clone()
    packed, out, q = TE.ef_sign_rows(g, e_in, scale, live=live,
                                     in_place=True, with_q=True)
    assert out is e_in
    for c in range(n):
        jp, je = JE.ef_sign_encode(jnp.asarray(gs[c]), jnp.asarray(es[c]),
                                   float(scale[c]), interpret=True)
        np.testing.assert_array_equal(packed[c].numpy(), np.asarray(jp))
        want = es[c] if c == 1 else np.asarray(je)
        np.testing.assert_array_equal(_i32(out[c].numpy()), _i32(want))


def test_generic_and_kernel_paths_agree():
    n, d = 3, 20_000
    d_pad = -(-d // 8192) * 8192
    keys = TN.client_keys(TN.prng_key(3), 0, n)
    gen, ker = TC.Pipeline("ef|zsign"), TC.Pipeline("ef|zsign(use_kernel=true)")
    assert not gen._ef_kernel_path and ker._ef_kernel_path
    sg, sk = gen.init_state(d, lead=(n,)), ker.init_state(d, lead=(n,))
    live = torch.ones(n)
    rng = np.random.RandomState(0)
    for _ in range(5):
        x = torch.zeros((n, d_pad))
        x[:, :d] = torch.from_numpy(rng.randn(n, d).astype(np.float32))
        pg, sg = gen.encode_batch(keys, x.clone(), d, sg, live)
        pk, sk = ker.encode_batch(keys, x.clone(), d, sk, live)
        assert torch.equal(pg["packed"], pk["packed"])
        assert torch.equal(pg["scale"].view(torch.int32),
                           pk["scale"].view(torch.int32))
        assert torch.equal(sg["ef"].view(torch.int32),
                           sk["ef"].view(torch.int32))
    assert float(sk["ef"].abs().max()) > 0


class _Recording(TC.Pipeline):
    """The port's pipeline, keeping each round's wire bits (n, d) in the
    class-level ``log``."""
    log = []

    def encode_batch(self, keys, flat2d, n_coords=None, state=None,
                     live=None, **kw):
        payload, new = super().encode_batch(keys, flat2d, n_coords, state,
                                            live, **kw)
        packed = payload["packed"] if isinstance(payload, dict) else payload
        bits = np.unpackbits(packed.numpy(), axis=1, bitorder="little")
        _Recording.log.append(bits[:, :n_coords].astype(bool))
        return payload, new


def _consensus(spec, local_steps, ctx_kw=None, mask=None):
    """20 rounds of the consensus problem in both packages. -> (reference
    state, reference metrics, port state, port metrics, differing wire
    bits per round: E == 1 only, None otherwise)."""
    targets = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, N, D)))
    ys = np.repeat(targets[:, :, None], local_steps, axis=2)
    mask = np.ones((1, N), np.float32) if mask is None else mask

    jcomp = JC.Pipeline(spec)
    jcfg = JF.FedConfig(n_clients=N, local_steps=local_steps,
                        client_lr=0.01, server_lr=1.0)
    jstep = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), jcomp, jcfg,
        JF.RoundContext(**(ctx_kw or {})))
    js = JF.init_server_state({"x": jnp.zeros(D)}, jcfg, jcomp,
                              jax.random.PRNGKey(1))
    _Recording.log = []
    tcomp = _Recording(spec)
    tcfg = TF.FedConfig(n_clients=N, local_steps=local_steps,
                        client_lr=0.01, server_lr=1.0)
    tstep = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), tcomp, tcfg,
        TF.RoundContext(**(ctx_kw or {})))
    ts = TF.init_server_state({"x": torch.zeros(D)}, tcfg, tcomp,
                              TN.prng_key(1))
    jb, tb = {"y": jnp.asarray(ys)}, {"y": torch.from_numpy(ys)}
    ref_bits = []
    for _ in range(ROUNDS):
        # noise-free EF with E == 1 sends Sign(x - y + e): the reference's
        # wire bits of this round, from its state
        ref_bits.append(np.asarray(js.params["x"]) - targets[0]
                        + np.asarray(js.comp_state["ef"][0]) >= 0)
        js, jm = jstep(js, jb, jnp.asarray(mask))
        ts, tm = tstep(ts, tb, mask)
    flips = None
    if local_steps == 1 and "sigma" not in spec:
        flips = [int((r != b).sum()) for r, b in zip(ref_bits,
                                                      _Recording.log)]
    return js, jm, ts, tm, flips


@pytest.mark.parametrize("spec", ["ef|zsign", "ef|zsign(use_kernel=true)",
                                  "ef|zsign(z=inf,sigma=2.0)"])
@pytest.mark.parametrize("local_steps", [1, 2])
def test_ef_consensus_matches_reference(spec, local_steps):
    js, jm, ts, tm, flips = _consensus(spec, local_steps)
    assert ts.comp_state["ef"].shape == (1, N, D)
    if flips is not None:
        print(f"{spec} E=1: wire bits differing per round {flips}")
        assert sum(flips) == 0
    np.testing.assert_allclose(ts.params["x"].numpy(),
                               np.asarray(js.params["x"]), rtol=0, atol=1e-7)
    e_ref = np.asarray(js.comp_state["ef"])
    np.testing.assert_allclose(ts.comp_state["ef"].numpy(), e_ref, rtol=0,
                               atol=1e-6 * np.abs(e_ref).max())
    assert float(tm.uplink_bits) == float(jm.uplink_bits) == N * D
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)


@pytest.mark.parametrize("spec", ["ef|zsign", "ef|zsign(use_kernel=true)"])
def test_dead_client_keeps_residual(spec):
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=4, local_steps=1, client_lr=0.01)
    step = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), comp, cfg)
    ys = torch.from_numpy(np.random.RandomState(1).randn(1, 4, 1, 50)
                          .astype(np.float32))
    st = TF.init_server_state({"x": torch.zeros(50)}, cfg, comp,
                              TN.prng_key(2))
    st, _ = step(st, {"y": ys}, np.ones((1, 4), np.float32))
    before = st.comp_state["ef"].clone()
    assert float(before[0, 2].abs().max()) > 0
    st, m = step(st, {"y": ys}, np.array([[1, 1, 0, 1]], np.float32))
    after = st.comp_state["ef"]
    assert float(m.participation) == 3
    np.testing.assert_array_equal(_i32(after[0, 2].numpy()),
                                  _i32(before[0, 2].numpy()))
    for c in (0, 1, 3):
        assert not torch.equal(after[0, c], before[0, c])


def test_weights_are_mask_skips_the_scale_weighted_reduce():
    ctx = TF.RoundContext(weights_are_mask=True)
    ef = TC.Pipeline("ef|zsign").with_context(ctx)
    assert ef.codec.scale == "mean_abs" and not ef.codec.weights_are_mask
    assert TC.Pipeline("zsign").with_context(ctx).codec.weights_are_mask
    rng = np.random.RandomState(4)
    packed = torch.from_numpy(rng.randint(0, 256, (5, 300)).astype(np.uint8))
    payload = {"packed": packed,
               "scale": torch.from_numpy(rng.rand(5).astype(np.float32))}
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    got = ef.aggregate(payload, mask, 2400)
    want = TW.unpack_sum(packed, mask * payload["scale"])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, TW.unpack_sum_mask(packed,
                                                   mask * payload["scale"]))
    # whole EF rounds under the mask guarantee: the same bits as without
    # it, and the reference's wire bits
    _, _, ts, _, flips = _consensus("ef|zsign", 1, {"weights_are_mask": True})
    _, _, ts0, _, _ = _consensus("ef|zsign", 1)
    np.testing.assert_array_equal(_i32(ts.params["x"].numpy()),
                                  _i32(ts0.params["x"].numpy()))
    assert sum(flips) == 0


def test_spec_defaults_and_names_match_reference():
    for spec in ("ef|zsign", "ef|zsign(use_kernel=true)",
                 "ef|zsign(z=inf,sigma=2.0)", "ef|zsign(scale=none)",
                 "zsign_packed(z=2,sigma=0.01)"):
        assert TC.Pipeline(spec).spec == JC.Pipeline(spec).spec.replace(
            "encode_backend=pallas", "encode_backend=cuda"), spec
    assert TC.Pipeline("ef|zsign").wire_format() == TW.WireFormat(
        "uint8", 1.0, "bitpacked+scale")
    comp = TC.EFSignCompressor()
    assert comp.codec.scale == "mean_abs" and not comp._ef_kernel_path
    assert TC.EFSignCompressor(use_kernel=True)._ef_kernel_path
    assert "efsign" in TC.available()
    with pytest.raises(ValueError, match="at most one ef"):
        TC.Pipeline((TC.ErrorFeedback(), TC.ErrorFeedback()), TC.SignCodec())


def test_client_state_matches_reference():
    slots = TC.Pipeline("ef|zsign").state_slots(7)
    assert [(s.name, s.shape, s.scope) for s in slots] == \
        [(s.name, s.shape, s.scope)
         for s in JC.Pipeline("ef|zsign").state_slots(7)]
    tree = TS.init_tree(slots, "client", lead=(1, 3))
    assert tree["ef"].shape == (1, 3, 7) and float(tree["ef"].abs().sum()) == 0
    assert TS.init_tree(slots, "server") is None
    with pytest.raises(ValueError, match="collision"):
        TS.collect_slots([TC.ErrorFeedback(), TC.ErrorFeedback()], 3)
    with pytest.raises(ValueError, match="scope"):
        TS.StateSlot("x", (3,), scope="global")
    rng = np.random.RandomState(5)
    new, old = (rng.randn(4, 6).astype(np.float32) for _ in range(2))
    mask = np.array([1, 0, 0.5, 0], np.float32)
    want = JS.merge_rows({"ef": jnp.asarray(new)}, {"ef": jnp.asarray(old)},
                         jnp.asarray(mask))["ef"]
    got = TS.merge_rows({"ef": torch.from_numpy(new)},
                        {"ef": torch.from_numpy(old)},
                        torch.from_numpy(mask))["ef"]
    np.testing.assert_array_equal(_i32(got.numpy()), _i32(want))


@pytest.mark.parametrize("flags", [["--pipeline", "ef|zsign(use_kernel=true)"],
                                   ["--compressor", "efsign"]])
def test_train_run_cpu_ef(flags, capsys):
    args = TT.parse_args(["--device", "cpu", "--arch", "qwen2_0_5b",
                          "--reduced", "--rounds", "2", "--clients", "3",
                          "--local-steps", "2", "--seq-len", "16",
                          "--participation", "0.67"] + flags)
    history = TT.run(args)
    assert len(history) == 2
    d = TW.tree_spec(t_build(t_get_arch("qwen2_0_5b").reduced().model)
                     .init(torch.Generator().manual_seed(0), "cpu")).n_coords
    for m in history:
        assert float(m.participation) == 2
        assert float(m.uplink_bits) == 2 * d
        assert np.isfinite(float(m.loss))
    assert "bitpacked+scale" in capsys.readouterr().out
