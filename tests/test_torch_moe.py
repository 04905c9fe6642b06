"""The port's MoE layer and the MoE and VLM losses against the reference's.

Routing rule. Router logits are an f32 matmul whose summation order differs
between XLA and torch, so two gates within an ulp could route a token
differently. A token whose gaps between its k+1 largest gates all exceed
1e-5 must route the same (``idx``) in both packages, and a batch row whose
tokens all pass must keep the same slots (``keep``) and give the same
outputs. The seeds below are the first ones tried; the tests report how
many tokens the rule let through.

Tolerances: f32 outputs, aux, losses and gradients agree to rtol 1e-4 /
atol 1e-6 (the matmuls' orders differ); ``_topk_iterative`` exactly; the
bf16 layer (expert matmuls and the k-sum in bf16, whose summation order is
the framework's) to atol 2e-2 over outputs of magnitude ~1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import get_arch as j_get_arch
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import wire as JW
from repro.models import layers as JL
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model as t_build
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
GAP = 1e-5
_j_moe_apply = jax.jit(JL.moe_apply, static_argnums=(2, 3),
                       static_argnames=("ep",))


def test_topk_iterative_exact_with_ties():
    rs = np.random.RandomState(0)
    # few distinct values: many exact ties, which go to the first index
    s = rs.randint(0, 4, (64, 9)).astype(np.float32) / 4
    s[0] = 0.5                                   # all tied
    for k in (1, 2, 3, 9):
        jv, ji = JL._topk_iterative(jnp.asarray(s), k)
        tv, ti = TL._topk_iterative(torch.from_numpy(s), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == list(range(9))


def _ref_route(x, router, E, k):
    """The reference's routing, op for op as its moe_apply writes it."""
    B, S, _ = x.shape
    C = max(1, int(S * k / E * 1.25))
    gate_all = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    gates, idx = JL._topk_iterative(gate_all, k)
    flat_e = idx.reshape(B, S * k)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - oh) * oh, axis=-1)
    return np.asarray(gate_all), np.asarray(idx), np.asarray(pos < C)


def _stable_tokens(gate_all, k):
    top = -np.sort(-gate_all, axis=-1)[..., :k + 1]
    return np.all(-np.diff(top, axis=-1) > GAP, axis=-1)      # (B, S)


def _lp(rs, E, D, Fd, dtype=np.float32):
    return {"router": (rs.randn(D, E) / np.sqrt(D)).astype(np.float32),
            "w1": (rs.randn(E, D, Fd) / np.sqrt(D)).astype(dtype),
            "w3": (rs.randn(E, D, Fd) / np.sqrt(D)).astype(dtype),
            "w2": (rs.randn(E, Fd, D) / np.sqrt(Fd)).astype(dtype)}


@pytest.mark.parametrize("arch_id", ["granite_moe_1b_a400m",
                                     "llama4_scout_17b_a16e"])
def test_moe_apply_matches_reference(arch_id):
    """granite's replicated dispatch (ep=False) and llama4's expert-parallel
    one-hot einsums (ep=True), reduced (E = 4; top-2 and top-1), f32, S =
    16 so capacity drops slots."""
    m = j_get_arch(arch_id).reduced().model
    E, k, D, Fd = m.moe_experts, m.moe_topk, m.d_model, m.d_ff
    rs = np.random.RandomState(7)
    x = rs.randn(3, 16, D).astype(np.float32)
    lp = _lp(rs, E, D, Fd)
    jout, jaux = _j_moe_apply(jnp.asarray(x),
                              {n: jnp.asarray(v) for n, v in lp.items()},
                              E, k, ep=m.moe_ep)
    tlp = {n: torch.from_numpy(v) for n, v in lp.items()}
    tout, taux = TL.moe_apply(torch.from_numpy(x), tlp, E, k)
    route = TL.moe_route(torch.from_numpy(x), tlp["router"], E, k)
    gate_all, idx, keep = _ref_route(x, lp["router"], E, k)
    stable = _stable_tokens(gate_all, k)
    assert stable.mean() > 0.9, stable.mean()
    np.testing.assert_array_equal(route.idx.numpy()[stable], idx[stable])
    rows = np.all(stable, axis=1)
    assert rows.any()
    np.testing.assert_array_equal(route.keep.numpy()[rows], keep[rows])
    assert not keep.all()                        # capacity dropped slots
    np.testing.assert_allclose(tout.numpy()[rows], np.asarray(jout)[rows],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL,
                               atol=ATOL)


def test_moe_apply_bf16_matches_reference():
    """granite's layer in bf16 (router f32): the expert matmuls and the
    k-sum round to bf16, each framework in its own order."""
    m = j_get_arch("granite_moe_1b_a400m").reduced().model
    E, k, D, Fd = m.moe_experts, m.moe_topk, m.d_model, m.d_ff
    rs = np.random.RandomState(11)
    x = rs.randn(2, 16, D).astype(np.float32)
    lp = _lp(rs, E, D, Fd)
    jlp = {n: jnp.asarray(v, jnp.float32 if n == "router" else jnp.bfloat16)
           for n, v in lp.items()}
    tlp = {n: torch.from_numpy(v).to(torch.float32 if n == "router"
                                     else torch.bfloat16)
           for n, v in lp.items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    jout, _ = _j_moe_apply(xb, jlp, E, k)
    tout, _ = TL.moe_apply(torch.from_numpy(x).to(torch.bfloat16), tlp, E, k)
    assert tout.dtype == torch.bfloat16
    gate_all, _, _ = _ref_route(np.asarray(xb.astype(jnp.float32)),
                                lp["router"], E, k)
    rows = np.all(_stable_tokens(gate_all, k), axis=1)
    assert rows.any()
    np.testing.assert_allclose(
        tout.to(torch.float32).numpy()[rows],
        np.asarray(jout.astype(jnp.float32))[rows], atol=2e-2)


def _pair(arch_id, **kw):
    jcfg = dataclasses.replace(j_get_arch(arch_id).reduced().model, **kw)
    tcfg = dataclasses.replace(t_get_arch(arch_id).reduced().model, **kw)
    return j_build(jcfg), t_build(tcfg)


def _req(v):
    if isinstance(v, dict):
        return {k: _req(x) for k, x in v.items()}
    return v.requires_grad_(True)


def _batch(spec, vocab, seed):
    rs = np.random.RandomState(seed)
    return {n: (rs.randint(0, vocab, s.shape).astype(np.int32)
                if s.dtype == jnp.int32 else
                rs.randn(*s.shape).astype(np.float32))
            for n, s in spec.items()}


@pytest.mark.parametrize("arch_id", ["granite_moe_1b_a400m",
                                     "llama4_scout_17b_a16e", "internvl2_1b"])
def test_loss_and_gradient_match_reference(arch_id):
    """The MoE losses (ce + 0.01 * layer-mean aux) and the VLM loss (image
    embeds prefixed, the prefix loss-masked), with their gradients, at the
    reference's weights."""
    jb, tb = _pair(arch_id)
    jspec = jb.train_batch_spec(2, 24)
    tspec = tb.train_batch_spec(2, 24)
    assert {n: (tuple(s.shape), np.dtype(s.dtype).name)
            for n, s in jspec.items()} == \
        {n: (tuple(s.shape), str(s.dtype).split(".")[1])
         for n, s in tspec.items()}
    batch = _batch(jspec, tb.cfg.vocab, 5)
    jparams = jb.init(jax.random.PRNGKey(0))
    jloss, jgrad = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jparams, {n: jnp.asarray(v) for n, v in batch.items()})
    tparams = _req(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     tb.cfg, "cpu"))
    tloss = tb.loss_fn(tparams, {n: torch.from_numpy(v)
                                 for n, v in batch.items()})
    tgrad = torch.autograd.grad(tloss, tree_leaves(tparams))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=RTOL, atol=ATOL)
    tflat = torch.cat([g.reshape(-1) for g in tgrad]).numpy()
    jflat = np.asarray(JW.tree_spec(jgrad).flatten(jgrad))
    assert tflat.shape == jflat.shape
    np.testing.assert_allclose(tflat, jflat, rtol=RTOL, atol=ATOL)


def test_moe_params_tree_and_router_dtype():
    """The full-width granite tree: the reference's shapes, d =
    1,334,628,352 coordinates, the router f32 in a bf16 model (shapes and
    dtypes only; nothing allocated at full width)."""
    from repro_torch.core.tree import tree_paths
    from repro_torch.models.transformer import param_shapes
    jb = j_build(j_get_arch("granite_moe_1b_a400m").model)
    jshapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    want = [(tuple(s.shape), s.dtype) for s in jax.tree_util.tree_leaves(
        jshapes)]
    tcfg = t_get_arch("granite_moe_1b_a400m").model
    got = [s for _, s in tree_paths(param_shapes(tcfg))]
    assert got == [s for s, _ in want]
    assert sum(int(np.prod(s)) for s in got) == 1_334_628_352
    small = dataclasses.replace(tcfg, n_layers=1, vocab=64, d_model=64,
                                n_heads=4, n_kv_heads=2, d_ff=8)
    p = t_build(small).init(torch.Generator().manual_seed(0), "cpu")
    assert p["moe"]["router"].dtype == torch.float32
    assert p["moe"]["w1"].dtype == torch.bfloat16 == p["embed"].dtype
    paths = [path for path, _ in tree_paths(param_shapes(tcfg))]
    dtypes = {path: np.dtype(d).name for path, (_, d) in zip(paths, want)}
    assert dtypes.pop(("moe", "router")) == "float32"
    assert set(dtypes.values()) == {"bfloat16"}


def test_reduced_fed_round_granite_moe():
    """The reference's test_reduced_fed_round case granite_moe_1b_a400m in
    the port: 4 clients, E = 2, zsign(z=1,sigma=0.05), the same batch each
    round, so the loss drops over 5 rounds. Round 1's params against the
    reference's round 1 from the same weights, batch and keys: a
    pseudo-gradient within an ulp of a client's noise threshold can flip
    that client's bit, which moves the coordinate by a whole quantum q =
    server_lr * eta_1 * sigma * 2 / n_live. So every coordinate must differ
    from the reference's by a whole number of quanta within 1e-5, and at
    most 1e-3 of the coordinates by any."""
    jb, tb = _pair("granite_moe_1b_a400m")
    spec = "zsign(z=1,sigma=0.05)"
    jcfg = JF.FedConfig(n_clients=4, local_steps=2, client_lr=0.05,
                        server_lr=0.5)
    tcfg = TF.FedConfig(n_clients=4, local_steps=2, client_lr=0.05,
                        server_lr=0.5)
    jcomp, tcomp = JC.Pipeline(spec), TC.Pipeline(spec)
    jstep = jax.jit(JF.build_round_step(jb.loss_fn, jcomp, jcfg))
    tstep = TF.build_round_step(tb.loss_fn, tcomp, tcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                "cpu")
    jst = JF.init_server_state(jparams, jcfg, jcomp, jax.random.PRNGKey(1))
    tst = TF.init_server_state(tparams, tcfg, tcomp, TN.prng_key(1))
    bspec = JF.make_batch_spec(jcfg, jb.train_batch_spec(2, 32))
    toks = np.random.RandomState(2).randint(
        0, tb.cfg.vocab, bspec["tokens"].shape).astype(np.int32)
    mask = np.ones((1, 4), np.float32)
    jst, _ = jstep(jst, {"tokens": jnp.asarray(toks)}, jnp.asarray(mask))
    losses = []
    for _ in range(5):
        tst, m = tstep(tst, {"tokens": torch.from_numpy(toks)}, mask)
        assert torch.isfinite(m.loss)
        losses.append(float(m.loss))
        if len(losses) == 1:
            t1 = TW.tree_spec(tst.params).flatten(tst.params).numpy()
    assert losses[-1] < losses[0], losses
    j1 = np.asarray(JW.tree_spec(jst.params).flatten(jst.params))
    q = 0.5 * TN.eta_z(1) * 0.05 * 2 / 4
    diff = np.abs(t1 - j1)
    assert np.all(np.abs(diff / q - np.round(diff / q)) * q <= 1e-5)
    assert np.mean(diff > 1e-5) <= 1e-3, np.mean(diff > 1e-5)
