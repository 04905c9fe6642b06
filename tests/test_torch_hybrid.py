"""The port's Jamba-style hybrid (``repro_torch.models.hybrid``) against the
reference's ``repro.models.hybrid``: the parameter tree at full width
(shapes and dtypes only), and the reduced arch's loss, gradients and decode
steps at the reference's weights (f32).

Tolerances: the loss within rtol 1e-5, gradients within 1e-4 of the
largest |grad|, decode logits and caches within 1e-5 of the largest
|value| (matmuls, the mamba scan's state sum and the MoE's f32 router in
each framework's order). MoE routing near ties: a token whose gaps between
its k+1 largest gates are within 1e-5 could route differently in the two
packages (``tests/test_torch_moe.py``); the seeds below are the first
tried and route alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.common import get_arch as j_get_arch
from repro.core import wire as JW
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.models import hybrid as TH
from repro_torch.models.api import build_model as t_build
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

ARCH = "jamba_1_5_large_398b"


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _pair(**kw):
    jcfg = dataclasses.replace(j_get_arch(ARCH).reduced().model, **kw)
    tcfg = dataclasses.replace(t_get_arch(ARCH).reduced().model, **kw)
    jb, tb = j_build(jcfg), t_build(tcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                device="cpu")
    return jb, tb, jparams, tparams


def test_full_width_tree_equals_reference():
    """jamba-1.5-large-398b: the reference's tree (eval_shape) against the
    port's (a meta-device build): 398,017,208,320 coordinates; a_log,
    d_skip and the routers f32 in a bf16 model; one mamba sublayer at full
    width has 420,315,136."""
    jshapes = jax.eval_shape(j_build(j_get_arch(ARCH).model).init,
                             jax.random.PRNGKey(0))
    want = {tuple(str(getattr(k, "key", k)) for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    cfg = t_get_arch(ARCH).model
    got = dict(tree_paths(TH.param_shapes(cfg)))
    assert got == {p: tuple(s.shape) for p, s in want.items()}
    assert sum(int(np.prod(s)) for s in got.values()) == 398_017_208_320
    f32 = {p for p, s in want.items() if s.dtype == jnp.float32}
    assert f32 == {("mamba", "a_log"), ("mamba", "d_skip"),
                   ("moe", "router")}
    per_sub = sum(int(np.prod(s[2:])) for p, s in got.items()
                  if p[0] == "mamba")
    assert per_sub == 420_315_136
    meta = TH.init_params(None, cfg, device="meta")
    assert {p: str(t.dtype).split(".")[1] for p, t in tree_paths(meta)} == \
        {p: s.dtype.name for p, s in want.items()}


def test_reduced_config_is_one_super_block():
    cfg = t_get_arch(ARCH).reduced().model
    assert cfg.n_layers == 8 and cfg.n_layers // TH.SUB == 1
    shapes = TH.param_shapes(cfg)
    assert shapes["mamba"]["in_proj"][:2] == (1, 7)
    assert shapes["moe"]["w1"][:3] == (1, 4, 4)
    assert shapes["mlp"]["w1"][:2] == (1, 4)
    assert shapes["ln_mix"] == shapes["ln_ffn"] == (1, 8, 64)


def test_loss_and_gradients_match_reference():
    """ce + 0.01 * aux / (n_layers // 2), aux summed over the 4 MoE
    sublayers; S = 32."""
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
    _close(tflat, JW.tree_spec(jgrad).flatten(jgrad), 1e-4)
    x, aux = TH.forward_hidden(tparams, torch.from_numpy(toks), tb.cfg)
    assert float(aux) > 0 and x.shape == (2, 32, 64)


def test_decode_steps_match_reference():
    """6 decode steps (attention K/V, mamba h and conv tail, the MoE at one
    token a row): logits and every cache leaf against the reference's."""
    jb, tb, jparams, tparams = _pair()
    toks = np.random.RandomState(6).randint(0, tb.cfg.vocab, (3, 6))
    jcache, tcache = jb.init_cache(3, 8), tb.init_cache(3, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    jstep = jax.jit(jb.decode_step)
    for t in range(6):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = tb.decode_step(tparams, tcache,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl.numpy(), jl)
    for k in tcache:
        _close(tcache[k].numpy(), jcache[k])
