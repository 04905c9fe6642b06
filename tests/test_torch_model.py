"""The port's dense transformer against the reference's, with the
reference's weights carried across (models.api.params_from_numpy).

Reduced qwen2-0.5B in f32 (2 layers, d_model 64, vocab 997), the same
tokens in both packages. The two frameworks order f32 matmuls and
reductions differently, so loss and flattened gradient agree to
rtol 1e-4 / atol 1e-6, not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import get_arch as j_get_arch
from repro.core import wire as JW
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core import wire as TW
from repro_torch.core.tree import tree_leaves
from repro_torch.models.api import build_model as t_build
from repro_torch.models.api import params_from_numpy

# The suite runs in parallel worker processes beside the reference's
# tests; one intra-op thread per worker keeps torch from oversubscribing
# the cores they share.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _pair(q_chunk=None):
    jcfg = j_get_arch("qwen2_0_5b").reduced().model
    tcfg = t_get_arch("qwen2_0_5b").reduced().model
    if q_chunk is not None:
        jcfg = dataclasses.replace(jcfg, q_chunk=q_chunk)
        tcfg = dataclasses.replace(tcfg, q_chunk=q_chunk)
    return j_build(jcfg), t_build(tcfg)


def _loss_and_grad(jb, tb, tokens):
    jparams = jb.init(jax.random.PRNGKey(0))
    jloss, jgrad = jax.value_and_grad(jb.loss_fn)(
        jparams, {"tokens": jnp.asarray(tokens)})
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                "cpu")
    tparams = {k: _req(v) for k, v in tparams.items()}
    tloss = tb.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)})
    tgrad = torch.autograd.grad(tloss, tree_leaves(tparams))
    tflat = torch.cat([g.reshape(-1) for g in tgrad]).numpy()
    jflat = np.asarray(JW.tree_spec(jgrad).flatten(jgrad))
    return float(jloss), float(tloss.detach()), jflat, tflat


def _req(v):
    if isinstance(v, dict):
        return {k: _req(x) for k, x in v.items()}
    return v.requires_grad_(True)


@pytest.mark.parametrize("q_chunk", [None, 16])
def test_loss_and_gradient_match_reference(q_chunk):
    """q_chunk=None: seq 32 <= 512 takes the single-block attention; 16
    takes the KV-chunked flash attention and a 4-chunk cross entropy."""
    jb, tb = _pair(q_chunk)
    tokens = np.random.RandomState(1).randint(
        0, tb.cfg.vocab, (2, 32 if q_chunk is None else 64)).astype(np.int32)
    jl, tl, jg, tg = _loss_and_grad(jb, tb, tokens)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert jg.shape == tg.shape
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def test_params_from_numpy_shapes_and_errors():
    jb, tb = _pair()
    tree = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tb.cfg, "cpu")
    assert TW.tree_spec(params).shapes == JW.tree_spec(tree).shapes
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    extra = dict(tree, junk=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(extra, tb.cfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "lnf"}
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(missing, tb.cfg, "cpu")
    bad = dict(tree, lnf=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, tb.cfg, "cpu")


def test_full_width_config_matches_reference_shapes():
    """qwen2-0.5B at full width: the port's tree has the reference's shapes
    and d = 494,032,768 wire coordinates (shapes only, nothing allocated)."""
    from repro_torch.models.transformer import param_shapes
    jcfg = j_get_arch("qwen2_0_5b").model
    tcfg = t_get_arch("qwen2_0_5b").model
    jshapes = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    want = [tuple(s.shape) for s in jax.tree_util.tree_leaves(jshapes)]
    from repro_torch.core.tree import tree_paths
    got = [s for _, s in tree_paths(param_shapes(tcfg))]
    assert got == want
    assert sum(int(np.prod(s)) for s in got) == 494_032_768
    assert tcfg.dtype == torch.bfloat16
