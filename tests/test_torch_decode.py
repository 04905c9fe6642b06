"""The port's KV-cache decode against the reference's: ``attention_decode``
(GQA, and a sliding window of 8), ``decode_step`` over many positions with
the reference's weights carried across (``params_from_numpy``), decode
against the teacher-forced forward, and the out-of-range position.

Reduced f32 configs; inputs are numpy arrays from a seed. The two
frameworks order f32 matmuls and reductions differently, so logits, outputs
and caches agree to rtol 1e-4 / atol 1e-6 (the tolerance of
``tests/test_torch_model.py``), not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model as t_build
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _attn_pair(window):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, qkv_bias=True,
              sliding_window=window)
    return JL.AttnCfg(**kw), TL.AttnCfg(**kw)


def _lp(rs):
    shapes = {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32), "wo": (64, 64),
              "bq": (64,), "bk": (32,), "bv": (32,)}
    return {k: (rs.randn(*s) / 8).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("position", [0, 5, 19])
def test_attention_decode_matches_reference(window, position):
    rs = np.random.RandomState(position + 31 * window)
    jcfg, tcfg = _attn_pair(window)
    lp = _lp(rs)
    x = rs.randn(3, 1, 64).astype(np.float32)
    ck = rs.randn(3, 20, 2, 16).astype(np.float32)
    cv = rs.randn(3, 20, 2, 16).astype(np.float32)
    jy, jk, jv = JL.attention_decode(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()}, jcfg,
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(position))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ty, tk2, tv2 = TL.attention_decode(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()},
        tcfg, tk, tv, position)
    # written in place
    assert tk2 is tk and tv2 is tv
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    # only the slot at `position` changed
    changed = np.any(tk.numpy() != ck, axis=(0, 2, 3))
    assert changed.tolist() == [s == position for s in range(20)]


def _pair(arch_id):
    jcfg = j_get_arch(arch_id).reduced().model
    tcfg = t_get_arch(arch_id).reduced().model
    return j_build(jcfg), t_build(tcfg)


def _carry(jb, tb, seed=0):
    jparams = jb.init(jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tb.cfg, "cpu")


@pytest.mark.parametrize("arch_id", ["qwen2_0_5b", "h2o_danube_3_4b",
                                     "granite_moe_1b_a400m"])
def test_decode_step_matches_reference(arch_id):
    """12 greedy-free steps of 2 requests from the same tokens: the
    logits at every step and the final caches agree. h2o-danube's reduced
    config has a sliding window of 8, which 12 steps cross."""
    jb, tb = _pair(arch_id)
    jparams, tparams = _carry(jb, tb)
    toks = np.random.RandomState(3).randint(0, tb.cfg.vocab, (2, 12))
    jcache, tcache = jb.init_cache(2, 16), tb.init_cache(2, 16, "cpu")
    jstep = jax.jit(jb.decode_step)
    for t in range(12):
        jl, jcache = jstep(jparams, jcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t))
        tl, tcache = tb.decode_step(tparams, tcache,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, tb.cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
    for k in ("k", "v"):
        assert tcache[k].shape == jcache[k].shape
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch_id", ["qwen2_0_5b", "h2o_danube_3_4b"])
def test_decode_matches_forward(arch_id):
    """The reference's test_decode_matches_forward_dense, in the port: KV
    decode = teacher-forced forward logits, position by position, within
    the reference's 2e-2 (and the forward within rtol 1e-4 of the
    reference's forward). Dense archs only, as in the reference: an MoE
    forward over S tokens drops slots past its capacity int(S*k/E*1.25),
    one decoded token never does."""
    jb, tb = _pair(arch_id)
    jparams, tparams = _carry(jb, tb)
    toks = np.random.RandomState(1).randint(0, tb.cfg.vocab, (2, 8))
    full, aux = TT.forward(tparams, torch.from_numpy(toks), tb.cfg)
    from repro.models import transformer as JT
    jfull, jaux = JT.forward(jparams, jnp.asarray(toks), jb.cfg)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    cache = tb.init_cache(2, 8, "cpu")
    outs = []
    for t in range(8):
        lg, cache = tb.decode_step(tparams, cache,
                                   torch.from_numpy(toks[:, t:t + 1]), t)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    assert float(torch.max(torch.abs(dec - full))) < 2e-2


def test_out_of_range_position_raises_where_reference_clamps():
    """The reference's dynamic_update_slice clamps a position past the
    cache into its last slot, overwriting it; the port raises ValueError
    and leaves the cache untouched."""
    jb, tb = _pair("qwen2_0_5b")
    jparams, tparams = _carry(jb, tb)
    tok = np.array([[5], [7]])
    jcache = jb.init_cache(2, 4)
    _, jc2 = jb.decode_step(jparams, jcache, jnp.asarray(tok), jnp.int32(4))
    k = np.asarray(jc2["k"])
    assert np.any(k[:, :, 3] != 0) and not np.any(k[:, :, :3])
    tcache = tb.init_cache(2, 4, "cpu")
    for bad in (4, 9, -1):
        with pytest.raises(ValueError, match="outside the cache"):
            tb.decode_step(tparams, tcache, torch.from_numpy(tok), bad)
    assert not torch.any(tcache["k"]) and not torch.any(tcache["v"])
    # the last slot itself is fine
    tb.decode_step(tparams, tcache, torch.from_numpy(tok), 3)
    assert torch.any(tcache["k"][:, :, 3]) and not torch.any(
        tcache["k"][:, :, :3])


def test_init_cache_shapes_and_dtype():
    cfg = dataclasses.replace(t_get_arch("qwen2_0_5b").model, n_layers=3)
    cache = TT.init_cache(cfg, 4, 32)
    assert cache["k"].shape == (3, 4, 32, 2, 64)
    assert cache["k"].dtype == torch.bfloat16 == cache["v"].dtype
    assert not torch.any(cache["k"])
