"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
reference's ``repro.models.encdec`` at the reduced seamless-m4t-large-v2
config and the reference's weights (f32): the bidirectional encoder, the
loss and its gradients, ``prefill_memory``, decode steps against a cache
filled by it, and the unmasked cross-attention.

Tolerances: outputs, logits and caches within 1e-5 of the largest |value|,
the loss within rtol 1e-5 and gradients within 1e-4 of the largest |grad|
(matmul and softmax orders differ between the frameworks).

Standing difference kept as the reference has it: cross-attention has no
source mask, so zero slots of a memory cache longer than the frames filled
take softmax weight in both packages; the port's ``prefill_cache`` refuses
a frame count other than the cache's ``src_len``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import get_arch as j_get_arch
from repro.core import wire as JW
from repro.models import encdec as JE
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch as t_get_arch
from repro_torch.core.tree import tree_leaves
from repro_torch.models import encdec as TE
from repro_torch.models.api import build_model as t_build
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

ARCH = "seamless_m4t_large_v2"


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    err = np.max(np.abs(np.asarray(got, np.float32) - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


@pytest.fixture(scope="module")
def pair():
    jb = j_build(j_get_arch(ARCH).reduced().model)
    tb = t_build(t_get_arch(ARCH).reduced().model)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                device="cpu")
    return jb, tb, jparams, tparams


def _frames(seed, b, s):
    return np.random.RandomState(seed).randn(b, s, 64).astype(np.float32)


def test_encode_matches_reference(pair):
    """Bidirectional: the last frame changes the first frame's memory."""
    jb, tb, jparams, tparams = pair
    emb = _frames(1, 2, 12)
    jm = JE.encode(jparams, jnp.asarray(emb), jb.cfg)
    tm = TE.encode(tparams, torch.from_numpy(emb), tb.cfg)
    _close(tm.numpy(), jm)
    emb[:, -1] += 1.0
    moved = TE.encode(tparams, torch.from_numpy(emb), tb.cfg)
    assert not torch.allclose(moved[:, 0], tm[:, 0])


def test_loss_and_gradients_match_reference(pair):
    """The bundle's batch: embeds (2, 16, D) f32 and tokens (2, 16) from
    seq 32 at src_frac 0.5."""
    jb, tb, jparams, tparams = pair
    spec = tb.train_batch_spec(2, 32)
    assert (spec["embeds"].shape, spec["tokens"].shape) == \
        ((2, 16, 64), (2, 16))
    assert {n: s.shape for n, s in jb.train_batch_spec(2, 32).items()} == \
        {n: s.shape for n, s in spec.items()}
    batch = {"embeds": _frames(2, 2, 16),
             "tokens": np.random.RandomState(3).randint(
                 0, tb.cfg.vocab, (2, 16)).astype(np.int32)}
    jloss, jgrad = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jparams, {n: jnp.asarray(v) for n, v in batch.items()})
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tloss = tb.loss_fn(tparams, {n: torch.from_numpy(v)
                                 for n, v in batch.items()})
    tgrad = torch.autograd.grad(tloss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    tflat = torch.cat([g.reshape(-1) for g in tgrad]).numpy()
    _close(tflat, JW.tree_spec(jgrad).flatten(jgrad), 1e-4)


def test_prefill_memory_matches_reference(pair):
    jb, tb, jparams, tparams = pair
    emb = _frames(4, 2, 10)
    jk, jv = JE.prefill_memory(jparams, jnp.asarray(emb), jb.cfg)
    tk, tv = TE.prefill_memory(tparams, torch.from_numpy(emb), tb.cfg)
    assert tk.shape == jk.shape == (2, 2, 10, 4, 16)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


def _decode(jb, tb, jparams, tparams, jcache, tcache, steps=5):
    toks = np.random.RandomState(7).randint(0, tb.cfg.vocab, (2, steps))
    out = []
    for t in range(steps):
        jl, jcache = jb.decode_step(jparams, jcache,
                                    jnp.asarray(toks[:, t:t + 1]), t)
        tl, tcache = tb.decode_step(tparams, tcache,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl.numpy(), jl)
        out.append(tl)
    for k in tcache:
        _close(tcache[k].numpy(), jcache[k])
    return torch.cat(out, dim=1)


def test_decode_steps_with_prefilled_cache_match_reference(pair):
    """A cache of src_len 10 filled by prefill_cache over 10 frames, then 5
    decode steps: logits and every cache leaf."""
    jb, tb, jparams, tparams = pair
    emb = _frames(5, 2, 10)
    tcache = TE.init_cache(tb.cfg, 2, 8, 10, device="cpu")
    TE.prefill_cache(tparams, tcache, torch.from_numpy(emb), tb.cfg)
    jk, jv = JE.prefill_memory(jparams, jnp.asarray(emb), jb.cfg)
    jcache = dict(JE.init_cache(jb.cfg, 2, 8, 10), mem_k=jk, mem_v=jv)
    _decode(jb, tb, jparams, tparams, jcache, tcache)


def test_unmasked_source_slots_take_weight_as_in_reference(pair):
    """6 frames in a cache of 8 memory slots (slots 6, 7 stay zero): the
    port decodes as the reference does on that cache, and both differ from
    the cache of exactly 6 slots: the zero slots took softmax weight."""
    jb, tb, jparams, tparams = pair
    emb = torch.from_numpy(_frames(6, 2, 6))
    ks, vs = TE.prefill_memory(tparams, emb, tb.cfg)
    padded = TE.init_cache(tb.cfg, 2, 8, 8, device="cpu")
    padded["mem_k"][:, :, :6], padded["mem_v"][:, :, :6] = ks, vs
    jcache = {k: jnp.asarray(v.numpy()) for k, v in padded.items()}
    got = _decode(jb, tb, jparams, tparams, jcache, padded)
    exact = TE.prefill_cache(tparams, TE.init_cache(tb.cfg, 2, 8, 6,
                                                    device="cpu"), emb,
                             tb.cfg)
    want = _decode(jb, tb, jparams, tparams,
                   {k: jnp.asarray(v.numpy()) for k, v in exact.items()},
                   exact)
    assert float((got - want).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="no source mask"):
        TE.prefill_cache(tparams, TE.init_cache(tb.cfg, 2, 8, 8,
                                                device="cpu"), emb, tb.cfg)


def test_bundle_cache_has_2048_memory_slots(pair):
    _, tb, _, _ = pair
    cache = tb.init_cache(1, 4, device="cpu")
    assert cache["mem_k"].shape == (2, 1, 2048, 4, 16)
    assert cache["k"].shape == (2, 1, 4, 4, 16)
