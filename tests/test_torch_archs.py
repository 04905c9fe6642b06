"""The port's architecture registry against the reference's: the seven
transformer archs (dense, moe, vlm) build, take a train step and a decode
step at their reduced sizes (the reference's
``tests/test_archs_smoke.py``), and each full config equals the
reference's on every field the port has (dtypes mapped); the reference's
other fields are the known set that no port code reads yet; the three
archs of other
families raise, naming ROADMAP item 16. The launcher's extra batch leaves
(the vlm's image embeds) follow jax's ``normal`` draw, and the MoE and VLM
archs run through every cohort plan of ``launch.train``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as JCommon
from repro_torch.configs import common as TCommon
from repro_torch.core import noise as TN
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import train as TT
from repro_torch.models.api import build_model

torch.set_num_threads(1)

TRANSFORMERS = ["granite_moe_1b_a400m", "llama4_scout_17b_a16e",
                "granite_3_8b", "qwen2_0_5b", "h2o_danube_3_4b",
                "qwen2_5_32b", "internvl2_1b"]
UNPORTED = ["jamba_1_5_large_398b", "xlstm_350m", "seamless_m4t_large_v2"]
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


#: the reference's config fields that the port leaves out until code of its
#: own reads them (ROADMAP queue 3): the dry-run's training knobs and
#: shape grid, the expert-parallel and remat layouts, encdec's source share
OMITTED_ARCH = {"big", "seq_client_groups", "local_steps", "client_lr",
                "server_lr", "zsign_z", "zsign_sigma"}
OMITTED_MODEL = {"moe_ep", "src_frac", "remat_save_weights"}


def test_registry_lists_the_transformer_archs():
    assert sorted(TCommon.list_archs()) == sorted(TRANSFORMERS)
    assert sorted(TRANSFORMERS + UNPORTED) == sorted(JCommon.list_archs())


@pytest.mark.parametrize("arch_id", UNPORTED)
def test_unported_archs_raise_naming_item_16(arch_id):
    with pytest.raises(NotImplementedError, match="item 16"):
        TCommon.get_arch(arch_id)


@pytest.mark.parametrize("family", ["hybrid", "xlstm", "encdec"])
def test_unported_families_raise_naming_item_16(family):
    cfg = dataclasses.replace(TCommon.get_arch("qwen2_0_5b").reduced().model,
                              family=family)
    with pytest.raises(NotImplementedError, match="item 16"):
        build_model(cfg)


def _fields(arch, omit_arch=(), omit_model=()):
    d = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)
         if f.name != "model" and f.name not in omit_arch}
    m = {f.name: getattr(arch.model, f.name)
         for f in dataclasses.fields(arch.model) if f.name not in omit_model}
    return d, m


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch_id", TRANSFORMERS)
def test_config_equals_reference_field_for_field(arch_id, reduced):
    ja, ta = JCommon.get_arch(arch_id), TCommon.get_arch(arch_id)
    if reduced:
        ja, ta = ja.reduced(), ta.reduced()
    jd, jm = _fields(ja, OMITTED_ARCH, OMITTED_MODEL)
    td, tm = _fields(ta)
    assert td == jd
    jm["dtype"] = _DTYPES[jm["dtype"]]
    assert tm == jm


def _batch(spec, vocab, seed):
    gen = torch.Generator().manual_seed(seed)
    return {n: (torch.randint(0, vocab, s.shape, generator=gen)
                if s.dtype == torch.int32 else
                torch.randn(s.shape, generator=gen, dtype=s.dtype))
            for n, s in spec.items()}


@pytest.mark.parametrize("arch_id", TRANSFORMERS)
def test_reduced_config_train_step(arch_id):
    arch = TCommon.get_arch(arch_id).reduced()
    bundle = build_model(arch.model)
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = _batch(bundle.train_batch_spec(2, 32), arch.model.vocab, 0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = bundle.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss) and float(loss.detach()) > 0.0
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


@pytest.mark.parametrize("arch_id", TRANSFORMERS)
def test_reduced_config_decode_step(arch_id):
    arch = TCommon.get_arch(arch_id).reduced()
    bundle = build_model(arch.model)
    params = bundle.init(torch.Generator().manual_seed(1))
    cache = bundle.init_cache(2, 64)
    logits, cache2 = bundle.decode_step(params, cache,
                                        torch.zeros((2, 1), dtype=torch.long),
                                        5)
    assert logits.shape == (2, 1, arch.model.vocab)
    assert bool(torch.all(torch.isfinite(logits)))
    assert cache2.keys() == cache.keys()
    assert all(cache2[k].shape == cache[k].shape for k in cache)


def test_extra_leaves_follow_jax_normal():
    """The vlm's image embeds of round t: jax.random.normal on
    fold_in(PRNGKey(7), t) as the reference's launcher draws them, to rtol
    1e-5 / atol 1e-6 (erfinv and the multiply-add round differently in the
    two frameworks; the uniforms beneath are the same bits)."""
    spec = build_model(TCommon.get_arch("internvl2_1b").reduced().model) \
        .train_batch_spec(2, 16)
    layout = (2, 3, 2, 2)
    for t in (0, 5):
        got = TT.extra_leaves(spec, layout, t, "cpu")
        assert list(got) == ["img_embeds"]
        key = jax.random.fold_in(jax.random.PRNGKey(7), t)
        want = jax.random.normal(key, layout + (4, 64), jnp.float32)
        np.testing.assert_allclose(got["img_embeds"].numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    assert TN._NORMAL_LO == float(lo)
    assert TN._NORMAL_SCALE == float(np.float32(1) - lo)
    assert TN._SQRT2_F32 == float(np.float32(np.sqrt(2)))


PLANS = [["--clients", "4", "--cohort", "vmap"],
         ["--clients", "2", "--groups", "2", "--cohort", "vmap"],
         ["--clients", "4", "--cohort", "stream(shard=3)"],
         ["--clients", "4", "--cohort", "stream(shard=3,feed=host)"]]


@pytest.mark.parametrize("arch_id", ["internvl2_1b", "granite_moe_1b_a400m"])
def test_train_run_every_cohort_plan(arch_id):
    """One round of each plan (vmap, group scan, stream, host-fed stream)
    through launch.train.run from the same seeds: every plan gives the same
    params bit for bit and the same loss."""
    outs = []
    for plan in PLANS:
        args = TT.parse_args(["--arch", arch_id, "--reduced", "--rounds",
                              "1", "--local-steps", "2", "--seq-len", "16",
                              "--device", "cpu"] + plan)
        got = {}
        hist = TT.run(args, on_round=lambda t, b, a, m, s: got.update(a=a))
        assert torch.isfinite(hist[0].loss)
        outs.append((float(hist[0].loss), got["a"].params))
    for loss, params in outs[1:]:
        assert loss == outs[0][0]
        for a, b in zip(tree_leaves(params), tree_leaves(outs[0][1])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
