"""The port's architecture registry against the reference's: all ten
archs (dense, moe, vlm, hybrid, xlstm, encdec) build, take a train step and
a decode step at their reduced sizes (the reference's
``tests/test_archs_smoke.py``), and each full and reduced config equals the
reference's on every field the port has (dtypes mapped); the reference's
other fields are the known set that no port code reads yet. The launcher's
extra batch leaves (the vlm's image embeds, the encdec's source frames)
follow jax's ``normal`` draw, its tokens are cut to the text length, and
the MoE and VLM archs run through every cohort plan of ``launch.train``.
Every public entry point that makes tensors defaults to ``cuda`` and
raises without a card rather than running on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as JCommon
from repro_torch.configs import common as TCommon
from repro_torch.core import noise as TN
from repro.models.api import build_model as JBuild
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.launch import train as TT
from repro_torch.models import mlp as TM
from repro_torch.models.api import build_model, family_module
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

TRANSFORMERS = ["granite_moe_1b_a400m", "llama4_scout_17b_a16e",
                "granite_3_8b", "qwen2_0_5b", "h2o_danube_3_4b",
                "qwen2_5_32b", "internvl2_1b"]
RECURRENT_ENCDEC = ["jamba_1_5_large_398b", "xlstm_350m",
                    "seamless_m4t_large_v2"]
ARCHS = TRANSFORMERS + RECURRENT_ENCDEC
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


#: the reference's config fields that the port leaves out until code of its
#: own reads them (none since the MoE families run on a grid: ``moe_ep``
#: is compared like every other field)
OMITTED_ARCH = set()
OMITTED_MODEL = set()


def test_registry_lists_the_transformer_archs():
    """The registry lists every arch of the reference's, the transformers
    and the other families alike."""
    assert TCommon.list_archs() == JCommon.list_archs()
    assert sorted(ARCHS) == sorted(JCommon.list_archs())


@pytest.mark.parametrize("arch_id", ARCHS)
def test_build_model_takes_every_family(arch_id):
    """The bundle of each arch at full width builds without allocating; its
    family module's parameter tree has the reference's coordinate count."""
    cfg = TCommon.get_arch(arch_id).model
    bundle = build_model(cfg)
    jb = JBuild(JCommon.get_arch(arch_id).model)
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        jax.eval_shape(jb.init, jax.random.PRNGKey(0))))
    got = sum(int(np.prod(s)) for _, s in
              tree_paths(family_module(bundle.cfg).param_shapes(bundle.cfg)))
    assert got == want


def test_unknown_family_raises():
    cfg = dataclasses.replace(TCommon.get_arch("qwen2_0_5b").reduced().model,
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg)


def _fields(arch, omit_arch=(), omit_model=()):
    d = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)
         if f.name != "model" and f.name not in omit_arch}
    m = {f.name: getattr(arch.model, f.name)
         for f in dataclasses.fields(arch.model) if f.name not in omit_model}
    return d, m


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch_id", ARCHS)
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


@pytest.mark.parametrize("arch_id", ARCHS)
def test_reduced_config_train_step(arch_id):
    arch = TCommon.get_arch(arch_id).reduced()
    bundle = build_model(arch.model)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(bundle.train_batch_spec(2, 32), arch.model.vocab, 0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = bundle.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss) and float(loss.detach()) > 0.0
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_reduced_config_decode_step(arch_id):
    arch = TCommon.get_arch(arch_id).reduced()
    bundle = build_model(arch.model)
    params = bundle.init(torch.Generator().manual_seed(1), device="cpu")
    cache = bundle.init_cache(2, 64, device="cpu")
    shapes = [tuple(v.shape) for v in tree_leaves(cache)]
    logits, cache2 = bundle.decode_step(params, cache,
                                        torch.zeros((2, 1), dtype=torch.long),
                                        5)
    assert logits.shape == (2, 1, arch.model.vocab)
    assert bool(torch.all(torch.isfinite(logits)))
    assert [tuple(v.shape) for v in tree_leaves(cache2)] == shapes


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


def test_launcher_draws_encdec_frames_and_cuts_tokens(monkeypatch):
    """One round of seamless-m4t (reduced) through launch.train.run: the
    batch's ``embeds`` are jax's ``normal`` on fold_in(PRNGKey(7), 0) over
    layout + (8, 64) (seq 16 at src_frac 0.5), and its tokens are the first
    8 of the stream's 16 (the reference's launcher cut)."""
    from repro_torch.core import fedavg as TF
    from repro_torch.data.synthetic import TokenStream
    seen = []
    build = TF.build_round_step

    def spy(*a, **k):
        step = build(*a, **k)

        def run_step(state, batch, mask):
            seen.append(batch)
            return step(state, batch, mask)
        return run_step

    monkeypatch.setattr(TF, "build_round_step", spy)
    arch = TCommon.get_arch("seamless_m4t_large_v2").reduced()
    hist = TT.run(TT.parse_args(
        ["--arch", "seamless_m4t_large_v2", "--reduced", "--rounds", "1",
         "--clients", "2", "--local-steps", "1", "--seq-len", "16",
         "--device", "cpu"]))
    assert torch.isfinite(hist[0].loss)
    (batch,) = seen
    layout = (1, 2, 1, 2)
    assert sorted(batch) == ["embeds", "tokens"]
    want = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(7), 0),
                             layout + (8, 64), jnp.float32)
    np.testing.assert_allclose(batch["embeds"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    toks = TokenStream(vocab=arch.model.vocab).round_batch(0, layout, 16)
    assert torch.equal(batch["tokens"], toks[..., :8])


def _entry_points():
    cfg = TCommon.get_arch("qwen2_0_5b").reduced().model
    bundle = build_model(cfg)
    tree = {"w1": np.zeros((4, 8), np.float32)}
    init, _, _ = TM.mlp_loss_builder(4, 2, width=8)
    ref = JBuild(JCommon.get_arch("qwen2_0_5b").reduced().model).init
    return {
        "bundle.init": lambda: bundle.init(torch.Generator()),
        "bundle.init_cache": lambda: bundle.init_cache(2, 8),
        "params_from_numpy": lambda: params_from_numpy(
            jax.tree.map(np.asarray, ref(jax.random.PRNGKey(0))), cfg),
        "mlp.init": lambda: init(torch.Generator()),
        "mlp.params_from_numpy": lambda: TM.params_from_numpy(tree),
    }


@pytest.mark.parametrize("name", ["bundle.init", "bundle.init_cache",
                                  "params_from_numpy", "mlp.init",
                                  "mlp.params_from_numpy"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(name):
    """Called with no device, each public entry point asks for ``cuda``;
    with no card visible it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _entry_points()[name]()


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
