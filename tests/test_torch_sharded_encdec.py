"""The enc-dec family's train cell on the port's model-sharded grid against
the reference and against the port's one-process functions.

Four gloo ranks on the CPU (``tests/torch_sharded_encdec_ranks.py``) are
spawned ONCE for the module and run, on (data, model) grids of 2 x 2 and
1 x 4, one round each of the reduced seamless-m4t-large-v2 (2 encoder + 2
decoder layers, d_model 64, 4 heads, vocab 997, f32) on the regular plan
(a client a data row, the replica and the sequence over `model`), seq 64:
32 source frames and 32 target tokens, cut into 2 or 4 sequence shards.
The encoder's bidirectional self-attention gathers K and V along the
sequence; its final memory is gathered once and every decoder layer's
cross-attention runs this rank's query rows over all of it.

The reference computes each client's loss and gradient in a subprocess
(``tests/torch_recurrent_grid_reference.py``, one device: the enc-dec has
no shard count of its own). Against it: each rank's loss within rtol 1e-5
of the mean of the clients' reference losses; each client's
pseudo-gradient (its ranks' ranges joined) within relative L2 1e-4 of the
reference's, leaf by leaf (the grid's sums run in another order: the
sequence-split token sums, the reduce-scatters of the weight and memory
gradients); wire bits that differ from the port's encode of the
reference's gradient only where the two pseudo-gradients differ; params at
every coordinate whose bits agree within rtol 1e-5 of the reference's
round on its own gradients (the same keys).

Against the port's one-process loss and gradient: each leaf within
relative L2 5e-5, the loss within rtol 1e-6; also with a vocab of 256,
which splits over `model`, so the tied table is stored sharded, gathered
once and its gradient from the lookup and the head summed before one
reduce-scatter. Remat on, off and with the gathered weights kept or not
are bit-identical. The block cases hold the cross-attention (this rank's
query rows over the memory gathered along the sequence) and the
encoder's attention (K and V gathered, every key unmasked at its global
position) across 2 and 4 sequence shards against the one-process block
on the same numpy inputs: output rows bit for bit, the inputs' gradients
and the weights' gradients summed over the ranks within 1e-5 of the
largest |value|. The memory's gather and its gradient's reduce-scatter are
counted in closed form; the spec rules equal the reference's on the
enc-dec leaves and its frames; the dry run prints the train cell at a cut
depth on 16 x 16 and 2 x 16 x 16.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_sharded_encdec_ranks as ER
import torch_sharded_ranks as R
from repro.configs.common import SHAPES as JSHAPES
from repro.configs.common import get_arch as j_arch
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro.launch import sharding as JSH
from repro.models.api import build_model as j_build
from repro_torch.configs.common import SHAPES, ShapeCfg, get_arch
from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model, family_module, \
    params_from_numpy
from test_torch_sharded_round import _Grid, _bits, _flat, assemble

torch.set_num_threads(1)

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
#: against the reference: a leaf's relative L2 (the module doc says why)
REF_LEAF_L2 = 1e-4
#: against the port's one-process round: a leaf's relative L2, the loss
ONE_LEAF_L2, ONE_LOSS_RTOL = 5e-5, 1e-6
#: a block against the one-process block: relative to the largest |value|
BLOCK_REL = 1e-5
_REF_ROUNDS = ["ed_22", "ed_14"]
_VARIANTS = {"ed_22_noremat": "ed_22", "ed_22_noweights": "ed_22"}
S_SRC = S_TGT = ER.SEQ // 2


def _jcfg(vocab=None):
    cfg = j_arch(ER.ARCH_ID).reduced().model
    return cfg if vocab is None else dataclasses.replace(cfg, vocab=vocab)


def _inputs():
    rng = np.random.default_rng(17)
    params = jax.tree.map(np.asarray, j_build(_jcfg()).init(
        jax.random.PRNGKey(0)))
    params_v256 = jax.tree.map(np.asarray, j_build(_jcfg(256)).init(
        jax.random.PRNGKey(0)))
    D = _jcfg().d_model
    batches = {}
    for name, (shape, opt) in ER.ROUNDS.items():
        if name in _VARIANTS:
            continue
        plan = ER.plan_for(_Grid(shape))
        lead = (plan.client_groups, plan.n_clients, 1, plan.micro)
        batches[name] = {
            "embeds": rng.standard_normal(lead + (S_SRC, D)).astype(
                np.float32),
            "tokens": rng.integers(0, opt.get("vocab", _jcfg().vocab),
                                   lead + (S_TGT,), dtype=np.int32)}
    for name, base in _VARIANTS.items():
        batches[name] = batches[base]
    rs = np.random.RandomState(23)
    blocks = {}
    for name, (_, kind, B, S) in ER.BLOCKS.items():
        lp = {k: (rs.randn(D, D) * 0.2).astype(np.float32)
              for k in ("wq", "wk", "wv", "wo")}
        blocks[name] = {"lp": lp,
                        "x": rs.randn(B, S, D).astype(np.float32),
                        "mem": rs.randn(B, S, D).astype(np.float32),
                        "dy": rs.randn(B, S, D).astype(np.float32)}
    ref = {name: {"arch_id": ER.ARCH_ID, "params": params, "mesh": None,
                  "tokens": batches[name]["tokens"],
                  "embeds": batches[name]["embeds"]}
           for name in _REF_ROUNDS}
    return ({"params": params, "params_v256": params_v256,
             "batches": batches, "blocks": blocks}, {"rounds": ref})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    out = tmp_path_factory.mktemp("sharded_encdec")
    inputs, ref_in = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with open(out / "ref_in.pkl", "wb") as f:
        pickle.dump(ref_in, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_recurrent_grid_reference"
                                      ".py"),
         str(out / "ref_in.pkl"), str(out / "ref_out.pkl")], env=env)
    try:
        mp.spawn(ER.main, args=(WORLD, str(out / "store"), str(out)),
                 nprocs=WORLD, join=True)
    finally:
        assert ref.wait(timeout=600) == 0
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(out / "ref_out.pkl", "rb") as f:
        want = pickle.load(f)
    return inputs, ranks, want


def _model(name):
    return ER.arch(vocab=ER.ROUNDS[name][1].get("vocab")).model


def _specs(name):
    grid = _Grid(ER.ROUNDS[name][0])
    plan = ER.plan_for(grid)
    m = _model(name)
    return grid, plan, dict(tree_paths(SH.param_specs(
        family_module(m).param_shapes(m), grid, plan)))


def _client_of(rk, g):
    return g * rk["plan"]["n_clients"] + rk["coords"]["data"]


def _leaf_ranges(name):
    m = _model(name)
    out, off = [], 0
    for path, shape in tree_paths(family_module(m).param_shapes(m)):
        n = int(np.prod(shape))
        out.append((path, off, off + n))
        off += n
    return out


def _joined(ranks, name, d):
    """Each client's pseudo-gradient, its ranks' ranges joined."""
    out = {}
    for rk in ranks:
        r = rk[name]
        lo, hi = r["bounds"]
        real = min(hi, d) - lo
        for g, x in enumerate(r["x"]):
            out.setdefault(_client_of(r, g), np.full(d, np.nan,
                                                     np.float32))[
                lo:lo + real] = x[0, :real]
    assert all(not np.isnan(v).any() for v in out.values())
    return out


def _leaf_l2(name, got, want):
    worst = (0.0, None)
    for path, a, b in _leaf_ranges(name):
        err = float(np.linalg.norm(got[a:b] - want[a:b])
                    / max(np.linalg.norm(want[a:b]), 1e-30))
        worst = max(worst, (err, path))
    return worst


def _reference_params(inputs, name, grads):
    """The reference's single-device round on the fixed pseudo-gradients
    ``grads``: a linear loss whose gradient they are -> (the flat params
    after the round, the clients' keys)."""
    plan = ER.plan_for(_Grid(ER.ROUNDS[name][0]))
    jparams = jax.tree.map(jnp.asarray, inputs["params"])
    tspec = JW.tree_spec(jparams)
    gs = jnp.stack([jnp.asarray(g) for g in grads])

    def loss_fn(p, b):
        return jnp.sum(tspec.flatten(p) * gs[b["c"].reshape(-1)[0]])
    comp = JC.Pipeline(ER._Z1)
    cfg = JF.FedConfig(n_clients=plan.n_clients,
                       client_groups=plan.client_groups, local_steps=1,
                       client_lr=R.CLR, server_lr=R.SLR)
    step = JF.build_round_step(loss_fn, comp, cfg,
                               JF.RoundContext(weights_are_mask=True))
    st = JF.init_server_state(jparams, cfg, comp, jax.random.PRNGKey(1))
    c = np.arange(plan.client_groups * plan.n_clients).reshape(
        plan.client_groups, plan.n_clients, 1, 1)
    st, _ = step(st, {"c": jnp.asarray(c)},
                 jnp.ones((plan.client_groups, plan.n_clients)))
    sub = jax.random.split(jax.random.PRNGKey(1))[1]
    keys = JN.client_keys(sub, 0, plan.client_groups * plan.n_clients)
    return np.asarray(tspec.flatten(st.params)), np.asarray(keys).astype(
        np.int64)


@pytest.mark.parametrize("name", _REF_ROUNDS)
def test_round_against_the_reference(run, name):
    inputs, ranks, want = run
    recs = [rk[name] for rk in ranks]
    ref = want[name]
    grads = [c["grad"] for c in ref]
    p_ref, keys = _reference_params(inputs, name, grads)
    d = grads[0].size
    for c, x in _joined(ranks, name, d).items():
        err, path = _leaf_l2(name, x, grads[c])
        assert err <= REF_LEAF_L2, (c, path, err)
    same = np.ones(d, bool)
    for rk in recs:
        np.testing.assert_allclose(
            rk["loss"], np.mean([c["loss"] for c in ref]), rtol=1e-5)
        lo, hi = rk["bounds"]
        real = min(hi, d) - lo
        for g, (x, got) in enumerate(zip(rk["x"], rk["bytes"])):
            c = _client_of(rk, g)
            ref_p = grads[c][lo:lo + real]
            pad = np.zeros((1, hi - lo), np.float32)
            pad[0, :real] = ref_p
            port = TO.zsign_encode_plain(
                torch.from_numpy(pad), torch.from_numpy(keys[c:c + 1]),
                torch.full((1,), R.SIGMA), 1, lo // 8192).numpy()
            diff = np.nonzero(_bits(got[0]) != _bits(port[0]))[0]
            diff = diff[diff < real]
            assert np.all(x[0, diff] != ref_p[diff]), \
                "wire bits differ where the pseudo-gradients agree"
            same[lo:lo + real] &= _bits(got[0])[:real] == _bits(port[0])[
                :real]
    grid, plan, specs = _specs(name)
    got_tree = {}
    for p, v in assemble(recs, grid, plan, specs).items():
        tree_set(got_tree, p, v)
    np.testing.assert_allclose(_flat(got_tree)[same], p_ref[same],
                               rtol=1e-5, atol=0)


def _one_process(inputs, name):
    """The port's loss and flat gradient of each client in one process."""
    m = _model(name)
    bundle = build_model(m)
    params = params_from_numpy(
        inputs["params_v256" if "vocab" in ER.ROUNDS[name][1]
               else "params"], m, "cpu")
    batch = inputs["batches"][name]
    out = []
    G, N = batch["tokens"].shape[:2]
    for g in range(G):
        for c in range(N):
            p = {}
            for path, v in tree_paths(params):
                tree_set(p, path, v.detach().requires_grad_(True))
            loss = bundle.loss_fn(p, {k: torch.from_numpy(v[g, c, 0])
                                      for k, v in batch.items()})
            grads = torch.autograd.grad(loss, [v for _, v in tree_paths(p)])
            gt = {}
            for (path, _), gr in zip(tree_paths(p), grads):
                tree_set(gt, path, gr.numpy())
            out.append((float(loss.detach()), _flat(gt)))
    return out


@pytest.mark.parametrize("name", _REF_ROUNDS + ["ed_22_v256"])
def test_round_against_the_one_process_port(run, name):
    inputs, ranks, _ = run
    one = _one_process(inputs, name)
    for rk in ranks:
        np.testing.assert_allclose(rk[name]["loss"],
                                   np.mean([l for l, _ in one]),
                                   rtol=ONE_LOSS_RTOL)
    for c, x in _joined(ranks, name, one[0][1].size).items():
        err, path = _leaf_l2(name, x, one[c][1])
        assert err <= ONE_LEAF_L2, (c, path, err)


def test_tied_table_is_stored_sharded_at_vocab_256(run):
    """At vocab 256 the tied table splits over `model` (vocab 997 leaves
    it replicated): the rank stores its half of the rows, and the round
    gathers it whole and reduce-scatters its gradient."""
    _, ranks, _ = run
    m = _model("ed_22_v256")
    for rk in ranks:
        r = rk["ed_22_v256"]
        assert r["params"][("embed",)].shape == (m.vocab // 2, m.d_model)
        assert rk["ed_22"]["params"][("embed",)].shape == (997, m.d_model)
        u = r["collective_by_use"]
        assert u["all_gather:weight"] >= m.vocab * m.d_model * 4
        assert u["reduce_scatter:weight"] >= m.vocab // 2 * m.d_model * 4


@pytest.mark.parametrize("a,b", [("ed_22", "ed_22_noremat"),
                                 ("ed_22", "ed_22_noweights")])
def test_remat_is_inert(run, a, b):
    _, ranks, _ = run
    for rk in ranks:
        x, y = rk[a], rk[b]
        for u, v in zip(x["x"], y["x"]):
            np.testing.assert_array_equal(u.view(np.int32),
                                          v.view(np.int32))
        for u, v in zip(x["bytes"], y["bytes"]):
            np.testing.assert_array_equal(u, v)
        for p in x["params"]:
            np.testing.assert_array_equal(x["params"][p].view(np.int32),
                                          y["params"][p].view(np.int32))
        assert x["loss"] == y["loss"]


@pytest.mark.parametrize("name", ["ed_22", "ed_14", "ed_22_noremat"])
def test_memory_gather_bytes_closed_form(run, name):
    """A client step gathers the encoder's (B, S_src / R, D) memory rows
    along the sequence once (outside every layer's remat) and
    reduce-scatters their gradient, summed over the decoder layers, once:
    B S_src D and B S_src D / R f32 values a rank."""
    _, ranks, _ = run
    D = _model(name).d_model
    n_seq = ER.ROUNDS[name][0][1]
    for rk in ranks:
        r = rk[name]
        B, G = r["plan"]["micro"], r["plan"]["client_groups"]
        u = r["collective_by_use"]
        assert u["all_gather:enc_mem"] == G * B * S_SRC * D * 4
        assert u["reduce_scatter:enc_mem"] == G * B * S_SRC // n_seq * D * 4


def _block_one(name, inputs):
    """The one-process block on the whole input -> (y, [d inputs],
    {weight: dw})."""
    _, kind, _, _ = ER.BLOCKS[name]
    case = inputs["blocks"][name]
    cfg = ER.arch().model
    lp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in case["lp"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    if kind == "cross":
        mem = torch.from_numpy(case["mem"]).requires_grad_(True)
        mk, mv = TE._mem_kv(mem, lp, cfg)
        y = TE._cross_attention(x, mk, mv, lp, cfg)
        ins = [x, mem]
    else:
        y = TL.attention(x, lp, cfg.attn_cfg_bidir(),
                         torch.arange(x.shape[1]))
        ins = [x]
    names = sorted(lp)
    grads = torch.autograd.grad(y, ins + [lp[k] for k in names],
                                torch.from_numpy(case["dy"]))
    return (y.detach().numpy(), [g.numpy() for g in grads[:len(ins)]],
            {k: g.numpy() for k, g in zip(names, grads[len(ins):])})


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(ER.BLOCKS))
def test_block_across_shards_is_the_one_process_block(run, name):
    inputs, ranks, _ = run
    grid_shape, kind, B, S = ER.BLOCKS[name]
    y1, dins, dw1 = _block_one(name, inputs)
    n_seq = grid_shape[1]
    per = S // n_seq
    summed = {}
    for rk in ranks:
        r = rk[name]
        if r["coords"]["data"] != 0:
            continue
        ss = slice(r["coords"]["model"] * per, (r["coords"]["model"] + 1)
                   * per)
        np.testing.assert_array_equal(r["y"].view(np.int32),
                                      y1[:, ss].view(np.int32))
        assert _rel(r["dx"], dins[0][:, ss]) <= BLOCK_REL
        if kind == "cross":
            assert _rel(r["dmem"], dins[1][:, ss]) <= BLOCK_REL
            assert r["collective_by_use"]["all_gather:enc_mem"] == \
                B * S * y1.shape[-1] * 4
        else:
            assert r["collective_by_use"]["all_gather:kv"] > 0
        for k, g in r["dw"].items():
            summed[k] = summed.get(k, 0) + g
    for k, g in summed.items():
        assert _rel(g, dw1[k]) <= BLOCK_REL, k


# ---------------------------------------------------------------------------
# the spec rules and the dry run's train cell
# ---------------------------------------------------------------------------

class _M2:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


_MESHES = {"2x2": _Grid((2, 2)), "1x4": _Grid((1, 4)),
           "16x16": _Grid((16, 16)), "pod2x16x16": _M2()}


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(k, "key", k)) for k in p): tuple(v)
            for p, v in flat}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("mesh", list(_MESHES))
def test_param_and_batch_specs_equal_the_reference(mesh, reduced):
    """``param_specs`` on the enc-dec leaves (``enc_*``, ``dec_*``,
    ``x_attn``, the tied table) and ``batch_specs`` on the frames and the
    target tokens equal the reference's; the frames' sequence (dim 4) is
    cut over the seq axes as the tokens' is. The tied 256,206-row table
    splits over the replica axes where they divide it (2 x 2) and stays
    whole on 16 x 16."""
    m = _MESHES[mesh]
    ja, ta = j_arch(ER.ARCH_ID), get_arch(ER.ARCH_ID)
    if reduced:
        ja, ta = ja.reduced(), ta.reduced()
    jplan = JSH.make_plan(ja, JSHAPES["train_4k"], m)
    tplan = SH.make_plan(ta, SHAPES["train_4k"], m)
    jshapes = jax.eval_shape(j_build(ja.model).init, jax.random.PRNGKey(0))
    want = _jpaths(JSH.param_specs(jshapes, m, jplan))
    got = dict(tree_paths(SH.param_specs(
        family_module(ta.model).param_shapes(ta.model), m, tplan)))
    assert got == want
    assert {p[0] for p in got} >= {"enc_attn", "dec_attn", "x_attn",
                                   "enc_mlp", "dec_mlp", "embed"}
    if not reduced:
        assert got[("embed",)] == (("model", None) if mesh == "2x2" else
                                   (None, None))
    fcfg = JF.FedConfig(n_clients=jplan.n_clients,
                        client_groups=jplan.client_groups,
                        local_steps=jplan.local_steps)
    jbatch = JF.make_batch_spec(fcfg, j_build(ja.model).train_batch_spec(
        jplan.micro, 4096))
    tbatch = {k[0]: tuple(v.shape) for k, v in jax.tree_util.
              tree_flatten_with_path(jbatch)[0] for k in [
                  tuple(str(getattr(x, "key", x)) for x in k)]}
    want_b = _jpaths(JSH.batch_specs(jbatch, jplan))
    got_b = {(k,): v for k, v in SH.batch_specs(tbatch, tplan).items()}
    assert got_b == want_b
    seq = tplan.seq_axes[0] if len(tplan.seq_axes) == 1 else \
        tuple(tplan.seq_axes)
    assert got_b[("embeds",)][4] == seq == got_b[("tokens",)][4]
    assert len(tbatch["embeds"]) == 6 and tbatch["embeds"][4] == 2048


def _cell(layers, seq, multi_pod):
    """``dryrun.analyze`` of seamless's train cell at ``layers`` a stack
    and a cut sequence, rank 0 of a fake production group."""
    from repro_torch.launch.mesh import make_production_mesh
    arch = get_arch(ER.ARCH_ID)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=layers))
    shape = ShapeCfg("train_cut", "train", seq,
                     SHAPES["train_4k"].global_batch)
    dryrun.fake_group(512 if multi_pod else 256, 0)
    try:
        grid = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        step, ex, plan = dryrun.build_train_cell(
            arch, shape, grid, agg_backend="cuda", encode_backend="cuda")
        return dryrun.analyze(step, ex, grid, ER.ARCH_ID), plan
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "pod2x16x16"])
def test_dry_run_train_cell_record(multi_pod):
    """The train cell at 2 + 2 of its 24 + 24 layers and seq 256 (the full
    train_4k record is the CLI's and PERF.md's): a record with a peak
    under 80 GB, FLOPs, the memory's gather and reduce-scatter by use in
    closed form (B_loc S_src D bf16 a client step, and a 16th of it), the
    K/V gathers of both stacks' self-attention and the weight gathers; the
    table, whose 256,206 rows do not split over 16, replicated with its
    gradient all-reduced."""
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    seq = 256
    res, plan = _cell(2, seq, multi_pod)
    assert res["peak_bytes"] > 0 and res["peak_bytes"] < dryrun.HBM_BYTES
    assert res["flops_per_device"] > 0
    m = get_arch(ER.ARCH_ID).model
    B = plan.micro
    u = res["collectives_by_use"]
    assert u["all_gather:enc_mem"] == B * seq // 2 * m.d_model * 2
    assert u["reduce_scatter:enc_mem"] == B * seq // 2 * m.d_model * 2 // 16
    assert u["all_gather:kv"] > 0 and u["all_gather:weight"] > 0
    assert u["all_reduce:replicated_grad"] >= m.vocab * m.d_model * 2
    assert plan.client_axes == (("pod", "data") if multi_pod else ("data",))
