"""The xLSTM and hybrid families on the port's model-sharded grid against the
reference and against the port's one-process functions.

Four gloo ranks on the CPU (``tests/torch_sharded_recurrent_ranks.py``) are
spawned ONCE for the module and run, on (data, model) grids of 2 x 2 and
1 x 4, one round each of

  * the reduced xlstm-350m (one group: 3 mLSTM + 1 sLSTM, d_model 64, 4
    heads, f32) on the regular plan, seq 512: the mLSTM runs 2 key chunks
    of 256 and the sequence shards (2 or 4) cut the forget gates'
    cumulative sum;
  * the reduced jamba-1.5-large (one super-block: attention, 7 mamba, 4
    MoE of 4 experts top-2 with ``moe_ep``, 4 SwiGLU; d_model 64, f32) on
    the big plan (2 sequential groups, the replica over data x model, the
    micro-batch over `data`), seq 64: the mamba sublayers channel-parallel,
    the MoE expert-parallel over `model`.

The reference computes each client's loss, gradient and MoE aux in a
subprocess (``tests/torch_recurrent_grid_reference.py``): the xLSTM on one
device, the hybrid under its own ``sharding_hints`` on a forced-host mesh
of the grid's shape, so that its MoE counts capacity per sequence shard as
the grid does. Against it: each rank's loss within rtol 1e-5 of the mean
of the clients' reference losses; each client's pseudo-gradient (its
ranks' ranges joined) within relative L2 1e-4 of the reference's, leaf by
leaf; wire bits that differ from the port's encode of the reference's
gradient only where the two pseudo-gradients differ; params at every
coordinate whose bits agree with the reference's within rtol 1e-5 of the
reference's round on its own gradients (the same keys); the hybrid's MoE
aux within rtol 1e-5 of the reference's, the same bits on every rank of a
replica. The gradient's limit is a leaf's relative L2, not the dense
family's elementwise rtol 1e-4 / atol 1e-6 (``test_torch_sharded_round.
py``), which the port's ONE-process hybrid gradient already misses against
the reference (up to 7.4e-5 relative L2 on a leaf, elements of 1e-4 off by
1e-5: eight f32 sublayers of MoE, attention and 64-step scans add in each
framework's order); the grid lies up to 5.0e-5 from the reference. The
xLSTM's reference check runs at seq 32 with the mLSTM's key chunk cut to 16
in both packages (``CHUNK``; 2 key chunks, the shards cutting the
cumulative sum): at seq 512 the gates' cumulative sums reach ~350 and both
packages' f32 gradients through the decay matrix are ill-conditioned (the
port's one-process gradient lies 4.7e-3 relative L2 from the reference's
on the mLSTM leaves), so there the reference holds the loss only.

Against the port's one-process round function (the same loss in one
process; for the hybrid under ``hints.seq_shard_view``, the grid's MoE
capacity), at seq 512 too: each leaf's pseudo-gradient within relative L2
5e-5 (measured 1.1e-5 on the xLSTM, 2.5e-5 on the hybrid at 1 x 4), the
loss within rtol 1e-6. The grid's sums run in another order: the
sequence-split token sums, the channel-split ``x_proj`` and ``out_proj``
partials, the reduce-scatters of the weight gradients.

Remat on and off, and with the gathered weights kept or not, are
bit-identical. The block cases hold each recurrent block under the grid's
hints against the one-process block on the same numpy input (f32), each
limit relative to the largest |value| compared: the mLSTM across shards (2
and 4 sequence shards of 512 positions, 2 key chunks) and the sLSTM (4
shards) give each rank's output rows bit for bit, their input gradients
within 1e-5 and their weight gradients summed over the ranks within 1e-5
(the gather's reduce-scatter and the sum over ranks add each position's
terms in another order; measured 6.5e-7 and 8.0e-7); the channel-parallel
mamba block (its weights stored as the big plan's shards and gathered)
gives each rank's output rows, input gradient and weight shards'
gradients within 1e-5 (the ``x_proj`` and ``out_proj`` partials summed over
the channel slices; measured 1.3e-6). The mamba sublayer's collectives are
counted by use: the input's sequence gather, the ``x_proj`` partial's
all-reduce and the output's reduce-scatter.

The dry run (a fake group, meta tensors) prints the train cells of both
archs on 16 x 16 and 2 x 16 x 16 at a cut sequence (the scans are Python
loops over it, even on meta tensors; the full ``train_4k`` records are the
CLI's and PERF.md's), with the mamba partials' uses, and prints a record
for three of the families' serving cells (the rest and the grid's serving
itself: ``test_torch_sharded_serving.py``).
"""
import dataclasses
import json
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

import torch_sharded_ranks as R
import torch_sharded_recurrent_ranks as RR
from repro.configs.common import get_arch as j_arch
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro.models import mamba as JM
from repro.models import xlstm as JX
from repro.models.api import build_model as j_build
from repro_torch.configs.common import SHAPES, ShapeCfg, get_arch
from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import dryrun, hints
from repro_torch.launch import sharding as SH
from repro_torch.models import mamba as TM
from repro_torch.models import xlstm as TX
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
_REF_ROUNDS = ["xlstm_c16_22", "xlstm_c16_14", "hybrid_22", "hybrid_14"]
_ROUNDS = ["xlstm_22", "xlstm_14"] + _REF_ROUNDS
#: the remat variants and the round whose tokens they take
_VARIANTS = {"xlstm_22_noremat": "xlstm_22", "xlstm_22_noweights": "xlstm_22",
             "hybrid_22_noremat": "hybrid_22",
             "hybrid_22_weights": "hybrid_22"}


def _jcfg(model):
    return j_arch(RR.MODELS[model][0]).reduced().model


def _inputs():
    rng = np.random.default_rng(13)
    params, tokens, ref = {}, {}, {}
    for model in RR.MODELS:
        jb = j_build(_jcfg(model))
        params[model] = jax.tree.map(np.asarray,
                                     jb.init(jax.random.PRNGKey(0)))
    for name, (shape, _, model, _) in RR.ROUNDS.items():
        if name in _VARIANTS:
            continue
        plan = RR.plan_for(_Grid(shape), name)
        tokens[name] = rng.integers(0, _jcfg(model).vocab, (
            plan.client_groups, plan.n_clients, 1, plan.micro,
            RR.seq_of(name)), dtype=np.int32)
    for name, base in _VARIANTS.items():
        tokens[name] = tokens[base]
    for name in _ROUNDS:
        shape, _, model, opt = RR.ROUNDS[name]
        ref[name] = {"arch_id": RR.MODELS[model][0],
                     "params": params[model], "tokens": tokens[name],
                     "mesh": shape if model == "hybrid" else None,
                     "chunk": opt.get("chunk", TX.CHUNK)}
    rs = np.random.RandomState(21)
    blocks = {}
    for name, (_, kind, B, S) in RR.BLOCKS.items():
        D, H = RR.BLOCK_D, RR.BLOCK_H
        key = jax.random.PRNGKey(len(blocks))
        if kind == "mamba":
            lp = JM.mamba_init(key, D, 1, jnp.float32)
        elif kind == "mlstm":
            lp = JX.mlstm_init(key, D, H, 1, jnp.float32)
        else:
            lp = JX.slstm_init(key, D, H, 1, jnp.float32)
        lp = {k: np.array(v[0]) for k, v in lp.items()}
        if kind == "mlstm":
            # gates larger than the init's, so the running max and the
            # -1e30 floor are exercised
            lp["wif"] = (rs.randn(D, 2 * H) * 0.5).astype(np.float32)
            lp["bif"] = rs.randn(2 * H).astype(np.float32)
        blocks[name] = {"lp": lp,
                        "x": rs.randn(B, S, D).astype(np.float32),
                        "dy": rs.randn(B, S, D).astype(np.float32)}
    return ({"params": params, "tokens": tokens, "blocks": blocks},
            {"rounds": ref})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    out = tmp_path_factory.mktemp("sharded_recurrent")
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
        mp.spawn(RR.main, args=(WORLD, str(out / "store"), str(out)),
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


def _model_of(name):
    _, big, model, _ = RR.ROUNDS[name]
    return RR.arch(model, big).model


def _specs(name):
    shape = RR.ROUNDS[name][0]
    grid = _Grid(shape)
    plan = RR.plan_for(grid, name)
    m = _model_of(name)
    full = family_module(m).param_shapes(m)
    return grid, plan, dict(tree_paths(SH.param_specs(
        full, grid, plan, moe_experts=m.moe_experts)))


def _client_of(rk, g):
    plan = rk["plan"]
    c = rk["coords"]["data"] if plan["client_axes"] else 0
    return g * plan["n_clients"] + c


def _reference_params(inputs, name, grads):
    """The reference's single-device round on the fixed pseudo-gradients
    ``grads`` (its clients' gradients): a linear loss whose gradient they
    are -> (the flat params after the round, the clients' keys)."""
    shape, _, model, _ = RR.ROUNDS[name]
    plan = RR.plan_for(_Grid(shape), name)
    jparams = jax.tree.map(jnp.asarray, inputs["params"][model])
    tspec = JW.tree_spec(jparams)
    gs = jnp.stack([jnp.asarray(g) for g in grads])

    def loss_fn(p, b):
        return jnp.sum(tspec.flatten(p) * gs[b["c"].reshape(-1)[0]])
    comp = JC.Pipeline(RR._Z1)
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


def _leaf_ranges(name):
    """[(path, a, b)] of each leaf in the flat (TreeSpec) order."""
    m = _model_of(name)
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
    """-> the worst leaf's relative L2 error and its path."""
    worst = (0.0, None)
    for path, a, b in _leaf_ranges(name):
        err = float(np.linalg.norm(got[a:b] - want[a:b])
                    / max(np.linalg.norm(want[a:b]), 1e-30))
        worst = max(worst, (err, path))
    return worst


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


@pytest.mark.parametrize("name", ["xlstm_22", "xlstm_14"])
def test_long_xlstm_loss_is_the_reference_loss(run, name):
    """At seq 512 (2 key chunks of the shipped 256) the grid's loss is the
    reference's, within rtol 1e-5."""
    _, ranks, want = run
    for rk in ranks:
        np.testing.assert_allclose(
            rk[name]["loss"], np.mean([c["loss"] for c in want[name]]),
            rtol=1e-5)


def _one_process(inputs, name):
    """The port's loss and flat gradient of each client in one process
    (the hybrid under the grid's sequence shard count)."""
    shape, _, model, opt = RR.ROUNDS[name]
    m = _model_of(name)
    bundle = build_model(m)
    params = params_from_numpy(inputs["params"][model], m, "cpu")
    tokens = inputs["tokens"][name]
    out = []
    chunk = TX.CHUNK
    TX.CHUNK = opt.get("chunk", chunk)
    try:
        for g in range(tokens.shape[0]):
            for c in range(tokens.shape[1]):
                p = {}
                for path, v in tree_paths(params):
                    tree_set(p, path, v.detach().requires_grad_(True))
                with hints.seq_shard_view(shape[1]):
                    loss = bundle.loss_fn(p, {"tokens": torch.from_numpy(
                        tokens[g, c, 0])})
                grads = torch.autograd.grad(loss, [v for _, v in
                                                   tree_paths(p)])
                gt = {}
                for (path, _), gr in zip(tree_paths(p), grads):
                    tree_set(gt, path, gr.numpy())
                out.append((float(loss.detach()), _flat(gt)))
    finally:
        TX.CHUNK = chunk
    return out


@pytest.mark.parametrize("name", _ROUNDS)
def test_round_against_the_one_process_port(run, name):
    """The grid's round is the port's one-process function: each rank's
    loss and each client's pseudo-gradient against the same loss and
    gradient in one process, within the tighter limits of the module
    doc."""
    inputs, ranks, _ = run
    one = _one_process(inputs, name)
    for rk in ranks:
        np.testing.assert_allclose(rk[name]["loss"],
                                   np.mean([l for l, _ in one]),
                                   rtol=ONE_LOSS_RTOL)
    for c, x in _joined(ranks, name, one[0][1].size).items():
        err, path = _leaf_l2(name, x, one[c][1])
        assert err <= ONE_LEAF_L2, (c, path, err)


@pytest.mark.parametrize("a,b", [("xlstm_22", "xlstm_22_noremat"),
                                 ("xlstm_22", "xlstm_22_noweights"),
                                 ("hybrid_22", "hybrid_22_noremat"),
                                 ("hybrid_22", "hybrid_22_weights")])
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


@pytest.mark.parametrize("name", ["hybrid_22", "hybrid_14"])
def test_moe_aux_is_global(run, name):
    """Every rank's aux (one a client step) is the reference's aux over the
    whole micro-batch and sequence, the same bits on every rank of a
    replica."""
    _, ranks, want = run
    by_client = {}
    for rk in ranks:
        r = rk[name]
        assert len(r["aux"]) == r["plan"]["client_groups"]
        for g, aux in enumerate(r["aux"]):
            c = _client_of(r, g)
            np.testing.assert_allclose(aux, want[name][c]["aux"], rtol=1e-5)
            by_client.setdefault(c, set()).add(aux)
    assert all(len(v) == 1 for v in by_client.values()), by_client


@pytest.mark.parametrize("name", ["hybrid_22", "hybrid_14"])
def test_mamba_collectives_by_use(run, name):
    """A mamba sublayer's collectives a client step on the big plan: the
    (B_loc, S, D) f32 input gathered over `model` once (kept across the
    super-block's remat), the (B_loc, S, dt_rank + 32) ``x_proj`` partial
    all-reduced in the forward, the recompute and the backward, and the
    (B_loc, S_loc, D) output reduce-scattered in the forward and the
    recompute, its gradient all-gathered in the backward."""
    _, ranks, _ = run
    m = _model_of(name)
    D = m.d_model
    r0 = ranks[0][name]
    plan = r0["plan"]
    n_seq = RR.ROUNDS[name][0][1]
    n_data = RR.ROUNDS[name][0][0]
    S = RR.seq_of(name)
    b_loc = plan["micro"] // n_data
    n = 7 * plan["client_groups"]
    proj = max(1, D // 16) + 2 * TM.D_STATE
    for rk in ranks:
        u = rk[name]["collective_by_use"]
        assert u["all_gather:mamba_in"] == n * b_loc * S * D * 4
        assert u["reduce_scatter:mamba_in"] == n * b_loc * S // n_seq * D * 4
        assert u["all_reduce:mamba_xproj"] == 3 * n * b_loc * S * proj * 4
        assert u["reduce_scatter:mamba_out"] == \
            2 * n * b_loc * S // n_seq * D * 4
        assert u["all_gather:mamba_out"] == n * b_loc * S * D * 4


def _block_one(name, inputs):
    """The one-process block on the whole input -> (y, dx, {weight: dw})."""
    _, kind, _, _ = RR.BLOCKS[name]
    case = inputs["blocks"][name]
    lp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in case["lp"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    if kind == "mamba":
        y = TM.mamba_block(x, lp, d_model=RR.BLOCK_D)
    elif kind == "mlstm":
        y = TX.mlstm_block(x, lp, n_heads=RR.BLOCK_H)
    else:
        y = TX.slstm_block(x, lp, n_heads=RR.BLOCK_H)
    names = sorted(lp)
    grads = torch.autograd.grad(y, [x] + [lp[k] for k in names],
                                torch.from_numpy(case["dy"]))
    return (y.detach().numpy(), grads[0].numpy(),
            {f"{kind}.{k}": g.numpy() for k, g in zip(names, grads[1:])})


def _slice_of(rk, grid_shape, B, S):
    """This rank's (batch, sequence) slice under the big plan's hints."""
    data, model = grid_shape
    c = rk["coords"]
    b, s = B // data, S // model
    return (slice(c["data"] * b, (c["data"] + 1) * b),
            slice(c["model"] * s, (c["model"] + 1) * s))


def _shard_of(full, spec, coords, grid_shape):
    """A weight's shard (its stored (1, ...) leaf cut by ``spec``)."""
    g = _Grid(grid_shape)
    v = full[None]
    idx = [slice(None)] * v.ndim
    for d, axes in SH.spec_dims(spec):
        n = SH.axis_size(g, axes)
        i = 0
        for a in g.axis_names:
            if a in axes:
                i = i * g.shape[a] + coords[a]
        c = v.shape[d] // n
        idx[d] = slice(i * c, (i + 1) * c)
    return v[tuple(idx)]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(RR.BLOCKS))
def test_block_across_shards_is_the_one_process_block(run, name):
    inputs, ranks, _ = run
    grid_shape, kind, B, S = RR.BLOCKS[name]
    y1, dx1, dw1 = _block_one(name, inputs)
    summed = {}
    for rk in ranks:
        r = rk[name]
        bs, ss = _slice_of(r, grid_shape, B, S)
        if kind == "mamba":
            assert _rel(r["y"], y1[bs, ss]) <= BLOCK_REL
            for k, g in r["dw"].items():
                want = _shard_of(dw1[k], r["specs"][k], r["coords"],
                                 grid_shape)
                assert _rel(g, want) <= BLOCK_REL, k
        else:
            np.testing.assert_array_equal(r["y"].view(np.int32),
                                          y1[bs, ss].view(np.int32))
            for k, g in r["dw"].items():
                summed[k] = summed.get(k, 0) + g
        assert _rel(r["dx"], dx1[bs, ss]) <= BLOCK_REL
    for k, g in summed.items():
        assert _rel(g, dw1[k]) <= BLOCK_REL, k
    if kind == "mamba":
        uses = ranks[0][name]["collective_by_use"]
        assert {"all_gather:mamba_in", "all_reduce:mamba_xproj",
                "reduce_scatter:mamba_out", "all_gather:mamba_out",
                "reduce_scatter:mamba_in"} <= set(uses)


def test_mamba_gathers_the_stored_shards_whole(run):
    """The stored shards of ``in_proj`` are cut over data x model on the
    big plan, so a rank's stored columns are neither its x-half nor its
    z-half channel slice: the block gathers the weights whole (design (a)
    of PERF.md) and its backward reduce-scatters them onto the shards."""
    _, ranks, _ = run
    for rk in ranks:
        r = rk["mamba_22"]
        assert SH.spec_dims(r["specs"]["mamba.in_proj"]) == \
            ((2, ("data", "model")),)
        d_in = 2 * RR.BLOCK_D
        u = r["collective_by_use"]
        assert u["all_gather:weight"] >= RR.BLOCK_D * 2 * d_in * 4


# ---------------------------------------------------------------------------
# the hints the recurrent blocks need, one process
# ---------------------------------------------------------------------------

def test_fsdp_gather_refuses_a_cut_stacked_dimension():
    """A leaf whose spec cuts one of the dimensions a per-sublayer slice
    drops raises (the hybrid gathers such a stack whole first)."""
    class _G:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")
        rank = 0
        coords = {"data": 0, "model": 0}

        def group(self, axes):
            return None

        def index(self, axes):
            return 0
    specs = {"mlp": {"w1": (None, "model", None, "data")}}
    with hints.sharding_hints(_G(), ("model",), ("data",),
                              replica_axes=("data", "model"), specs=specs):
        assert hints.cuts_dim(("mlp",), 1)
        assert not hints.cuts_dim(("mlp",), 2)
        with pytest.raises(ValueError, match="stacked dimensions"):
            hints.fsdp_gather({"w1": torch.zeros(4, 3)}, ("mlp",),
                              stacked=2)


def test_recurrent_hints_are_the_identity_off_a_grid():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert hints.scatter_seq(x, use="t") is x
    assert hints.sum_partials(x, use="t") is x
    assert hints.seq_index() == 0
    assert not hints.cuts_dim(("mlp",), 1)


# ---------------------------------------------------------------------------
# the dry run's train cells
# ---------------------------------------------------------------------------

def _cell(arch_id, layers, seq, multi_pod):
    """``dryrun.analyze`` of the arch's train cell at ``layers`` and a cut
    sequence, rank 0 of a fake production group."""
    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=layers))
    shape = ShapeCfg("train_cut", "train", seq, SHAPES["train_4k"]
                     .global_batch)
    dryrun.fake_group(512 if multi_pod else 256, 0)
    try:
        from repro_torch.launch.mesh import make_production_mesh
        grid = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        step, ex, plan = dryrun.build_train_cell(
            arch, shape, grid, agg_backend="cuda", encode_backend="cuda")
        return dryrun.analyze(step, ex, grid, arch_id), plan
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id,layers,seq,multi_pod", [
    ("xlstm_350m", 4, 128, False), ("xlstm_350m", 4, 128, True),
    ("jamba_1_5_large_398b", 8, 128, False),
    ("jamba_1_5_large_398b", 8, 128, True)])
def test_dry_run_train_cell_records(arch_id, layers, seq, multi_pod):
    """Both archs' train cells print a record at a cut sequence (xlstm's
    24 layers, one of jamba's nine super-blocks): bytes, a peak under 80
    GB, FLOPs and collectives by use, the mLSTM's gate and the sLSTM's
    input gathers, or the mamba partials' all-reduce and reduce-scatter
    and the MoE dispatch."""
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    res, plan = _cell(arch_id, layers, seq, multi_pod)
    assert res["peak_bytes"] > 0 and res["peak_bytes"] < dryrun.HBM_BYTES
    assert res["flops_per_device"] > 0
    uses = res["collectives_by_use"]
    assert uses["all_gather:weight"] > 0 and uses["reduce_scatter:weight"]
    if arch_id == "xlstm_350m":
        assert not plan.micro_axes and plan.seq_axes == ("model",)
        assert uses["all_gather:gates"] > 0 and uses["all_gather:kv"] > 0
        assert uses["all_gather:slstm_in"] > 0
    else:
        assert plan.micro_axes == ("data",)
        assert plan.client_groups == (1 if multi_pod else 2)
        for use in ("all_gather:mamba_in", "all_reduce:mamba_xproj",
                    "reduce_scatter:mamba_out", "all_to_all:moe_dispatch"):
            assert uses[use] > 0, use
        # a sublayer's input gathered along the whole sequence, at the
        # model's width, once a sublayer a group
        m = get_arch(arch_id).model
        b_loc = max(1, plan.micro // 16)
        assert uses["all_gather:mamba_in"] == \
            7 * plan.client_groups * b_loc * seq * m.d_model * 2


@pytest.mark.parametrize("arch_id,shape,step", [
    ("xlstm_350m", "decode_32k", 3), ("jamba_1_5_large_398b", "prefill_32k",
                                      3),
    ("seamless_m4t_large_v2", "prefill_32k", 3)])
def test_cells_still_waiting_name_their_step(arch_id, shape, step, capsys):
    """The xLSTM, hybrid and enc-dec serving cells that waited for ROADMAP
    item 19 step 3 print a record since it landed: no
    ``not_ported``, a peak under 80 GB on 16 x 16, the uses their layouts
    call for. xlstm's decode_32k and seamless's prefill_32k at full depth
    through the CLI; jamba's prefill_32k at one of its nine super-blocks
    and seq 128 (its mamba scans loop over the sequence, on meta tensors
    too; the full record is the CLI's and PERF.md's)."""
    from test_torch_sharded_serving import check_family_serving_record, \
        serving_record
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    assert step == 3
    if arch_id == "jamba_1_5_large_398b":
        line = serving_record(arch_id, shape, layers=8, seq=128)
    else:
        dryrun.main(["--arch", arch_id, "--shape", shape])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    check_family_serving_record(line, arch_id, shape)


def test_shard_leaves_never_pads():
    """A dimension that does not split over its axes raises ValueError."""
    class _G:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")
    meta = {"w": torch.empty((6, 5), device="meta")}
    with pytest.raises(ValueError, match="does not split"):
        dryrun._shard_leaves(meta, {"w": (None, "model")}, _G())
