"""The MoE and VLM families on the port's model-sharded grid against the
reference.

Four gloo ranks on the CPU (``tests/torch_sharded_ranks.py``, its
``MOE_SCENARIOS``) are spawned ONCE for the module and run one round each
of reduced (2 layers, d_model 64, f32) models on a (data, model) = 2 x 2
grid:

  * granite-moe (4 experts, top-2, replicated experts: gathered over
    `model` a layer) on the regular plan: 2 clients side by side, each
    replica over `model`, seq 32 in 2 sequence shards (capacity 10 a
    shard);
  * llama4-scout (4 experts, top-1, ``moe_ep``: E over `model`, the ff
    dimension over `data`, a spec that cuts two dimensions) on the big plan
    (2 sequential groups, the replica over data x model, the micro-batch
    over `data`): the dispatch goes to the experts' ranks by an all-to-all;
    and the same at seq 6, where S_loc * k = 3 < E = 4 makes the reference
    fall back to one shard (the sequence is gathered, the experts too);
  * internvl2 (4 image tokens + 28 text tokens) on the regular plan, with
    its reduced vocab 997 (the embedding table stays replicated) and with
    vocab 256 (the table is stored sharded over `model`).

The reference computes each client's loss, gradient and MoE aux under its
own ``sharding_hints`` on a forced-host CPU mesh of 4 devices
(``tests/torch_moe_grid_reference.py``, a subprocess), so its sequence
shards and capacities are the grid's; internvl2 on one device. Against it:

  * each rank's loss within rtol 1e-5 of the mean of the clients'
    reference losses; each rank's pseudo-gradient range within rtol 1e-4 /
    atol 1e-6 of the reference's flat gradient (the sequence-split sums and
    the reduce-scatters add in another order); wire bits that differ from
    the port's encode of the reference's gradient only where the two
    pseudo-gradients differ; params at every coordinate whose bits agree
    with the reference's within rtol 1e-5 of the reference's round on its
    own gradients (the same keys);
  * the MoE aux of every rank within rtol 1e-5 of the reference's global
    aux, the same bits on every rank of a replica (its counts are summed
    over the token axes before the product);
  * the replicated f32 router's and the experts' gradients, and the VLM
    embedding table's, each within the same tolerance on their own
    coordinates (their gradients are summed over the replica axes);
  * llama4's all-to-all bytes: each swap of the dispatch buffer, three
    times a direction a layer a client (forward, remat, backward);
  * the dispatch: the port's ``index_put`` buffer and its gather are the
    reference's one-hot einsums (the ``ep`` branch's) bit for bit, f32 and
    bf16;
  * the layer: ``moe_apply`` in one process under
    ``hints.seq_shard_view(2)`` against the reference's under the mesh
    (ns = 2, and a fallback to ns = 1), under ``test_torch_moe.py``'s
    routing rule (tokens whose top gates lie within 1e-5 of each other may
    route differently; a shard row whose tokens all pass keeps the same
    slots and outputs within rtol 1e-4 / atol 1e-6).

The reduced models' router gates lie close together (small random
weights): every token of these seeds passes the routing rule's 1e-5 gap in
the layer cases, and the round cases hold to the tolerances above.
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
import torch.multiprocessing as mp

import torch_sharded_ranks as R
from repro.configs.common import get_arch as j_arch
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro.models import layers as JL
from repro.models.api import build_model as j_build
from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import hints
from repro_torch.launch import sharding as SH
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model, params_from_numpy
from test_torch_sharded_round import _Grid, _bits, _flat, assemble

torch.set_num_threads(1)

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-6
GAP = 1e-5
#: layer cases: name -> (family, batch, seq)
LAYERS = {"granite_ns2": ("granite", 3, 16), "llama4_ns2": ("llama4", 3, 16),
          "llama4_ns1": ("llama4", 3, R.MOE_SEQ_NS1)}


def _jmodel(model):
    arch_id, over = R.FAMILIES[model]
    return dataclasses.replace(j_arch(arch_id).reduced().model, **over)


def _seq(name):
    return R.MOE_SCENARIOS[name][3].get("seq", R.MOE_SEQ)


def _batch(rng, name, plan, cfg):
    S = _seq(name)
    lead = (plan.client_groups, plan.n_clients, 1, plan.micro)
    if cfg.family == "vlm":
        P = cfg.n_img_tokens
        return {"img_embeds": rng.standard_normal(
                    lead + (P, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, lead + (S - P,),
                                       dtype=np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, lead + (S,),
                                   dtype=np.int32)}


def _lp(rs, cfg):
    E, D, Fd = cfg.moe_experts, cfg.d_model, cfg.d_ff
    return {"router": (rs.randn(D, E) / np.sqrt(D)).astype(np.float32),
            "w1": (rs.randn(E, D, Fd) / np.sqrt(D)).astype(np.float32),
            "w3": (rs.randn(E, D, Fd) / np.sqrt(D)).astype(np.float32),
            "w2": (rs.randn(E, Fd, D) / np.sqrt(Fd)).astype(np.float32)}


def _inputs():
    models, batches, rounds = {}, {}, {}
    for model in sorted({o["model"] for *_, o in
                         R.MOE_SCENARIOS.values()}):
        jb = j_build(_jmodel(model))
        models[model] = jax.tree.map(np.asarray,
                                     jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    for name, (shape, big, _, opt) in R.MOE_SCENARIOS.items():
        plan = R.plan_for(_Grid(shape), big, _seq(name))
        cfg = _jmodel(opt["model"])
        batches[name] = _batch(rng, name, plan, cfg)
        arch_id, over = R.FAMILIES[opt["model"]]
        rounds[name] = {"arch_id": arch_id, "over": over, "big": big,
                        "mesh": cfg.moe_experts > 0,
                        "params": models[opt["model"]],
                        "batch": batches[name]}
    rs = np.random.RandomState(5)
    layers = {}
    for name, (model, B, S) in LAYERS.items():
        cfg = _jmodel(model)
        layers[name] = {"arch_id": R.FAMILIES[model][0], "lp": _lp(rs, cfg),
                        "x": rs.randn(B, S, cfg.d_model).astype(np.float32)}
    return ({"models": models, "batches": batches},
            {"rounds": rounds, "layers": layers})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_moe")
    inputs, ref_in = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with open(out / "ref_in.pkl", "wb") as f:
        pickle.dump(ref_in, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_moe_grid_reference.py"),
         str(out / "ref_in.pkl"), str(out / "ref_out.pkl")], env=env)
    try:
        mp.spawn(R.main, args=(WORLD, str(out / "store"), str(out), "moe"),
                 nprocs=WORLD, join=True)
    finally:
        assert ref.wait(timeout=600) == 0
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(out / "ref_out.pkl", "rb") as f:
        want = pickle.load(f)
    return inputs, ref_in, ranks, want


def _specs(name):
    shape, big, _, opt = R.MOE_SCENARIOS[name]
    grid = _Grid(shape)
    plan = R.plan_for(grid, big, _seq(name))
    m = R.arch(big, model=opt["model"]).model
    from repro_torch.models.api import family_module
    full = family_module(m).param_shapes(m)
    return grid, plan, dict(tree_paths(SH.param_specs(
        full, grid, plan, moe_experts=m.moe_experts)))


def _client_of(rk, g):
    plan = rk["plan"]
    c = rk["coords"]["data"] if plan["client_axes"] else 0
    return g * plan["n_clients"] + c


def _leaf_range(inputs, name, leaf):
    """[a, b) of the leaf named ``leaf`` (a path suffix) in the flat
    order."""
    model = R.MOE_SCENARIOS[name][3]["model"]
    out, off = [], 0
    for path, v in sorted(tree_paths(inputs["models"][model])):
        n = np.asarray(v).size
        if tuple(path[-len(leaf):]) == leaf:
            out.append((off, off + n))
        off += n
    assert out, leaf
    return out


def _reference_params(inputs, name, grads):
    """The reference's single-device round on the fixed pseudo-gradients
    ``grads`` (its clients' gradients): a linear loss whose gradient they
    are -> the flat params after the round."""
    shape, big, spec, opt = R.MOE_SCENARIOS[name]
    plan = R.plan_for(_Grid(shape), big, _seq(name))
    jparams = jax.tree.map(jnp.asarray, inputs["models"][opt["model"]])
    tspec = JW.tree_spec(jparams)
    gs = jnp.stack([jnp.asarray(g) for g in grads])

    def loss_fn(p, b):
        return jnp.sum(tspec.flatten(p) * gs[b["c"].reshape(-1)[0]])
    comp = JC.Pipeline(spec)
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


@pytest.mark.parametrize("name", list(R.MOE_SCENARIOS))
def test_round_against_the_reference(run, name):
    inputs, _, ranks, want = run
    recs = [rk[name] for rk in ranks]
    ref = want["rounds"][name]
    grads = [c["grad"] for c in ref]
    p_ref, keys = _reference_params(inputs, name, grads)
    d = grads[0].size
    same = np.ones(d, bool)
    flipped = 0
    for rk in recs:
        # the round's loss: the mean over every client of the round
        np.testing.assert_allclose(
            rk["loss"], np.mean([c["loss"] for c in ref]), rtol=1e-5)
        lo, hi = rk["bounds"]
        real = min(hi, d) - lo
        for g, (x, got) in enumerate(zip(rk["x"], rk["bytes"])):
            c = _client_of(rk, g)
            ref_p = grads[c][lo:lo + real]
            np.testing.assert_allclose(x[0, :real], ref_p, rtol=RTOL,
                                       atol=ATOL)
            pad = np.zeros((1, hi - lo), np.float32)
            pad[0, :real] = ref_p
            port = TO.zsign_encode_plain(
                torch.from_numpy(pad), torch.from_numpy(keys[c:c + 1]),
                torch.full((1,), R.SIGMA), 1, lo // 8192).numpy()
            diff = np.nonzero(_bits(got[0]) != _bits(port[0]))[0]
            diff = diff[diff < real]
            assert np.all(x[0, diff] != ref_p[diff]), \
                "wire bits differ where the pseudo-gradients agree"
            flipped += diff.size
            same[lo:lo + real] &= _bits(got[0])[:real] == _bits(port[0])[
                :real]
    print(f"{name}: {flipped} wire bits differ from the port's encode of "
          f"the reference's gradients")
    grid, plan, specs = _specs(name)
    got_tree = {}
    for p, v in assemble(recs, grid, plan, specs).items():
        tree_set(got_tree, p, v)
    np.testing.assert_allclose(_flat(got_tree)[same], p_ref[same],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["granite_regular", "llama4_big",
                                  "llama4_big_ns1"])
def test_moe_aux_is_global(run, name):
    """Every rank's aux (one a client step) is the reference's aux over the
    whole micro-batch and sequence, the same bits on every rank of a
    replica; a product of the ranks' local means would differ."""
    _, _, ranks, want = run
    ref = want["rounds"][name]
    by_client = {}
    for rk in ranks:
        r = rk[name]
        assert len(r["aux"]) == r["plan"]["client_groups"]
        for g, aux in enumerate(r["aux"]):
            c = _client_of(r, g)
            np.testing.assert_allclose(aux, ref[c]["aux"], rtol=1e-5)
            by_client.setdefault(c, set()).add(aux)
    assert all(len(v) == 1 for v in by_client.values()), by_client


def _leaf_vs_reference(run, name, leaf):
    inputs, _, ranks, want = run
    grads = [c["grad"] for c in want["rounds"][name]]
    checked = 0
    for a, b in _leaf_range(inputs, name, leaf):
        for rk in ranks:
            r = rk[name]
            lo, hi = r["bounds"]
            u, v = max(a, lo), min(b, hi)
            for g, x in enumerate(r["x"]):
                if v > u:
                    np.testing.assert_allclose(
                        x[0, u - lo:v - lo],
                        grads[_client_of(r, g)][u:v], rtol=RTOL, atol=ATOL,
                        err_msg=f"{name} {leaf} rank {rk[name]['coords']}")
                    checked += v - u
    assert checked > 0


@pytest.mark.parametrize("name,leaf", [
    ("granite_regular", ("moe", "router")), ("llama4_big", ("moe", "router")),
    ("granite_regular", ("moe", "w2")), ("llama4_big", ("moe", "w1")),
    ("llama4_big", ("moe", "w2")), ("llama4_big_ns1", ("moe", "w3"))])
def test_router_and_expert_gradients_are_summed(run, name, leaf):
    """The replicated f32 router's gradient is summed over the replica
    axes, and the experts' gradients over the ranks that share them (a
    gather's reduce-scatter), whether gathered or expert-parallel."""
    _leaf_vs_reference(run, name, leaf)


@pytest.mark.parametrize("name", ["internvl2_regular", "internvl2_v256"])
def test_vlm_text_lookup_reads_the_gathered_table(run, name):
    """The text tokens' embeddings come from the gathered table: a
    replicated table's gradient is summed over the replica axes, and a
    table stored sharded (vocab 256) is read whole, not as a shard."""
    _leaf_vs_reference(run, name, ("embed",))


def test_expert_parallel_dispatch_bytes(run):
    """llama4 (ep): each swap of a (B_loc, E, C, D) f32 buffer, three times
    a direction a layer a client step (forward, remat, backward), and no
    sequence gather; at seq 6 (ns = 1) no swap and one sequence gather of
    the MoE input a layer a pass."""
    _, _, ranks, _ = run
    m = R.arch(True, model="llama4").model
    L, E, D = m.n_layers, m.moe_experts, m.d_model
    for rk in ranks:
        r = rk["llama4_big"]
        plan = r["plan"]
        b_loc = plan["micro"] // 2
        S_loc = R.MOE_SEQ // 2
        C = max(1, int(S_loc * m.moe_topk / E * 1.25))
        swap = b_loc * E * C * D * 4
        G = plan["client_groups"]
        for use in ("moe_dispatch", "moe_combine"):
            assert r["collective_by_use"][f"all_to_all:{use}"] == \
                3 * L * G * swap
        assert "all_gather:moe_seq" not in r["collective_by_use"]
        s = rk["llama4_big_ns1"]["collective_by_use"]
        assert not any(k.startswith("all_to_all:moe") for k in s)
        # the forward and the remat gather the (B_loc, S, D) input
        assert s["all_gather:moe_seq"] == 2 * L * G * b_loc \
            * R.MOE_SEQ_NS1 * D * 4


def test_expert_swap_moves_bf16_words(run):
    """The dispatch's all-to-all on bf16 (the card's dtype) under gloo: to
    the experts, model rank m holds every model rank's cells of its experts
    [2m, 2m + 2) in rank order, and back restores each rank's buffer word
    for word."""
    _, _, ranks, _ = run
    recs = [rk["expert_swap_bf16"] for rk in ranks]
    for rk in recs:
        np.testing.assert_array_equal(rk["back"], rk["x"])
        m = rk["coords"]["model"]
        peers = sorted((r for r in recs
                        if r["coords"]["data"] == rk["coords"]["data"]),
                       key=lambda r: r["coords"]["model"])
        want = np.stack([p["x"][:, 2 * m:2 * m + 2] for p in peers])
        np.testing.assert_array_equal(rk["to"], want)


@pytest.mark.parametrize("name", ["llama4_big", "granite_regular"])
def test_all_to_all_moves_range_and_shards(run, name):
    """The re-layout of a tree with two-dimension expert shards is one
    exchange each way: the range in once a group, the shards back once."""
    inputs, _, ranks, _ = run
    model = R.MOE_SCENARIOS[name][3]["model"]
    d = sum(np.asarray(v).size for _, v in tree_paths(
        inputs["models"][model]))
    for rk in ranks:
        r = rk[name]
        lo, hi = r["bounds"]
        shard = sum(v.size for v in r["params"].values())
        groups = r["plan"]["client_groups"]
        assert r["collective_by_use"]["all_to_all:to_range"] + r[
            "collective_by_use"]["all_to_all:from_range"] == \
            groups * 4 * (min(hi, d) - lo) + 4 * shard


def _stable(gate_all, k):
    top = -np.sort(-gate_all, axis=-1)[..., :k + 1]
    return np.all(-np.diff(top, axis=-1) > GAP, axis=-1)


@pytest.mark.parametrize("name", list(LAYERS))
def test_moe_apply_under_a_shard_view_matches_reference_mesh(run, name):
    """The port's layer in one process under ``seq_shard_view(2)`` against
    the reference's under its mesh's hints: ns = 2 (capacity per shard), or
    ns = 1 where S_loc * k < E."""
    _, ref_in, _, want = run
    case = ref_in["layers"][name]
    model, B, S = LAYERS[name]
    cfg = _jmodel(model)
    E, k = cfg.moe_experts, cfg.moe_topk
    ns = 2 if (S // 2) * k >= E else 1
    x = torch.from_numpy(case["x"])
    lp = {n: torch.from_numpy(v) for n, v in case["lp"].items()}
    with hints.seq_shard_view(2):
        assert TL.moe_seq_shards(S, E, k) == ns
        out, aux = TL.moe_apply(x, lp, E, k)
    # routing per shard row, on the reference's gates
    xs = case["x"].reshape(B * ns, S // ns, -1)
    gate_all = np.asarray(jax.nn.softmax(
        jnp.asarray(xs) @ jnp.asarray(case["lp"]["router"]), axis=-1))
    stable = _stable(gate_all, k)
    assert stable.all(), stable.mean()
    route = TL.moe_route(torch.from_numpy(xs), lp["router"], E, k)
    _, idx = JL._topk_iterative(jnp.asarray(gate_all), k)
    np.testing.assert_array_equal(route.idx.numpy(), np.asarray(idx))
    assert route.capacity == max(1, int(S // ns * k / E * 1.25))
    ref = want["layers"][name]
    np.testing.assert_allclose(out.numpy(), ref["out"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), ref["aux"], rtol=RTOL, atol=ATOL)
    if ns == 2:
        # the shards' capacities differ from one shard's: the unsharded
        # layer is another function here
        one, _ = TL.moe_apply(x, lp, E, k)
        assert not np.allclose(one.numpy(), ref["out"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["granite_regular", "llama4_big"])
def test_one_process_row_under_the_view_is_the_grid_function(run, name):
    """The one-process row chip_smoke holds a grid against (the port's
    loss in one process under ``seq_shard_view(2)``) is the reference's
    grid function: each client's loss and gradient within rtol 1e-4 /
    atol 1e-6 of the reference's under its mesh."""
    inputs, _, _, want = run
    shape, big, _, opt = R.MOE_SCENARIOS[name]
    m = R.arch(big, model=opt["model"]).model
    bundle = build_model(m)
    params = params_from_numpy(inputs["models"][opt["model"]], m, "cpu")
    batch = inputs["batches"][name]
    G, N = batch["tokens"].shape[:2]
    for g in range(G):
        for c in range(N):
            b = {k: torch.from_numpy(v[g, c, 0]) for k, v in batch.items()}
            p = {}
            for path, v in tree_paths(params):
                tree_set(p, path, v.detach().requires_grad_(True))
            with hints.seq_shard_view(2):
                loss = bundle.loss_fn(p, b)
            grads = torch.autograd.grad(loss, [v for _, v in
                                               tree_paths(p)])
            gt = {}
            for (path, _), gr in zip(tree_paths(p), grads):
                tree_set(gt, path, gr.numpy())
            ref = want["rounds"][name][g * N + c]
            np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
            np.testing.assert_allclose(_flat(gt), ref["grad"], rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_index_put_dispatch_is_the_one_hot_einsum(dtype):
    """The reference's expert-parallel branch dispatches by a one-hot einsum
    over (B, ns, S*k) slots and combines by another; every kept cell takes
    exactly one value and every other term is a zero, so the port's
    ``index_put`` buffer and its gather hold the same bits (llama4's top-1,
    and granite's top-2 with capacity drops, on the same routing)."""
    rs = np.random.RandomState(3)
    for model in ("llama4", "granite"):
        cfg = _jmodel(model)
        E, k, D = cfg.moe_experts, cfg.moe_topk, cfg.d_model
        x = rs.randn(2, 16, D).astype(np.float32)
        router = (rs.randn(D, E) / np.sqrt(D)).astype(np.float32)
        r = TL.moe_route(torch.from_numpy(x), torch.from_numpy(router), E, k)
        B, S = x.shape[:2]
        C = r.capacity
        tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
        jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
        vals = torch.from_numpy(x)[:, :, None, :].expand(B, S, k, D).reshape(
            B, S * k, D)
        vals = torch.where(r.keep[..., None], vals, 0).to(tdt)
        b_idx = torch.arange(B)[:, None].expand(B, S * k)
        buf = torch.zeros((B, E, C, D), dtype=tdt).index_put(
            (b_idx, r.e_idx, r.p_idx), vals, accumulate=True)
        cell = np.where(r.keep.numpy(), r.e_idx.numpy() * C + r.p_idx.numpy(),
                        E * C)
        oh = jax.nn.one_hot(jnp.asarray(cell), E * C, dtype=jdt)
        jvals = jnp.asarray(vals.float().numpy()).astype(jdt)
        jbuf = jnp.einsum("bsk,bsd->bkd", oh, jvals).reshape(B, E, C, D)
        iv = np.int32 if dtype == np.float32 else np.int16
        got = buf.view(torch.int32 if iv is np.int32 else torch.int16)
        want = np.asarray(jbuf).view(iv)
        np.testing.assert_array_equal(got.numpy(), want)
        # the combine: the port's gather of kept slots, the reference's
        # one-hot einsum back
        y = torch.from_numpy(rs.randn(B, E, C, D).astype(np.float32)).to(tdt)
        mine = torch.where(r.keep[..., None], y[b_idx, r.e_idx, r.p_idx], 0)
        ref = jnp.einsum("bsk,bkd->bsd", oh, jnp.asarray(
            y.float().numpy()).astype(jdt).reshape(B, E * C, D))
        np.testing.assert_array_equal(
            mine.view(got.dtype).numpy(), np.asarray(ref).view(iv))
