"""The port's model-sharded client replica (``core/fedavg.
build_sharded_round_step`` on a ``launch/mesh.ReplicaGrid``) against the
unsharded port and the reference.

Four gloo ranks on the CPU (a ``FileStore`` under ``tmp_path``, so xdist
workers never share a port) are spawned ONCE for the module
(``tests/torch_sharded_ranks.py``) and run every scenario on (data, model)
grids of 2 x 2 and 1 x 4: a reduced dense model (2 layers, d_model 64, 4
heads with 2 kv heads, vocab 256, f32, seq 32, QKV bias, q_chunk 16 so the
KV-chunked attention runs over the gathered keys), d = 90,688 coordinates
in 12 encode tiles.

  * The wire is exact. A fixed pseudo-gradient per client (a linear loss
    whose gradient it is) goes through the sharded wire: each rank's range
    bytes are the byte slice of the unsharded encode, the decoded range the
    slice of the unsharded decode, and the server step's shards the
    unsharded params, bit for bit: against the port's one-process round
    (z = inf and z = 1) and the reference's (z = inf; at z = 1 the
    reference's bytes differ from the port's only by the erf rule).
  * The round against the reference (regular plan: 2 clients side by side,
    each replica over `model`; big plan: 2 sequential groups of one client,
    the replica over data x model, the micro-batch over data). Each rank's
    pseudo-gradient range lies within rtol 1e-4 / atol 1e-6 of the
    reference's flat gradient (the sequence-split sums and the reduce-
    scatters add in another order); the range bytes differ from the port's
    encode of the reference's gradient only where the two pseudo-gradients
    differ; params at every coordinate whose wire bits agree with the
    reference's are within rtol 1e-5 of the reference's single-device round
    (the same numpy params, tokens and keys); the loss within rtol 1e-5.
  * Remat is inert: the same grid without remat, and with the gathered
    weights kept (``remat_save_weights``), is bit-identical. So is a bare
    ``stream`` cohort, which a plan with client axes resolves to the vmap
    round (``resolve_cohort``'s ``spmd_axes``, equal to the reference's).
  * Each rank's all-to-all bytes are its range plus its shards, in f32.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharded_ranks as R
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro.models.api import ModelCfg as JModelCfg
from repro.models.api import build_model as j_build
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import sharding as SH
from repro_torch.models.api import build_model, params_from_numpy

torch.set_num_threads(1)

WORLD = 4


class _Grid:
    """A stub of a grid's shape for the spec rules."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


def _jmodel():
    return JModelCfg(dtype=jnp.float32, **R.MODEL)


def _inputs():
    jb = j_build(_jmodel())
    params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, R.MODEL["vocab"], (1, 2, 1, 2, R.SEQ),
                          dtype=np.int32)
    tokens_big = rng.integers(0, R.MODEL["vocab"], (2, 1, 1, 2, R.SEQ),
                              dtype=np.int32)
    G = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.05, params) for _ in range(2)]
    return {"params": params, "tokens": tokens, "tokens_big": tokens_big,
            "G": G, "client_index": np.arange(4).reshape(2, 2, 1, 1)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    inputs = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(R.main, args=(WORLD, str(out / "store"), str(out)),
             nprocs=WORLD, join=True)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _specs(name):
    shape, big, _, _ = R.SCENARIOS[name]
    grid = _Grid(shape)
    plan = R.plan_for(grid, big)
    shapes = {}
    for p, v in tree_paths(_inputs_shapes()):
        tree_set(shapes, p, v)
    return grid, plan, dict(tree_paths(SH.param_specs(shapes, grid, plan)))


def _inputs_shapes():
    from repro_torch.models.transformer import param_shapes
    return param_shapes(R.arch(False).model)


def assemble(recs, grid, plan, specs):
    """The full params from the ranks' shards (``specs``: path -> spec;
    every data row's copy of a replica checked equal; a leaf cut along two
    dimensions is joined along both)."""
    out = {}
    for path, spec in specs.items():
        dims = SH.spec_dims(spec)
        pieces = {}
        for rk in recs:
            c = rk["coords"]
            key = tuple(c[a] for a in plan.client_axes)
            idx = tuple(_index(grid, c, axes) for _, axes in dims)
            got = rk["params"][path]
            if (key, idx) in pieces:
                np.testing.assert_array_equal(
                    got.view(np.int32), pieces[(key, idx)].view(np.int32))
            pieces[(key, idx)] = got
        rows = sorted({k for k, _ in pieces})
        full = []
        for key in rows:
            mine = {i: v for (k, i), v in pieces.items() if k == key}
            # join the innermost cut first
            for j in reversed(range(len(dims))):
                joined = {}
                for i in sorted(mine):
                    joined.setdefault(i[:j], []).append(mine[i])
                mine = {i: np.concatenate(v, axis=dims[j][0])
                        for i, v in joined.items()}
            full.append(mine[()])
        for f in full[1:]:
            np.testing.assert_array_equal(f.view(np.int32),
                                          full[0].view(np.int32))
        out[path] = full[0]
    return out


def _index(grid, coords, axes) -> int:
    i = 0
    for a in grid.axis_names:
        if a in axes:
            i = i * grid.shape[a] + coords[a]
    return i


def _assemble(name, recs):
    grid, plan, specs = _specs(name)
    return assemble(recs, grid, plan, specs)


def _client_of(rk, g):
    """(global client index, this rank's client) of group g."""
    plan = rk["plan"]
    c = rk["coords"]["data"] if plan["client_axes"] else 0
    return g * plan["n_clients"] + c


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for _, v in sorted(tree_paths(tree))])


def _linear_one_process(name, inputs):
    """The port's one-process round on the fixed pseudo-gradients: (params,
    payload stack, decoded update)."""
    shape, _, spec, _ = R.SCENARIOS[name]
    _, plan, _ = _specs(name)
    tb = build_model(R.arch(False).model)
    params = params_from_numpy(inputs["params"], tb.cfg, "cpu")
    gs = [params_from_numpy(g, tb.cfg, "cpu") for g in inputs["G"]]

    def loss_fn(p, b):
        c = int(b["c"].reshape(-1)[0])
        return sum(torch.sum(w * gw) for (_, w), (_, gw) in
                   zip(tree_paths(p), tree_paths(gs[c])))
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=plan.n_clients,
                       client_groups=plan.client_groups, local_steps=1,
                       client_lr=R.CLR, server_lr=R.SLR)
    step = TF.build_round_step(loss_fn, comp, cfg, SH.round_context(plan))
    st = TF.init_server_state(params, cfg, comp, TN.prng_key(1))
    seen = {}
    agg, dec = TC.Pipeline.aggregate, TC.Pipeline.decode_sum

    def aggregate(self, payload, *a, **k):
        seen["bytes"] = payload.clone().numpy()
        return agg(self, payload, *a, **k)

    def decode_sum(self, *a, **k):
        seen["decoded"] = dec(self, *a, **k).clone().numpy()
        return torch.from_numpy(seen["decoded"])
    TC.Pipeline.aggregate, TC.Pipeline.decode_sum = aggregate, decode_sum
    try:
        batch = {"c": torch.from_numpy(inputs["client_index"][
            :plan.client_groups, :plan.n_clients])}
        st, _ = step(st, batch, np.ones((plan.client_groups,
                                         plan.n_clients), np.float32))
    finally:
        TC.Pipeline.aggregate, TC.Pipeline.decode_sum = agg, dec
    return ({p: v.numpy() for p, v in tree_paths(st.params)},
            seen["bytes"], seen["decoded"])


@pytest.mark.parametrize("name", ["wire_inf_22", "wire_inf_14",
                                  "wire_z1_22"])
def test_wire_exact_against_the_unsharded_port(run, name):
    inputs, ranks = run
    recs = [rk[name] for rk in ranks]
    params, stack, decoded = _linear_one_process(name, inputs)
    for rk in recs:
        lo, hi = rk["bounds"]
        assert lo % 8192 == 0 and (hi - lo) % 8192 == 0
        assert rk["tile0"] == lo // 8192
        for g, got in enumerate(rk["bytes"]):
            np.testing.assert_array_equal(
                got[0], stack[_client_of(rk, g)][lo // 8:hi // 8])
        np.testing.assert_array_equal(rk["decoded"].view(np.int32),
                                      decoded[lo:hi].view(np.int32))
    got = _assemble(name, recs)
    for path, want in params.items():
        np.testing.assert_array_equal(got[path].view(np.int32),
                                      want.view(np.int32), err_msg=str(path))


@pytest.mark.parametrize("name", ["wire_inf_22", "wire_inf_14",
                                  "wire_z1_22"])
def test_wire_exact_against_the_reference(run, name):
    """z = inf: params and bytes bit-identical to the reference's
    single-device round (op by op). z = 1: the reference's bytes differ
    from the sharded bytes only by the erf rule."""
    inputs, ranks = run
    recs = [rk[name] for rk in ranks]
    _, _, spec, _ = R.SCENARIOS[name]
    _, plan, _ = _specs(name)
    jparams = jax.tree.map(jnp.asarray, inputs["params"])
    jg = [jax.tree.map(jnp.asarray, g) for g in inputs["G"]]

    def loss_fn(p, b):
        c = b["c"].reshape(-1)[0]
        stacked = [jnp.stack([jax.tree_util.tree_leaves(g)[i] for g in jg])
                   for i in range(len(jax.tree_util.tree_leaves(jg[0])))]
        return sum(jnp.sum(w * s[c]) for w, s in
                   zip(jax.tree_util.tree_leaves(p), stacked))
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=plan.n_clients,
                       client_groups=plan.client_groups, local_steps=1,
                       client_lr=R.CLR, server_lr=R.SLR)
    step = JF.build_round_step(loss_fn, comp, cfg,
                               JF.RoundContext(weights_are_mask=True))
    st = JF.init_server_state(jparams, cfg, comp, jax.random.PRNGKey(1))
    batch = {"c": jnp.asarray(inputs["client_index"][
        :plan.client_groups, :plan.n_clients])}
    st, _ = step(st, batch, jnp.ones((plan.client_groups, plan.n_clients)))
    spec_t = JW.tree_spec(jparams)
    sub = jax.random.split(jax.random.PRNGKey(1))[1]
    keys = JN.client_keys(sub, 0, plan.client_groups * plan.n_clients)
    z = comp.codec.z
    for rk in recs:
        lo, hi = rk["bounds"]
        for g, got in enumerate(rk["bytes"]):
            c = _client_of(rk, g)
            want = np.asarray(JC.fused_sign_encode_jnp(
                spec_t.flatten(jg[c]), keys[c], comp.codec.sigma, z=z))
            want = want[lo // 8:hi // 8]
            if z == 1:
                x = torch.from_numpy(rk["x"][g])
                flips, far = TO.erf_rule_flips(
                    x, torch.from_numpy(np.asarray(keys[c:c + 1]).astype(
                        np.int64)),
                    torch.full((1,), comp.codec.sigma), 1,
                    torch.from_numpy(got),
                    torch.from_numpy(want[None]), tile0=lo // 8192)
                assert far == 0
            else:
                np.testing.assert_array_equal(got[0], want)
    if z != 1:
        got = _assemble(name, recs)
        for path, want in tree_paths(jax.tree.map(np.asarray, st.params)):
            np.testing.assert_array_equal(got[path].view(np.int32),
                                          want.view(np.int32))


def _reference_round(name, inputs):
    """The reference's single-device round of the reduced model (op by
    op) and each client's flat pseudo-gradient."""
    _, big, spec, _ = R.SCENARIOS[name]
    _, plan, _ = _specs(name)
    jb = j_build(_jmodel())
    jparams = jax.tree.map(jnp.asarray, inputs["params"])
    tokens = inputs["tokens_big" if big else "tokens"]
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=plan.n_clients,
                       client_groups=plan.client_groups, local_steps=1,
                       client_lr=R.CLR, server_lr=R.SLR)
    step = JF.build_round_step(jb.loss_fn, comp, cfg,
                               JF.RoundContext(weights_are_mask=True))
    st0 = JF.init_server_state(jparams, cfg, comp, jax.random.PRNGKey(1))
    st, m = step(st0, {"tokens": jnp.asarray(tokens)},
                 jnp.ones((plan.client_groups, plan.n_clients)))
    spec_t = JW.tree_spec(jparams)
    grad = jax.jit(jax.grad(jb.loss_fn))
    flats = [np.asarray(spec_t.flatten(grad(jparams, {"tokens": jnp.asarray(
        tokens[g, c, 0])}))) for g in range(plan.client_groups)
        for c in range(plan.n_clients)]
    sub = jax.random.split(jax.random.PRNGKey(1))[1]
    keys = JN.client_keys(sub, 0, plan.client_groups * plan.n_clients)
    want = [np.asarray(JC.fused_sign_encode_jnp(jnp.asarray(f), keys[c],
                                                comp.codec.sigma, z=1))
            for c, f in enumerate(flats)]
    return (st, float(m.loss), flats, want,
            np.asarray(keys).astype(np.int64))


def _bits(b):
    return np.unpackbits(b, bitorder="little")


@pytest.mark.parametrize("name", ["round_regular", "round_big"])
def test_round_against_the_reference(run, name):
    inputs, ranks = run
    recs = [rk[name] for rk in ranks]
    st, loss, flats, want, keys = _reference_round(name, inputs)
    d = flats[0].size
    same = np.ones(d, bool)
    flipped = 0
    for rk in recs:
        np.testing.assert_allclose(rk["loss"], loss, rtol=1e-5)
        lo, hi = rk["bounds"]
        real = min(hi, d) - lo
        for g, (x, got) in enumerate(zip(rk["x"], rk["bytes"])):
            c = _client_of(rk, g)
            ref_p = flats[c][lo:lo + real]
            np.testing.assert_allclose(x[0, :real], ref_p, rtol=1e-4,
                                       atol=1e-6)
            # the port's encode of the reference's gradient, this range
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
            # coordinates whose bits agree with the reference's own bytes
            agree = _bits(got[0])[:real] == _bits(want[c][lo // 8:hi // 8])[
                :real]
            same[lo:lo + real] &= agree
    print(f"{name}: {flipped} wire bits differ from the port's encode of the "
          f"reference's gradients; {int((~same).sum())} of {d} coordinates "
          "have a bit off the reference's")
    got = _assemble(name, recs)
    spec_t = JW.tree_spec(jax.tree.map(jnp.asarray, inputs["params"]))
    p_ref = np.asarray(spec_t.flatten(st.params))
    got_tree = {}
    for p, v in got.items():
        tree_set(got_tree, p, v)
    p_got = _flat(got_tree)
    np.testing.assert_allclose(p_got[same], p_ref[same], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("a,b", [("round_regular", "round_regular_noremat"),
                                 ("round_regular",
                                  "round_regular_saveweights"),
                                 ("round_big", "round_big_noremat")])
def test_remat_is_inert(run, a, b):
    _, ranks = run
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


@pytest.mark.parametrize("name", ["round_regular", "round_big",
                                  "wire_inf_14"])
def test_all_to_all_moves_range_and_shards(run, name):
    """One exchange each way: this rank's range in (its real
    coordinates) once a group, its shards back once, 4 bytes each."""
    _, ranks = run
    d = sum(int(np.prod(s)) for _, s in tree_paths(_inputs_shapes()))
    for rk in ranks:
        r = rk[name]
        lo, hi = r["bounds"]
        shard = sum(v.size for v in r["params"].values())
        groups = r["plan"]["client_groups"]
        assert r["collectives"]["all_to_all"] == \
            groups * 4 * (min(hi, d) - lo) + 4 * shard
        assert r["uplink_bits"] == float(
            d * r["plan"]["n_clients"] * r["plan"]["client_groups"])


def test_stream_cohort_on_a_grid_is_the_vmap_round(run):
    """A bare ``stream`` on a plan with client axes resolves to the vmap
    plan, as the reference's does given ``spmd_axes``: the grid's round is
    bit-identical to the ``auto`` one."""
    _, ranks = run
    for rk in ranks:
        x, y = rk["round_regular"], rk["round_regular_stream"]
        for u, v in zip(x["bytes"], y["bytes"]):
            np.testing.assert_array_equal(u, v)
        for p in x["params"]:
            np.testing.assert_array_equal(x["params"][p].view(np.int32),
                                          y["params"][p].view(np.int32))
        assert x["loss"] == y["loss"]


@pytest.mark.parametrize("policy", ["auto", "stream", "stream(shard=1)",
                                    "stream(shard=2,feed=host)", "vmap",
                                    "stream(devices=2)"])
def test_resolve_cohort_with_spmd_axes_is_the_reference(policy):
    """Given a grid plan's client axes, the port's ``resolve_cohort``
    equals the reference's: ``auto``, ``stream`` and ``vmap`` are the vmap
    plan, a forced stream raises the same ``ValueError`` text."""
    axes = ("data",)
    try:
        want = JF.resolve_cohort(policy, 16, 1 << 24, spmd_axes=axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TF.resolve_cohort(policy, 16, 1 << 24, spmd_axes=axes)
        assert str(got.value) == str(e)
        assert "forces the streaming plan" in str(e)
        return
    assert tuple(TF.resolve_cohort(policy, 16, 1 << 24,
                                   spmd_axes=axes)) == tuple(want)
    assert want.mode == "vmap"


def test_forced_stream_on_a_grid_raises_the_reference_error():
    """``build_sharded_round_step`` resolves the cohort with the plan's
    client axes: a forced stream is the reference's config conflict."""
    grid = _Grid((2, 2))
    plan = R.plan_for(grid, False)
    with pytest.raises(ValueError, match="forces the streaming plan"):
        TF.build_sharded_round_step(
            lambda p, b: 0.0, TC.Pipeline("zsign"),
            TF.FedConfig(n_clients=2), SH.round_context(
                plan, cohort="stream(shard=1)"), grid=grid, plan=plan,
            specs={})


@pytest.mark.parametrize("spec", ["zsign(z=1,sigma=0.01,agg=vote)",
                                  "zsign(z=1,sigma=0.01,agg=trimmed(f=1))",
                                  "zsign_packed(z=2,sigma=0.01)",
                                  "topk(frac=0.25)", "ef|topk(frac=0.25)",
                                  "dp(clip=1.0,noise=0.1)|dense"])
def test_other_pipelines_on_a_grid_raise(spec):
    """These six specs build on a grid and resolve their layout (their
    rounds are held in ``tests/test_torch_sharded_pipelines.py``); what
    still waits raises ``NotImplementedError`` naming ROADMAP with each of
    them: an async round. A cohort that streams the big plan's sequential
    groups builds and resolves its stream plan with each of them (its
    rounds are held in ``tests/test_torch_sharded_stream.py``)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.common import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_replica_grid
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    shape = ShapeCfg("test", "train", R.SEQ, 4)
    dryrun.fake_group(4, 0)
    try:
        grid = make_replica_grid((2, 2), ("data", "model"),
                                 device_type="cpu")
        _, ex, plan = dryrun.build_train_cell(R.arch(False), shape, grid,
                                              pipeline=spec)
        ctx = dataclasses.replace(
            SH.round_context(plan),
            round_mode="async(deadline=1.0,staleness=cutoff(2))")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TF.build_sharded_round_step(
                lambda p, b: 0.0, TC.Pipeline(spec), ex["fcfg"], ctx,
                grid=grid, plan=plan, specs=ex["specs"])
        step, ex, _ = dryrun.build_train_cell(
            R.arch(True), shape, grid, pipeline=spec,
            cohort="stream(shard=1)")
        assert ex["layout"](None).spec.n_coords > 0
    finally:
        dist.destroy_process_group()


def test_robust_laws_on_a_grid_need_the_mask_guarantee():
    """The robust laws count votes under the static 0/1-mask guarantee:
    without it the grid step refuses them at build, before a round's local
    SGD, as the aggregate would after it."""
    with pytest.raises(ValueError, match="weights_are_mask"):
        TF.build_sharded_round_step(
            lambda p, b: 0.0, TC.Pipeline("zsign(z=1,sigma=0.01,agg=vote)"),
            TF.FedConfig(), None, grid=None, plan=None, specs={})
