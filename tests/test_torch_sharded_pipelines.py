"""The stateful and transform pipelines on the port's model-sharded client
replica (``core/fedavg.build_sharded_round_step``): ``ef|zsign`` (both
routes, F1's by its plain version here), noisy EF, ``cv|zsign_packed``, the
DP clip fused into ``zsign_packed``, ``sigma_sched`` and ``stosign``.

Four gloo ranks on the CPU (a ``FileStore`` under ``tmp_path``) are
spawned ONCE for the module (``tests/torch_sharded_ranks.py``,
``PIPELINE_SCENARIOS``). Each spec runs 2 rounds on the regular plan of the
(data, model) grids 2 x 2 (2 clients side by side) and 1 x 4 (one client)
and on the big plan of the 2 x 2 grid (2 sequential groups of one client),
from the range state of ``init_server_state(layout=)``, on the reduced
dense model's d = 90,688 coordinates (12 encode tiles) with a fixed
pseudo-gradient per client (a linear loss, the wire harness of
``tests/test_torch_sharded_round.py``). Round 1's 0/1 mask drops the
cohort's last client. The baselines get the same numpy inputs, keys and
masks:

  * the port's one-process round given the grid's whole-vector
    statistics (the EF scale, sto-sign's sigma, the clip norm, which the
    ranks sum from per-range partials in another order): every payload
    byte, state and server row, decoded coordinate and param is
    bit-identical, so the grid's client-axis sum (an all-gather of the
    scale-weighted payloads) is the one-process reduce;
  * the port's one-process round as it is: the specs without such a
    statistic bit-identical; the EF scale within rtol 1e-6, its residuals
    and params within rtol 1e-6 and atol 1e-6 of the largest scale (a
    param whose clients' signs oppose keeps only the scales' difference)
    where every wire bit agrees; sto-sign's and DP's bits off only within
    4 f32 ulp of their thresholds (the suite's erf rule);
  * the reference's single-device ``build_round_step``, op by op: the
    same rules, plus z = 1's erf rule, and EF's bits in round 1 off only
    where the two residuals put p within 1e-5 of the scale of 0.

Every rank holds its range of each state slot, (G, 1, hi - lo) and (hi -
lo,), its padding zero; a dead client keeps its rows bit for bit; the
ranks of a replica sum the same statistic bits; the new collectives (the
partial sums, the payload all-gather) are counted in closed form.
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
from repro.core import wire as JW
from repro.models.api import ModelCfg as JModelCfg
from repro.models.api import build_model as j_build
from repro_torch.core import compression as TC
from repro_torch.core import dp as TD
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import sharding as SH
from repro_torch.models.api import build_model, params_from_numpy
from repro_torch.models.transformer import param_shapes
from test_torch_sharded_round import _Grid, assemble

torch.set_num_threads(1)

WORLD = 4
SPECS = sorted(R.PIPELINE_SPECS)
#: EF's scale, residuals and params against a baseline that sums |p| in
#: another order (atol: this share of the largest scale)
EF_RTOL = 1e-6
#: the round's update norm: f32 sums of 90,688 squares, the ranks' by
#: range in rank order, one process's by ``vector_norm`` (2.5e-5 apart at
#: most here)
NORM_RTOL = 1e-4
#: the specs whose wire holds a per-client whole-vector statistic
STAT = {"ef": "scale", "ef_f1": "scale", "dp": "norms", "stosign": "norms"}


def _inputs():
    jb = j_build(JModelCfg(dtype=jnp.float32, **R.MODEL))
    params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    G = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.05, params) for _ in range(4)]
    return {"params": params, "G": G,
            "client_index": np.arange(4).reshape(2, 2, 1, 1)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_pipelines")
    inputs = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(R.main, args=(WORLD, str(out / "store"), str(out), "pipelines"),
             nprocs=WORLD, join=True)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _i32(a):
    return np.asarray(a).view(np.int32)


def _plan(name):
    shape, big, _, _ = R.PIPELINE_SCENARIOS[name]
    grid = _Grid(shape)
    return grid, R.plan_for(grid, big)


def _client(rk, g):
    """The global client of this rank's group g."""
    plan = rk["plan"]
    c = rk["coords"]["data"] if plan["client_axes"] else 0
    return g * plan["n_clients"] + c


def _assembled(name, recs, t):
    grid, plan = _plan(name)
    shapes = {}
    for p, v in tree_paths(param_shapes(R.arch(False).model)):
        tree_set(shapes, p, v)
    specs = dict(tree_paths(SH.param_specs(shapes, grid, plan)))
    got = assemble([{"coords": rk["coords"], "params": rk["rounds"][t][
        "params"]} for rk in recs], grid, plan, specs)
    return _flat(got)


def _flat(params: dict) -> np.ndarray:
    return np.concatenate([np.asarray(params[p], np.float32).reshape(-1)
                           for p in sorted(params)])


def _grid_stats(name, recs):
    """[round][global client] -> the statistic the grid's ranks summed for
    that client (the EF scale or the norm), checked bit-identical on every
    rank that holds the client."""
    kind = STAT[name.rsplit("_", 1)[0]]
    _, plan = _plan(name)
    out = [[None] * (plan.client_groups * plan.n_clients)
           for _ in range(R.PIPELINE_ROUNDS)]
    for rk in recs:
        for t, rd in enumerate(rk["rounds"]):
            for g, v in enumerate(rd[kind]):
                c = _client(rk, g)
                if out[t][c] is None:
                    out[t][c] = v
                np.testing.assert_array_equal(_i32(v), _i32(out[t][c]))
    return out


def _one_process(name, inputs, stats=None):
    """The port's one-process rounds of the scenario's cohort -> per
    round: the payload stack (bytes, scales), the decoded vector, the
    state and server slots, the params and the uplink bits. ``stats``
    (``_grid_stats``) stands in for the one-process EF scale or norms."""
    _, plan = _plan(name)
    spec = R.PIPELINE_SCENARIOS[name][2]
    G, N = plan.client_groups, plan.n_clients
    tb = build_model(R.arch(False).model)
    params = params_from_numpy(inputs["params"], tb.cfg, "cpu")
    gs = [params_from_numpy(g, tb.cfg, "cpu") for g in inputs["G"]]

    def loss_fn(p, b):
        c = int(b["c"].reshape(-1)[0])
        return sum(torch.sum(w * gw) for (_, w), (_, gw) in
                   zip(tree_paths(p), tree_paths(gs[c])))
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=N, client_groups=G, local_steps=1,
                       client_lr=R.CLR, server_lr=R.SLR)
    step = TF.build_round_step(loss_fn, comp, cfg, SH.round_context(plan))
    st = TF.init_server_state(params, cfg, comp, TN.prng_key(1))
    seen = {}
    queue = [torch.from_numpy(np.concatenate(stats[t][g * N:(g + 1) * N]))
             for t in range(R.PIPELINE_ROUNDS) for g in range(G)] \
        if stats is not None else None

    def aggregate(self, payload, *a, **k):
        seen["payload"] = {k_: v.clone().numpy() for k_, v in (
            payload.items() if isinstance(payload, dict)
            else {"packed": payload}.items())}
        return agg(self, payload, *a, **k)

    def decode_sum(self, *a, **k):
        g = dec(self, *a, **k)
        seen["decoded"] = g.clone().numpy()
        return g

    def given(*a, **k):
        return queue.pop(0)
    agg, dec = TC.Pipeline.aggregate, TC.Pipeline.decode_sum
    mean_abs, norms = TC._mean_abs_rows, TD.row_norms
    TC.Pipeline.aggregate, TC.Pipeline.decode_sum = aggregate, decode_sum
    if queue is not None:
        TC._mean_abs_rows = TD.row_norms = given
    rounds = []
    try:
        batch = {"c": torch.from_numpy(inputs["client_index"][:G, :N])}
        for t in range(R.PIPELINE_ROUNDS):
            st, m = step(st, batch, R.pipeline_mask(plan, t))
            rounds.append({
                **seen,
                "state": {k: v.clone().numpy() for k, v in
                          (st.comp_state or {}).items()},
                "server": {k: v.clone().numpy() for k, v in
                           (st.comp_server or {}).items()},
                "params": _flat({p: v.numpy()
                                 for p, v in tree_paths(st.params)}),
                "uplink_bits": float(m.uplink_bits),
                "norm": float(m.grad_est_norm)})
    finally:
        TC.Pipeline.aggregate, TC.Pipeline.decode_sum = agg, dec
        TC._mean_abs_rows, TD.row_norms = mean_abs, norms
    if queue is not None:
        assert not queue, "a statistic was not asked for"
    return rounds


def _reference(name, inputs):
    """The reference's single-device rounds, op by op, of the scenario's
    cohort: the same per-round record as ``_one_process``."""
    _, plan = _plan(name)
    spec = R.PIPELINE_SCENARIOS[name][2]
    G, N = plan.client_groups, plan.n_clients
    jparams = jax.tree.map(jnp.asarray, inputs["params"])
    jg = [jax.tree_util.tree_leaves(jax.tree.map(jnp.asarray, g))
          for g in inputs["G"]]
    stacked = [jnp.stack([g[i] for g in jg]) for i in range(len(jg[0]))]

    def loss_fn(p, b):
        c = b["c"].reshape(-1)[0]
        return sum(jnp.sum(w * s[c]) for w, s in
                   zip(jax.tree_util.tree_leaves(p), stacked))
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=N, client_groups=G, local_steps=1,
                       client_lr=R.CLR, server_lr=R.SLR)
    step = JF.build_round_step(loss_fn, comp, cfg,
                               JF.RoundContext(weights_are_mask=True))
    st = JF.init_server_state(jparams, cfg, comp, jax.random.PRNGKey(1))
    spec_t = JW.tree_spec(jparams)
    seen = {}

    def aggregate(self, payload, *a, **k):
        seen["payload"] = {k_: np.asarray(v) for k_, v in (
            payload.items() if isinstance(payload, dict)
            else {"packed": payload}.items())}
        return agg(self, payload, *a, **k)
    agg = JC.Pipeline.aggregate
    JC.Pipeline.aggregate = aggregate
    rounds = []
    try:
        batch = {"c": jnp.asarray(inputs["client_index"][:G, :N])}
        for t in range(R.PIPELINE_ROUNDS):
            st, m = step(st, batch, jnp.asarray(R.pipeline_mask(plan, t)))
            rounds.append({
                **seen,
                "state": {k: np.asarray(v) for k, v in
                          (st.comp_state or {}).items()},
                "server": {k: np.asarray(v) for k, v in
                           (st.comp_server or {}).items()},
                "params": np.asarray(spec_t.flatten(st.params)),
                "uplink_bits": float(m.uplink_bits)})
    finally:
        JC.Pipeline.aggregate = agg
    return rounds


def _keys(t: int, n: int) -> torch.Tensor:
    """Round t's (n, 2) client keys (the round step's split of the
    server's key, prng_key(1))."""
    rng = TN.prng_key(1)
    for _ in range(t + 1):
        rng, sub = TN.split(rng)
    return TN.client_keys(sub, 0, n)


def _bits(b):
    return np.unpackbits(b, bitorder="little")


def _erf_rule(name, rk, t, g, got, want):
    """-> (bits differing, bits farther than 4 ulp from their threshold)
    between this rank's group-g bytes and ``want``, on the grid's codec
    input and sigma."""
    rd = rk["rounds"][t]
    comp = TC.Pipeline(R.PIPELINE_SCENARIOS[name][2])
    n = rk["plan"]["client_groups"] * rk["plan"]["n_clients"]
    c = _client(rk, g)
    if comp.codec.sigma_mode == "norm":
        sig = torch.from_numpy(rd["norms"][g])
    else:
        sig = torch.full((1,), comp.codec.sigma)
    return TO.erf_rule_flips(
        torch.from_numpy(rd["codec_in"][g]), _keys(t, n)[c:c + 1], sig,
        comp.codec.z, torch.tensor(got[None]), torch.tensor(want[None]),
        tile0=rd["tile0"])


def _ranks_of(ranks, name):
    return [rk[name] for rk in ranks]


# ---------------------------------------------------------------------------
# the range state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_range_state_shapes_padding_and_dead_rows(run, spec):
    """Each rank holds (G, 1, hi - lo) of each client slot and (hi - lo,)
    of each server slot, never a (d,) row; the padding past d stays zero
    (it feeds no residual); the client that round 1 drops keeps its rows
    bit for bit; the ranks of a replica summed the same statistic bits."""
    _, ranks = run
    for grid in R.PIPELINE_GRIDS:
        name = f"{spec}_{grid}"
        recs = _ranks_of(ranks, name)
        _, plan = _plan(name)
        G, N = plan.client_groups, plan.n_clients
        comp = TC.Pipeline(R.PIPELINE_SPECS[spec])
        slots = {s.name: s.scope for s in comp.state_slots(1)}
        for rk in recs:
            lo, hi = rk["bounds"]
            real = max(0, min(hi, rk["d"]) - lo)
            assert hi - lo < rk["d"]
            for rd in rk["rounds"]:
                assert {**{k: "client" for k in rd["state"]},
                        **{k: "server" for k in rd["server"]}} == slots
                for v in rd["state"].values():
                    assert v.shape == (G, 1, hi - lo)
                    assert not v[..., real:].any()
                for v in rd["server"].values():
                    assert v.shape == (hi - lo,)
                    assert not v[real:].any()
            for k, v in rk["rounds"][1]["state"].items():
                for g in range(G):
                    dead = _client(rk, g) == G * N - 1
                    before = rk["rounds"][0]["state"][k][g]
                    if dead:
                        np.testing.assert_array_equal(_i32(v[g]),
                                                      _i32(before))
                    elif real:
                        assert not np.array_equal(_i32(v[g]), _i32(before))
        if spec in STAT:
            _grid_stats(name, recs)


# ---------------------------------------------------------------------------
# against the port's one-process round
# ---------------------------------------------------------------------------

def _assert_grid_is(name, recs, one, exact_stats: bool):
    """The grid's ranges against the one-process rounds ``one``: bytes,
    state and server rows, decoded ranges and params bit-identical
    (``exact_stats``), or, on the EF wire, within EF_RTOL where every
    wire bit agrees, and on sto-sign and DP, bits off by the erf rule."""
    _, plan = _plan(name)
    G, N = plan.client_groups, plan.n_clients
    spec = name.rsplit("_", 1)[0]
    weighted = spec in ("ef", "ef_f1")
    agree = np.ones(recs[0]["d"], bool)
    for t in range(R.PIPELINE_ROUNDS):
        for rk in recs:
            lo, hi = rk["bounds"]
            real = max(0, min(hi, rk["d"]) - lo)
            rd, od = rk["rounds"][t], one[t]
            for g, got in enumerate(rd["bytes"]):
                c = _client(rk, g)
                want = od["payload"]["packed"][c][lo // 8:hi // 8]
                if exact_stats or spec not in STAT:
                    np.testing.assert_array_equal(got[0], want)
                elif weighted:
                    np.testing.assert_allclose(
                        rd["scale"][g], od["payload"]["scale"][c:c + 1],
                        rtol=EF_RTOL)
                else:
                    _, far = _erf_rule(name, rk, t, g, got[0], want)
                    assert far == 0
                agree[lo:lo + real] &= (_bits(got[0]) == _bits(want))[:real]
            if exact_stats:
                np.testing.assert_array_equal(
                    _i32(rd["decoded"]), _i32(od["decoded"][lo:hi]))
            for kind in ("state", "server"):
                for k, v in rd[kind].items():
                    w = od[kind][k]
                    for g in range(G if kind == "state" else 1):
                        got = v[g, 0, :real] if kind == "state" else v[:real]
                        want = (w[g, _client(rk, g) % N, lo:lo + real]
                                if kind == "state" else w[lo:lo + real])
                        if exact_stats or not weighted:
                            ok = agree[lo:lo + real] | exact_stats
                            np.testing.assert_array_equal(_i32(got[ok]),
                                                          _i32(want[ok]))
                        else:
                            scale = float(np.max(od["payload"]["scale"]))
                            ok = agree[lo:lo + real]
                            np.testing.assert_allclose(
                                got[ok], want[ok], rtol=EF_RTOL,
                                atol=EF_RTOL * scale)
            # n_live is clamped to 1, as in every round step
            assert rd["uplink_bits"] == od["uplink_bits"] == float(
                rk["d"] * max(1.0, R.pipeline_mask(plan, t).sum()))
        got = _assembled(name, recs, t)
        if exact_stats:
            np.testing.assert_array_equal(_i32(got), _i32(od["params"]))
        elif weighted:
            np.testing.assert_allclose(
                got[agree], od["params"][agree], rtol=EF_RTOL,
                atol=EF_RTOL * float(np.max(od["payload"]["scale"])))
        else:
            np.testing.assert_array_equal(_i32(got[agree]),
                                          _i32(od["params"][agree]))
        for rk in recs:
            np.testing.assert_allclose(rk["rounds"][t]["norm"], od["norm"],
                                       rtol=NORM_RTOL)


@pytest.mark.parametrize("name", sorted(R.PIPELINE_SCENARIOS))
def test_grid_is_the_one_process_round_given_its_statistics(run, name):
    """Given the grid's summed statistics, the one-process round is the
    grid's bit for bit: the range bytes, the state and server rows (the
    padding zero), the decoded range (the scale-weighted sum included:
    the all-gathered payloads reduce in global client order), the params,
    the loss and the uplink bits."""
    inputs, ranks = run
    recs = _ranks_of(ranks, name)
    spec = name.rsplit("_", 1)[0]
    stats = _grid_stats(name, recs) if spec in STAT else None
    _assert_grid_is(name, recs, _one_process(name, inputs, stats), True)


@pytest.mark.parametrize("spec", SPECS)
def test_grid_against_the_one_process_round(run, spec):
    """Against the one-process round as it is: bit-identical where no
    statistic spans the shards (noisy EF, cv, sigma_sched); EF's scale,
    residuals and params within EF_RTOL; sto-sign's and DP's bits by the
    erf rule, everything else bit-identical where the bits agree."""
    inputs, ranks = run
    for grid in R.PIPELINE_GRIDS:
        name = f"{spec}_{grid}"
        _assert_grid_is(name, _ranks_of(ranks, name),
                        _one_process(name, inputs), spec not in STAT)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_grid_against_the_reference(run, spec):
    """Against the reference's single-device round, op by op: noise-free
    bits (cv, EF's round 0) bit-identical; z = 1, sto-sign and DP bits off
    only by the erf rule; EF's round-1 bits off only where p = g + e lies
    within 1e-5 of the scale of 0 under either residual; the EF scale,
    residuals and params within EF_RTOL, and every other state row,
    server row and param bit-identical, where every wire bit agrees; the
    uplink bits equal."""
    inputs, ranks = run
    weighted = spec in ("ef", "ef_f1")
    for grid in R.PIPELINE_GRIDS:
        name = f"{spec}_{grid}"
        recs = _ranks_of(ranks, name)
        ref = _reference(name, inputs)
        _, plan = _plan(name)
        G, N = plan.client_groups, plan.n_clients
        d = recs[0]["d"]
        agree = np.ones(d, bool)
        for t in range(R.PIPELINE_ROUNDS):
            jd = ref[t]
            for rk in recs:
                lo, hi = rk["bounds"]
                real = max(0, min(hi, d) - lo)
                rd = rk["rounds"][t]
                for g, got in enumerate(rd["bytes"]):
                    c = _client(rk, g)
                    # the reference's EF payload stops at ceil(d / 8)
                    # bytes, the port's at the encode tile
                    want = jd["payload"]["packed"][c][lo // 8:hi // 8]
                    diff = np.nonzero(_bits(got[0])[:real]
                                      != _bits(want)[:real])[0]
                    if weighted:
                        np.testing.assert_allclose(
                            rd["scale"][g], jd["payload"]["scale"][c:c + 1],
                            rtol=EF_RTOL)
                        if t == 0:
                            assert diff.size == 0
                        else:
                            p = rd["codec_in"][g][0, diff]
                            assert np.all(np.abs(p) <= 1e-5 * rd["scale"][g])
                    else:
                        _, far = _erf_rule(name, rk, t, g, got[0], want)
                        assert far == 0
                    agree[lo + diff] = False
            for rk in recs:
                lo, hi = rk["bounds"]
                real = max(0, min(hi, d) - lo)
                ok = agree[lo:lo + real]
                rd = rk["rounds"][t]
                for kind in ("state", "server"):
                    for k, v in rd[kind].items():
                        w = jd[kind][k]
                        for g in range(G if kind == "state" else 1):
                            got = (v[g, 0, :real] if kind == "state"
                                   else v[:real])
                            want = (w[g, _client(rk, g) % N, lo:lo + real]
                                    if kind == "state" else w[lo:lo + real])
                            if weighted:
                                scale = float(np.max(jd["payload"]["scale"]))
                                np.testing.assert_allclose(
                                    got[ok], want[ok], rtol=EF_RTOL,
                                    atol=EF_RTOL * scale)
                            else:
                                np.testing.assert_array_equal(
                                    _i32(got[ok]), _i32(want[ok]))
                assert rd["uplink_bits"] == jd["uplink_bits"]
            got = _assembled(name, recs, t)
            if weighted:
                np.testing.assert_allclose(
                    got[agree], jd["params"][agree], rtol=EF_RTOL,
                    atol=EF_RTOL * float(np.max(jd["payload"]["scale"])))
            else:
                np.testing.assert_array_equal(_i32(got[agree]),
                                              _i32(jd["params"][agree]))
        print(f"{name}: {int((~agree).sum())} of {d} coordinates with a "
              "wire bit off the reference's")


# ---------------------------------------------------------------------------
# the new collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_new_collectives_closed_form(run, spec):
    """A rank a round: one 4-byte partial sum of the whole-vector
    statistic a group over the replica (the EF scale's |p| sum, the clip
    or sto-sign norm's sum of squares); on the EF wire with clients side
    by side, the all-gather of every client's range bytes and scale in
    place of the f32 client sum."""
    _, ranks = run
    comp = TC.Pipeline(R.PIPELINE_SPECS[spec])
    for grid in R.PIPELINE_GRIDS:
        name = f"{spec}_{grid}"
        _, plan = _plan(name)
        G, N = plan.client_groups, plan.n_clients
        replica = 4 // N > 1
        for rk in _ranks_of(ranks, name):
            lo, hi = rk["bounds"]
            for rd in rk["rounds"]:
                by_use = rd["collective_by_use"]
                stat = {"ef": "abs_sum", "ef_f1": "abs_sum",
                        "dp": "row_norm", "stosign": "row_norm"}.get(spec)
                for use in ("abs_sum", "row_norm"):
                    want = 4 * G if use == stat and replica else 0
                    assert by_use.get(f"all_reduce:{use}", 0) == want
                gathered = comp.scale_weighted and N > 1
                assert by_use.get("all_gather:wire_bytes", 0) == (
                    N * G * (hi - lo) // 8 if gathered else 0)
                assert by_use.get("all_gather:wire_scale", 0) == (
                    4 * N * G if gathered else 0)
                assert by_use.get("all_reduce:client_sum", 0) == (
                    4 * (hi - lo) if N > 1 and not gathered else 0)
