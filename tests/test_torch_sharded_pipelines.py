"""The pipelines on the port's model-sharded client replica
(``core/fedavg.build_sharded_round_step``): ``ef|zsign`` (both routes,
F1's by its plain version here), noisy EF, ``cv|zsign_packed``, the DP
clip fused into ``zsign_packed``, ``sigma_sched`` and ``stosign``; the
robust sign laws (``agg=vote|trimmed(f=1)|median``), alone and under each
kind of wire adversary; dense z = 2 (``zsign_packed(z=2)``: C1's plain
version over a range); ``topk``, ``ef|topk``, ``topk(agg=coord)`` and
``sigma_sched|topk`` (a codec whose pad multiple is 1 behind the
leaf-offset stage: the range's first coordinate is the same for every
codec); ``qsgd(s=1)``; and dpgauss (``dp(clip=1.0,noise=0.1)|dense``).

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
masks; z = 2 and dpgauss draw their dense noise from one numpy table by
client key in every run that is held to the reference (their
``*_block_22`` scenarios draw the port's block-keyed noise, held to the
one-process round bit for bit):

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
    4 f32 ulp of their thresholds (the suite's erf rule); QSGD's and
    dpgauss's f32 wire (the norm's ulp) within DENSE_RTOL;
  * the reference's single-device ``build_round_step``, op by op: the
    same rules, plus z = 1's erf rule, and EF's bits in round 1 off only
    where the two residuals put p within 1e-5 of the scale of 0; z = 2's
    bits and top-k's pairs equal; QSGD's and dpgauss's wire within
    DENSE_RTOL and their params within the one-process atol 1e-6 (the
    reference sums the dense wire by an einsum).

Every rank holds its range of each state slot, (G, 1, hi - lo) and (hi -
lo,), its padding zero; a dead client keeps its rows bit for bit; the
ranks of a replica sum the same statistic bits; the new collectives (the
partial sums, the payload all-gathers, top-k's threshold counts) are
counted in closed form. Beside the ranks: the adversary's attack on a
byte range is the slice of the reference's attack on the whole payload,
and a range of the block-keyed dense draw is the slice of the whole
row's, bit for bit.
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
from repro.fed import adversary as JA
from repro.models.api import ModelCfg as JModelCfg
from repro.models.api import build_model as j_build
from repro_torch.core import compression as TC
from repro_torch.core import dp as TD
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.fed import adversary as TA
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
STAT = {"ef": "scale", "ef_f1": "scale", "dp": "norms", "stosign": "norms",
        "qsgd": "norms", "dpgauss": "norms"}
#: QSGD's and dpgauss's f32 wire against a run whose norm differs by an
#: ulp (the range partials' order): rtol, and atol as this share of the
#: largest entry
DENSE_RTOL = 1e-5
#: dpgauss's params against the reference (its one-process atol: the
#: reference's einsum sums the dense wire in another order)
DENSE_PARAMS_ATOL = 1e-6


def _spec(name):
    """The PIPELINE_SPECS key of a scenario."""
    spec = R.PIPELINE_SCENARIOS[name][2]
    return next(k for k, v in R.PIPELINE_SPECS.items() if v == spec)


def _kind(name) -> str:
    """The scenario's wire: "sign" (bitpacked), "dense" (f32) or "coo"."""
    layout = TC.Pipeline(R.PIPELINE_SCENARIOS[name][2]).wire_format().layout
    return {"dense": "dense", "sparse_coo": "coo"}.get(layout, "sign")


def _inputs():
    jb = j_build(JModelCfg(dtype=jnp.float32, **R.MODEL))
    params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    G = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.05, params) for _ in range(4)]
    d = sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(params))
    # the dense noise of every client key of the rounds, one numpy row each
    noise = {}
    for t in range(R.PIPELINE_ROUNDS):
        for k in _keys(t, 4).tolist():
            noise[tuple(k)] = rng.standard_normal(d).astype(np.float32)
    return {"params": params, "G": G, "noise": noise,
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
    shape, big, _, opt = R.PIPELINE_SCENARIOS[name]
    grid = _Grid(shape)
    return grid, R.plan_for(grid, big, groups=opt.get("groups"))


def _opts(name) -> dict:
    return R.PIPELINE_SCENARIOS[name][3]


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
    kind = STAT[_spec(name)]
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


def _numpy_payload(p) -> dict:
    if isinstance(p, dict):
        return {k: np.array(v) for k, v in p.items()}
    return {"packed" if np.asarray(p).dtype == np.uint8 else "dense":
            np.array(p)}


def _stack(payloads):
    """A round's payload records (one a group or call) -> one record, the
    rows of every client in global order (None: none was recorded)."""
    if not payloads:
        return None
    return {k: np.concatenate([p[k] for p in payloads])
            for k in payloads[0]}


def _one_process(name, inputs, stats=None):
    """The port's one-process rounds of the scenario's cohort -> per
    round: the payload stack as encoded ("payload") and as the aggregate
    took it, after the adversary ("sent"), the decoded vector, the state
    and server slots, the params and the uplink bits. ``stats``
    (``_grid_stats``) stands in for the one-process EF scale or norms."""
    _, plan = _plan(name)
    spec, opts = R.PIPELINE_SCENARIOS[name][2], _opts(name)
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
    step = TF.build_round_step(loss_fn, comp, cfg, SH.round_context(
        plan, adversary=opts.get("adversary", "none")))
    st = TF.init_server_state(params, cfg, comp, TN.prng_key(1))
    seen = {"payload": [], "sent": []}
    queue = [torch.from_numpy(np.concatenate(stats[t][g * N:(g + 1) * N]))
             for t in range(R.PIPELINE_ROUNDS) for g in range(G)] \
        if stats is not None else None

    def encode_batch(self, *a, **k):
        out, rows = enc(self, *a, **k)
        seen["payload"].append(_numpy_payload(
            {k_: v.clone() for k_, v in out.items()}
            if isinstance(out, dict) else out.clone()))
        return out, rows

    def aggregate(self, payload, *a, **k):
        seen["sent"].append(_numpy_payload(
            {k_: v.clone() for k_, v in payload.items()}
            if isinstance(payload, dict) else payload.clone()))
        return agg(self, payload, *a, **k)

    def decode_sum(self, *a, **k):
        g = dec(self, *a, **k)
        seen["decoded"] = g.clone().numpy()
        return g

    def given(*a, **k):
        return queue.pop(0)
    enc, agg, dec = (TC.Pipeline.encode_batch, TC.Pipeline.aggregate,
                     TC.Pipeline.decode_sum)
    mean_abs, norms, draw = TC._mean_abs_rows, TD.row_norms, TN.sample_z_noise
    TC.Pipeline.encode_batch, TC.Pipeline.aggregate, TC.Pipeline.decode_sum \
        = encode_batch, aggregate, decode_sum
    if queue is not None:
        TC._mean_abs_rows = TD.row_norms = given
    if opts.get("table"):
        TN.sample_z_noise = R.table_noise(inputs["noise"])
    rounds = []
    try:
        batch = {"c": torch.from_numpy(inputs["client_index"][:G, :N])}
        for t in range(R.PIPELINE_ROUNDS):
            seen.update(payload=[], sent=[])
            st, m = step(st, batch, R.pipeline_mask(plan, t))
            rounds.append({
                "payload": _stack(seen["payload"]),
                "sent": _stack(seen["sent"]),
                "decoded": seen["decoded"],
                "state": {k: v.clone().numpy() for k, v in
                          (st.comp_state or {}).items()},
                "server": {k: v.clone().numpy() for k, v in
                           (st.comp_server or {}).items()},
                "params": _flat({p: v.numpy()
                                 for p, v in tree_paths(st.params)}),
                "uplink_bits": float(m.uplink_bits),
                "norm": float(m.grad_est_norm)})
    finally:
        TC.Pipeline.encode_batch, TC.Pipeline.aggregate, \
            TC.Pipeline.decode_sum = enc, agg, dec
        TC._mean_abs_rows, TD.row_norms, TN.sample_z_noise = (mean_abs,
                                                              norms, draw)
    if queue is not None:
        assert not queue, "a statistic was not asked for"
    return rounds


def _reference(name, inputs):
    """The reference's single-device rounds, op by op, of the scenario's
    cohort: the payload the aggregate took ("sent") and the per-round
    record of ``_one_process``. The table's noise stands in for z = 2's
    ``noise.sample_z_noise`` and dpgauss's ``jax.random.normal``."""
    _, plan = _plan(name)
    spec, opts = R.PIPELINE_SCENARIOS[name][2], _opts(name)
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
    step = JF.build_round_step(loss_fn, comp, cfg, JF.RoundContext(
        weights_are_mask=True, adversary=opts.get("adversary", "none")))
    st = JF.init_server_state(jparams, cfg, comp, jax.random.PRNGKey(1))
    spec_t = JW.tree_spec(jparams)
    seen = {"sent": []}
    jkeys = jnp.asarray(np.asarray(list(inputs["noise"]), np.uint32))
    jtable = jnp.asarray(np.stack(list(inputs["noise"].values())))

    def row(key, shape):
        # a lookup that traces: the reference may vmap its encode
        hit = jnp.all(jkeys == key.reshape(1, 2), axis=1)
        return jtable[jnp.argmax(hit)].reshape(shape)

    def aggregate(self, payload, *a, **k):
        # the dense wire's group scan aggregates under jit: no values
        if not any(isinstance(v, jax.core.Tracer)
                   for v in jax.tree_util.tree_leaves(payload)):
            seen["sent"].append(_numpy_payload(payload))
        return agg(self, payload, *a, **k)
    agg, sample, normal = JC.Pipeline.aggregate, JN.sample_z_noise, \
        jax.random.normal
    JC.Pipeline.aggregate = aggregate
    if opts.get("table"):
        JN.sample_z_noise = lambda key, shape, z, dtype=None: row(key, shape)
        jax.random.normal = lambda key, shape, dtype=None: row(key, shape)
    rounds = []
    try:
        batch = {"c": jnp.asarray(inputs["client_index"][:G, :N])}
        for t in range(R.PIPELINE_ROUNDS):
            seen["sent"] = []
            st, m = step(st, batch, jnp.asarray(R.pipeline_mask(plan, t)))
            rounds.append({
                "sent": _stack(seen["sent"]),
                "state": {k: np.asarray(v) for k, v in
                          (st.comp_state or {}).items()},
                "server": {k: np.asarray(v) for k, v in
                           (st.comp_server or {}).items()},
                "params": np.asarray(spec_t.flatten(st.params)),
                "uplink_bits": float(m.uplink_bits)})
    finally:
        JC.Pipeline.aggregate, JN.sample_z_noise = agg, sample
        jax.random.normal = normal
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


def _range_coo(values, indices, lo, real):
    """One client's COO row restricted to [lo, lo + real), its order kept,
    with range-local indices."""
    keep = (indices >= lo) & (indices < lo + real)
    return values[keep], indices[keep] - lo


def _payload_vs(kind, got, want, c, lo, hi, real, exact=True):
    """A rank's payload record of one client (``got``, one row) against
    the whole-row record ``want`` of client c: the byte slice, the dense
    slice (within DENSE_RTOL unless ``exact``) or the COO entries in the
    range; on the sign wire, where ``exact``, the whole byte slice equal.
    -> the coordinates of the range whose wire bits differ (sign), else
    none."""
    if kind == "sign":
        w = want["packed"][c][lo // 8:hi // 8]
        if exact:
            # the whole byte slice, the last range's padding bytes included
            np.testing.assert_array_equal(got["packed"][0], w)
        return np.nonzero(_bits(got["packed"][0])[:real] != _bits(w)[:real])[0]
    if kind == "dense":
        g, w = got["dense"][0], want["dense"][c][lo:lo + real]
        assert not g[real:].any()
        if exact:
            np.testing.assert_array_equal(_i32(g[:real]), _i32(w))
        else:
            np.testing.assert_allclose(
                g[:real], w, rtol=DENSE_RTOL,
                atol=DENSE_RTOL * float(np.abs(want["dense"]).max()))
        return np.zeros(0, np.int64)
    v, i = _range_coo(want["values"][c], want["indices"][c], lo, real)
    np.testing.assert_array_equal(got["indices"][0], i)
    np.testing.assert_array_equal(_i32(got["values"][0]), _i32(v))
    return np.zeros(0, np.int64)


# ---------------------------------------------------------------------------
# the range state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_range_state_shapes_padding_and_dead_rows(run, spec):
    """Each rank holds (G, 1, hi - lo) of each client slot and (hi - lo,)
    of each server slot, never a (d,) row; the padding past d stays zero
    (it feeds no residual); the client that round 1 drops keeps its rows
    bit for bit; the ranks of a replica summed the same statistic bits;
    top-k's kept entries over the ranges of a client number k."""
    _, ranks = run
    for grid in R.PIPELINE_GRIDS:
        name = f"{spec}_{grid}"
        recs = _ranks_of(ranks, name)
        _, plan = _plan(name)
        G, N = plan.client_groups, plan.n_clients
        comp = TC.Pipeline(R.PIPELINE_SPECS[spec])
        slots = {s.name: s.scope for s in comp.state_slots(1)}
        kept = {}
        for rk in recs:
            lo, hi = rk["bounds"]
            real = max(0, min(hi, rk["d"]) - lo)
            assert hi - lo < rk["d"]
            for t, rd in enumerate(rk["rounds"]):
                assert {**{k: "client" for k in rd["state"]},
                        **{k: "server" for k in rd["server"]}} == slots
                for v in rd["state"].values():
                    assert v.shape == (G, 1, hi - lo)
                    assert not v[..., real:].any()
                for v in rd["server"].values():
                    assert v.shape == (hi - lo,)
                    assert not v[real:].any()
                for g, p in enumerate(rd["payload"]):
                    if "indices" in p:
                        kept[(t, _client(rk, g), lo)] = p["indices"].shape[1]
            for k, v in rk["rounds"][1]["state"].items():
                for g in range(G):
                    dead = _client(rk, g) == G * N - 1
                    before = rk["rounds"][0]["state"][k][g]
                    if dead:
                        np.testing.assert_array_equal(_i32(v[g]),
                                                      _i32(before))
                    elif real:
                        assert not np.array_equal(_i32(v[g]), _i32(before))
        if comp.wire_format().layout == "sparse_coo":
            k = max(1, int(recs[0]["d"] * comp.codec.frac))
            total = {}
            for (t, c, _), n in kept.items():
                total[(t, c)] = total.get((t, c), 0) + n
            assert set(total.values()) == {k}
        if spec in STAT:
            _grid_stats(name, recs)


# ---------------------------------------------------------------------------
# against the port's one-process round
# ---------------------------------------------------------------------------

def _assert_grid_is(name, recs, one, exact_stats: bool):
    """The grid's ranges against the one-process rounds ``one``: payload,
    state and server rows, decoded ranges and params bit-identical
    (``exact_stats``), or, on the EF wire, within EF_RTOL where every
    wire bit agrees, on sto-sign and DP, bits off by the erf rule, and on
    QSGD's and dpgauss's f32 wire within DENSE_RTOL. Under an adversary
    the attacked payloads are the slices of the one-process attack's."""
    _, plan = _plan(name)
    G, N = plan.client_groups, plan.n_clients
    spec, kind = _spec(name), _kind(name)
    weighted = spec in ("ef", "ef_f1")
    dense_tol = kind == "dense" and spec in STAT and not exact_stats
    comp = TC.Pipeline(R.PIPELINE_SCENARIOS[name][2])
    adversary = _opts(name).get("adversary")
    agree = np.ones(recs[0]["d"], bool)
    for t in range(R.PIPELINE_ROUNDS):
        od = one[t]
        for rk in recs:
            lo, hi = rk["bounds"]
            real = max(0, min(hi, rk["d"]) - lo)
            rd = rk["rounds"][t]
            for g, got in enumerate(rd["payload"]):
                c = _client(rk, g)
                if kind == "sign" and not exact_stats and spec in STAT:
                    want = od["payload"]["packed"][c][lo // 8:hi // 8]
                    if weighted:
                        np.testing.assert_allclose(
                            rd["scale"][g], od["payload"]["scale"][c:c + 1],
                            rtol=EF_RTOL)
                    else:
                        _, far = _erf_rule(name, rk, t, g,
                                           got["packed"][0], want)
                        assert far == 0
                    diff = np.nonzero(_bits(got["packed"][0])[:real]
                                      != _bits(want)[:real])[0]
                else:
                    diff = _payload_vs(kind, got, od["payload"], c, lo, hi,
                                       real, not dense_tol)
                    assert diff.size == 0
                agree[lo + diff] = False
                if adversary:
                    assert _payload_vs(kind, rd["attacked"][g], od["sent"],
                                       c, lo, hi, real).size == 0
            if exact_stats and kind == "sign":
                # the decode of the padding too
                np.testing.assert_array_equal(
                    _i32(rd["decoded"]), _i32(od["decoded"][lo:hi]))
            elif exact_stats:
                np.testing.assert_array_equal(
                    _i32(rd["decoded"][:real]),
                    _i32(od["decoded"][lo:lo + real]))
                assert not rd["decoded"][real:].any()
            for skind in ("state", "server"):
                for k, v in rd[skind].items():
                    w = od[skind][k]
                    for g in range(G if skind == "state" else 1):
                        got = v[g, 0, :real] if skind == "state" else v[:real]
                        want = (w[g, _client(rk, g) % N, lo:lo + real]
                                if skind == "state" else w[lo:lo + real])
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
            assert rd["uplink_bits"] == od["uplink_bits"]
            if not adversary:
                assert rd["uplink_bits"] == float(
                    rk["d"] * comp.wire_bits_per_coord
                    * max(1.0, R.pipeline_mask(plan, t).sum()))
        got = _assembled(name, recs, t)
        if exact_stats:
            np.testing.assert_array_equal(_i32(got), _i32(od["params"]))
        elif weighted:
            np.testing.assert_allclose(
                got[agree], od["params"][agree], rtol=EF_RTOL,
                atol=EF_RTOL * float(np.max(od["payload"]["scale"])))
        elif dense_tol:
            np.testing.assert_allclose(got, od["params"], rtol=DENSE_RTOL,
                                       atol=DENSE_PARAMS_ATOL)
        else:
            np.testing.assert_array_equal(_i32(got[agree]),
                                          _i32(od["params"][agree]))
        for rk in recs:
            np.testing.assert_allclose(rk["rounds"][t]["norm"], od["norm"],
                                       rtol=NORM_RTOL)


@pytest.mark.parametrize("name", sorted(n for n in R.PIPELINE_SCENARIOS
                                        if not n.startswith("adv_")))
def test_grid_is_the_one_process_round_given_its_statistics(run, name):
    """Given the grid's summed statistics, the one-process round is the
    grid's bit for bit: the range payloads (bytes, dense rows, top-k's
    pairs), the state and server rows (the padding zero), the decoded
    range (the scale-weighted sum and the vote pair included: the
    all-gathered payloads reduce in global client order; the dense wire
    folds in it), the params, the loss and the uplink bits. The
    ``*_block_22`` scenarios draw the block-keyed dense noise, each range
    its slice of the whole row's."""
    inputs, ranks = run
    recs = _ranks_of(ranks, name)
    stats = _grid_stats(name, recs) if _spec(name) in STAT else None
    _assert_grid_is(name, recs, _one_process(name, inputs, stats), True)


@pytest.mark.parametrize("spec", SPECS)
def test_grid_against_the_one_process_round(run, spec):
    """Against the one-process round as it is: bit-identical where no
    statistic spans the shards (noisy EF, cv, sigma_sched, the robust
    laws, z = 2, top-k); EF's scale, residuals and params within EF_RTOL;
    sto-sign's and DP's bits by the erf rule, everything else
    bit-identical where the bits agree; QSGD's and dpgauss's wire and
    params within DENSE_RTOL."""
    inputs, ranks = run
    for grid in R.PIPELINE_GRIDS:
        name = f"{spec}_{grid}"
        _assert_grid_is(name, _ranks_of(ranks, name),
                        _one_process(name, inputs), spec not in STAT)


@pytest.mark.parametrize("name", sorted(R.ADVERSARY_SCENARIOS))
def test_attacked_grid_is_the_one_process_round(run, name):
    """Each robust law under each adversary kind, with 2 clients side by
    side and on the big plan's 2 groups: the dropped client's mask, each
    attacked range payload (the slice of the one-process attack's), the
    vote pair's decode, the params and the uplink bits bit-identical to
    the one-process round under the same adversary."""
    inputs, ranks = run
    _assert_grid_is(name, _ranks_of(ranks, name), _one_process(name, inputs),
                    True)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _assert_grid_is_the_reference(name, recs, ref):
    """The grid against the reference's rounds ``ref``, op by op: sign
    bits by the erf rule (EF's round 1 where p lies within 1e-5 of the
    scale of 0; z = 2's, under the table's noise, equal), the sent
    (attacked) bytes too; top-k's pairs equal; QSGD's and dpgauss's wire
    within DENSE_RTOL; states, server rows and params bit-identical where
    every wire bit agrees (EF within EF_RTOL, the dense wire's params
    within DENSE_PARAMS_ATOL); the uplink bits equal."""
    _, plan = _plan(name)
    G, N = plan.client_groups, plan.n_clients
    spec, kind = _spec(name), _kind(name)
    weighted = spec in ("ef", "ef_f1")
    adversary = _opts(name).get("adversary")
    d = recs[0]["d"]
    agree = np.ones(d, bool)
    for t in range(R.PIPELINE_ROUNDS):
        jd = ref[t]
        for rk in recs:
            lo, hi = rk["bounds"]
            real = max(0, min(hi, d) - lo)
            rd = rk["rounds"][t]
            for g, got in enumerate(rd["attacked"] if adversary
                                    else rd["payload"]):
                c = _client(rk, g)
                if kind != "sign":
                    if jd["sent"] is not None:
                        _payload_vs(kind, got, jd["sent"], c, lo, hi, real,
                                    kind != "dense")
                    continue
                # the reference's EF payload stops at ceil(d / 8) bytes,
                # the port's at the encode tile
                want = jd["sent"]["packed"][c][lo // 8:hi // 8]
                diff = np.nonzero(_bits(got["packed"][0])[:real]
                                  != _bits(want)[:real])[0]
                if weighted:
                    np.testing.assert_allclose(
                        rd["scale"][g], jd["sent"]["scale"][c:c + 1],
                        rtol=EF_RTOL)
                    if t == 0:
                        assert diff.size == 0
                    else:
                        p = rd["codec_in"][g][0, diff]
                        assert np.all(np.abs(p) <= 1e-5 * rd["scale"][g])
                elif spec == "z2":
                    assert diff.size == 0
                else:
                    _, far = _erf_rule(name, rk, t, g, got["packed"][0],
                                       want)
                    assert far == 0
                agree[lo + diff] = False
        for rk in recs:
            lo, hi = rk["bounds"]
            real = max(0, min(hi, d) - lo)
            ok = agree[lo:lo + real]
            rd = rk["rounds"][t]
            for skind in ("state", "server"):
                for k, v in rd[skind].items():
                    w = jd[skind][k]
                    for g in range(G if skind == "state" else 1):
                        got = (v[g, 0, :real] if skind == "state"
                               else v[:real])
                        want = (w[g, _client(rk, g) % N, lo:lo + real]
                                if skind == "state" else w[lo:lo + real])
                        if weighted:
                            scale = float(np.max(jd["sent"]["scale"]))
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
                atol=EF_RTOL * float(np.max(jd["sent"]["scale"])))
        elif kind == "dense":
            np.testing.assert_allclose(got, jd["params"], rtol=0,
                                       atol=DENSE_PARAMS_ATOL)
        else:
            np.testing.assert_array_equal(_i32(got[agree]),
                                          _i32(jd["params"][agree]))
    print(f"{name}: {int((~agree).sum())} of {d} coordinates with a "
          "wire bit off the reference's")


@pytest.mark.parametrize("spec", SPECS)
def test_grid_against_the_reference(run, spec):
    """Against the reference's single-device round, op by op: noise-free
    bits (cv, EF's round 0) and z = 2's under the shared noise
    bit-identical; z = 1, sto-sign and DP bits off only by the erf rule;
    EF's round-1 bits off only where p = g + e lies within 1e-5 of the
    scale of 0 under either residual; top-k's pairs equal, QSGD's and
    dpgauss's wire within DENSE_RTOL; the EF scale, residuals and params
    within EF_RTOL, dpgauss's and QSGD's params within
    DENSE_PARAMS_ATOL, and every other state row, server row and param
    bit-identical, where every wire bit agrees; the uplink bits equal.
    (The reference's group scan sums the dense wire under jit, where its
    payload has no values to read: the big plan's dense wire is held by its
    params.)"""
    inputs, ranks = run
    for grid in R.PIPELINE_GRIDS:
        name = f"{spec}_{grid}"
        _assert_grid_is_the_reference(name, _ranks_of(ranks, name),
                                      _reference(name, inputs))


@pytest.mark.parametrize("kind", sorted(R.ADVERSARIES))
def test_attacked_grid_against_the_reference(run, kind):
    """The median under each adversary kind with 2 clients side by side,
    against the reference's round under the same adversary, op by op: the
    attacked bytes the aggregate takes off only by the erf rule, the params
    bit-identical where every wire bit agrees."""
    inputs, ranks = run
    name = f"adv_median_{kind}_22"
    _assert_grid_is_the_reference(name, _ranks_of(ranks, name),
                                  _reference(name, inputs))


# ---------------------------------------------------------------------------
# a range's slice of a whole-row draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(R.ADVERSARIES))
def test_adversary_on_a_byte_range_is_the_slice_of_the_reference(kind):
    """``Adversary.corrupt`` of bytes [b0, b0 + nb) of a payload (a range's
    rows, ``b0``) equals the same bytes of the reference's ``corrupt`` of
    the whole payload, bit for bit, for every client and on ranges that
    cut the draws' slices anywhere; the EF dict's scale is sent as it
    is."""
    spec = {"sign_flip": "sign_flip(f=2)",
            "byte_corrupt": "byte_corrupt(f=2,p=0.3,seed=5)",
            "collude": "collude(f=2,seed=3)", "dropout": "dropout(f=2)"}[kind]
    n, nb = 4, 3000
    rng = np.random.default_rng(3)
    whole = rng.integers(0, 256, (n, nb), dtype=np.uint8)
    idx = np.arange(n)
    want = np.asarray(JA.parse_adversary(spec).bind(n).corrupt(
        jnp.asarray(whole), jnp.asarray(idx), 3))
    adv = TA.parse_adversary(spec).bind(n)
    for b0, b1 in [(0, nb), (0, 1024), (1024, 2048), (1500, 3000),
                   (7, 8)]:
        rows = torch.from_numpy(whole[:, b0:b1].copy())
        scale = torch.arange(n, dtype=torch.float32)
        got = adv.corrupt({"packed": rows, "scale": scale.clone()},
                          torch.from_numpy(idx), 3, b0=b0)
        np.testing.assert_array_equal(got["packed"].numpy(),
                                      want[:, b0:b1])
        assert torch.equal(got["scale"], scale)


@pytest.mark.parametrize("z", [1, 2, 0])
def test_a_range_of_the_dense_draw_is_the_slice_of_the_row(z):
    """``noise.sample_z_noise(key, (n,), z, lo=lo)`` is coordinates [lo,
    lo + n) of the whole row's draw, bit for bit, across block bounds and
    for any row length; the (d,) row of the one-process encode is the
    concatenation of a grid's ranges."""
    key = TN.prng_key(5)
    B = TN.NOISE_BLOCK
    d = 2 * B + 12345
    whole = TN.sample_z_noise(key, (d,), z)
    for lo, hi in [(0, 8192), (B - 8192, B + 8192), (B, 2 * B),
                   (2 * B - 3, d), (123, 124)]:
        np.testing.assert_array_equal(
            _i32(TN.sample_z_noise(key, (hi - lo,), z, lo=lo).numpy()),
            _i32(whole[lo:hi].numpy()))
    # a shorter row is the prefix of a longer one
    np.testing.assert_array_equal(
        _i32(TN.sample_z_noise(key, (B + 5,), z).numpy()),
        _i32(whole[:B + 5].numpy()))


@pytest.mark.parametrize("ranges", [2, 3, 5])
@pytest.mark.parametrize("k", [1, 40, 333, 999])
def test_range_topk_select_is_the_whole_rows_selection(ranges, k):
    """``compression.range_topk_select`` on each range of a row (threads
    standing in for the replica's ranks, their ``all_sum`` and
    ``rank_prefix`` summed at a barrier) keeps exactly ``topk_select``'s
    entries of the whole row, in its order: a row of heavily tied
    magnitudes (signed, zeros among them) whose k-th value is tied across
    range bounds, ties to the lowest global index."""
    import threading
    rng = np.random.default_rng(k)
    row = torch.from_numpy((rng.integers(-6, 7, 1000)
                            * 0.25).astype(np.float32))
    want = TC.topk_select(torch.abs(row), k)
    cuts = np.linspace(0, row.numel(), ranges + 1).astype(int)
    slots, got = [None] * ranges, [None] * ranges
    barrier = threading.Barrier(ranges)

    def exchange(r, t, prefix):
        slots[r] = t.clone()
        barrier.wait()
        parts = slots[:r] if prefix else slots
        out = sum(parts, torch.zeros_like(t))
        barrier.wait()
        return out

    def rank(r):
        got[r] = TC.range_topk_select(
            row[cuts[r]:cuts[r + 1]], k,
            lambda t, use: exchange(r, t, False),
            lambda t, use: exchange(r, t, True)) + cuts[r]
    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(ranges)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    union = torch.cat(got)
    assert sorted(union.tolist()) == sorted(want.tolist())
    for r in range(ranges):
        # each range's entries in the whole selection's order
        mine = want[(want >= cuts[r]) & (want < cuts[r + 1])]
        assert got[r].tolist() == mine.tolist()


# ---------------------------------------------------------------------------
# the new collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_new_collectives_closed_form(run, spec):
    """A rank a round: one 4-byte partial sum of the whole-vector
    statistic a group over the replica (the EF scale's |p| sum, the clip,
    sto-sign or QSGD norm's sum of squares); top-k's four 256-bin int64
    counts and its ties' prefix (an int64 a replica rank) a group; on the
    sign wire with clients side by side, the all-gather of every client's
    range bytes (and EF's scale); top-k's pairs all-gathered with their
    counts; the dense wire's client sum one (hi - lo,) f32 fold a group
    (G laps: the ``*_g2_22`` scenarios run 2 groups of 2 clients side by
    side)."""
    _, ranks = run
    comp = TC.Pipeline(R.PIPELINE_SPECS[spec])
    layout = comp.wire_format().layout
    names = [f"{spec}_{grid}" for grid in R.PIPELINE_GRIDS]
    names += [n for n in (f"{spec}_g2_22",) if n in R.PIPELINE_SCENARIOS]
    for name in names:
        _, plan = _plan(name)
        G, N = plan.client_groups, plan.n_clients
        replica = WORLD // N
        for rk in _ranks_of(ranks, name):
            lo, hi = rk["bounds"]
            for rd in rk["rounds"]:
                by_use = rd["collective_by_use"]
                stat = {"ef": "abs_sum", "ef_f1": "abs_sum",
                        "dp": "row_norm", "stosign": "row_norm",
                        "qsgd": "row_norm", "dpgauss": "row_norm"}.get(spec)
                for use in ("abs_sum", "row_norm"):
                    want = 4 * G if use == stat and replica > 1 else 0
                    assert by_use.get(f"all_reduce:{use}", 0) == want
                coo = layout == "sparse_coo"
                assert by_use.get("all_reduce:topk_hist", 0) == (
                    4 * 256 * 8 * G if coo and replica > 1 else 0)
                assert by_use.get("all_gather:topk_ties", 0) == (
                    8 * replica * G if coo and replica > 1 else 0)
                gathered = layout.startswith("bitpacked") and N > 1
                assert by_use.get("all_gather:wire_bytes", 0) == (
                    N * G * (hi - lo) // 8 if gathered else 0)
                assert by_use.get("all_gather:wire_scale", 0) == (
                    4 * N * G if gathered and comp.scale_weighted else 0)
                width = max([p["indices"].shape[1] for p in rd["payload"]]
                            if coo else [0])
                if coo and N > 1:
                    assert by_use["all_gather:topk_counts"] == 8 * N * G
                    assert by_use["all_gather:wire_values"] == \
                        by_use["all_gather:wire_indices"] >= 4 * N * G * width
                else:
                    for use in ("topk_counts", "wire_values",
                                "wire_indices"):
                        assert by_use.get(f"all_gather:{use}", 0) == 0
                assert by_use.get("all_reduce:client_sum", 0) == (
                    4 * G * (hi - lo) if N > 1 and layout == "dense"
                    else 0)
