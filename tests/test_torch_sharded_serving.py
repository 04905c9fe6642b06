"""Serving of the xLSTM, hybrid and enc-dec families on the port's
model-sharded grid against the reference and against the port's one
process: the prefill and decode cells (``launch/dryrun.build_prefill_cell``,
``build_decode_cell``) on four gloo ranks of (data, model) grids of 2 x 2
and 1 x 4 on the CPU (``tests/torch_sharded_serving_ranks.py``, spawned
ONCE for the module), at reduced f32 configs whose cache layouts are
really cut (``launch/sharding.cache_specs``):

  * Jamba at d_model 512 (one super-block; attention, 7 mamba, 4 MoE of 4
    experts top-2 with ``moe_ep``, 4 SwiGLU) on the big plan: the mamba
    state's d_inner of 1,024 over `model`, the K/V slots over `model`, the
    rows over `data`; the MoE expert-parallel;
  * xlstm-350m at d_model 1,024 (one group of 3 mLSTM + 1 sLSTM) on the
    regular plan: the sLSTM's four (1, B, 1,024) leaves over `model` on D,
    the mLSTM's cut on the rows only;
  * seamless reduced (2 + 2 layers): its 2,048 memory slots over `model`
    beside the self-attention's slots, each its own layout; the memory
    filled by the decode cell's ``fill_cache``, each rank projecting its own
    frames into its own slots;
  * a batch-1 case of both sub-quadratic families (the ``long_500k``
    layout: the K/V slots over both axes, the state over `model` alone, the
    data ranks stepping the same state).

The reference runs in a subprocess on a forced-host 4-device CPU platform
(``tests/torch_serving_grid_reference.py``). Against it, within rtol RTOL /
atol ATOL (f32; the grid's softmax folds and gathered sums, the framework's
own orders): the prefill output (the last position's logits; the enc-dec's
memory frame), every decode step's logits, the greedy tokens (each side
feeding back its own argmax), and each rank's final cache slice as the
``cache_specs`` slice of the reference's final cache (its atol scaled by
the leaf's largest magnitude: the mamba's conv tail holds inputs of ~2
after 8 steps, 2.6e-5 off at most measured).

Against the port's one process (the same weights; the grid's decode fed
the one-process tokens): in bf16 the hybrid's and the xLSTM's decode
logits and cache slices are the one-process bits at every step (the
attention's softmax fold rounds the probabilities as one process rounds
them; the mamba step gathers its activations over the channel ranks and
the sLSTM its state, so every sum over channels is whole; the mLSTM steps
its rows), the enc-dec's within relative L2 BF16_REL (its cross-attention
adds the memory slots' f32 products over the ranks, where one process
takes one bf16 matmul: 2.2e-3 measured). In f32 every family's prefill,
decode logits and cache lie within relative L2 ONE_REL of one process (the
CPU's f32 matmuls round 8 rows otherwise than 16, and the prefill sums the
mamba's channel partials; 5.0e-6 at most measured). The bf16 prefill is
not held: the hybrid's rounds the mamba's ``x_proj`` partials over the
channel slices to bf16 before their sum, which routes some tokens to other
experts (0.18 relative L2 measured on the last position's logits).

Each rank's collective bytes, by kind and use, equal the dry run's serving
cells (``dryrun.analyze_serving``) for that rank of a fake group of the
grid's shape. ``hints.serving_hints`` raises ``ValueError`` on a cache spec
that cuts a dimension none of its rules explains.

The module takes ~100 s on one worker.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharded_serving_ranks as S
from repro.models.api import ModelCfg as JModelCfg
from repro.models.api import build_model as j_build
from repro_torch.launch import hints
from repro_torch.launch import sharding as SH
from repro_torch.models.api import build_model

torch.set_num_threads(1)

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
NAMES = list(S.SCENARIOS)
#: against the reference (f32)
RTOL, ATOL = 2e-4, 2e-5
#: the f32 grid against the port's one process: relative L2 of the
#: prefill, each step's logits and each cache leaf
ONE_REL = 2e-5
#: the bf16 enc-dec grid's logits and cache against one process: relative
#: L2
BF16_REL = 1e-2
#: the families whose bf16 decode is the one-process bits (every sum over
#: channels kept whole)
BF16_BITS = ("hybrid", "xlstm")


def _cfg_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


def _inputs():
    import jax
    rng = np.random.default_rng(28)
    ranks = {"params": {}, "prefill": {}, "start": {}, "frames": {}}
    ref = {}
    for model in S.MODELS:
        name = next(n for n in NAMES if S.SCENARIOS[n][0] == model)
        cfg = S.arch(name).model
        jcfg = JModelCfg(**_cfg_fields(cfg), dtype=jax.numpy.float32)
        ranks["params"][model] = jax.tree.map(
            np.asarray, j_build(jcfg).init(jax.random.PRNGKey(0)))
    for name, (model, grid, _, batch, slots, steps, (pb, ps)) in \
            S.SCENARIOS.items():
        cfg = S.arch(name).model
        if model == "encdec":
            pre = rng.standard_normal((pb, ps // 2, cfg.d_model),
                                      dtype=np.float32)
            ranks["frames"][name] = rng.standard_normal(
                (batch, S.SRC_LEN, cfg.d_model), dtype=np.float32)
        else:
            pre = rng.integers(0, cfg.vocab, (pb, ps), dtype=np.int32)
        ranks["prefill"][name] = pre
        ranks["start"][name] = rng.integers(0, cfg.vocab, (batch, 1),
                                            dtype=np.int32)
        ref[name] = {"cfg": _cfg_fields(cfg), "grid": grid,
                     "params": ranks["params"][model], "prefill": pre,
                     "start": ranks["start"][name], "slots": slots,
                     "steps": steps}
        if model == "encdec":
            ref[name]["frames"] = ranks["frames"][name]
    return ranks, ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_serving")
    ranks_in, ref_in = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(ranks_in, f)
    with open(out / "ref_in.pkl", "wb") as f:
        pickle.dump(ref_in, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_serving_grid_reference.py"),
         str(out / "ref_in.pkl"), str(out / "ref_out.pkl")], env=env)
    try:
        mp.spawn(S.main, args=(WORLD, str(out / "store"), str(out)),
                 nprocs=WORLD, join=True)
    finally:
        assert ref.wait(timeout=600) == 0
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(out / "ref_out.pkl", "rb") as f:
        want = pickle.load(f)
    return ranks, want


class _Grid:
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.shape = dict(zip(self.axis_names, shape))


def _rank_slice(spec, grid_shape, coords, full):
    """The index of a rank at ``coords`` into the whole leaf ``full`` under
    its cache spec."""
    idx = [slice(None)] * full.ndim
    for dim, axes in SH.spec_dims(spec):
        n, i = 1, 0
        for ax in axes:
            n, i = n * grid_shape[ax], i * grid_shape[ax] + coords[ax]
        per = full.shape[dim] // n
        idx[dim] = slice(i * per, (i + 1) * per)
    return tuple(idx)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", NAMES)
def test_grid_prefill_matches_the_reference(run, name):
    ranks, want = run
    for rk in ranks:
        got = rk[name]["grid"]["prefill"]
        assert got.shape == want[name]["prefill"].shape
        np.testing.assert_allclose(got, want[name]["prefill"], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_grid_decode_logits_match_the_reference_every_step(run, name):
    ranks, want = run
    for rk in ranks:
        for t, (got, ref) in enumerate(zip(rk[name]["grid"]["logits"],
                                           want[name]["logits"])):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t}")


@pytest.mark.parametrize("name", NAMES)
def test_grid_decode_gives_the_reference_greedy_tokens(run, name):
    ranks, want = run
    for rk in ranks:
        np.testing.assert_array_equal(np.stack(rk[name]["grid"]["tokens"]),
                                      np.stack(want[name]["tokens"]))


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_cache_is_the_cache_specs_slice_of_the_reference(run,
                                                                   name):
    """Every leaf of each rank's final cache (the K/V and memory slots, the
    mamba and xLSTM states) has the ``cache_specs`` shard's shape and holds
    the reference's final cache at its rows, slots and channels."""
    ranks, want = run
    grid_shape = _Grid(S.SCENARIOS[name][1]).shape
    for rk in ranks:
        rec = rk[name]["grid"]
        for path, full in _leaves(want[name]["cache"]):
            spec = _at(rec["cache_specs"], path)
            got = _at(rec["cache"], path)
            assert got.shape == SH.shard_shape(full.shape, spec,
                                               _Grid(S.SCENARIOS[name][1]))
            ref = full[_rank_slice(spec, grid_shape, rec["coords"], full)]
            np.testing.assert_allclose(
                got, ref, rtol=RTOL,
                atol=ATOL * max(1.0, float(np.abs(full).max())),
                err_msg=str(path))


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same_output(run, name):
    ranks, _ = run
    first = ranks[0][name]["grid"]
    for rk in ranks[1:]:
        np.testing.assert_array_equal(rk[name]["grid"]["prefill"],
                                      first["prefill"])
        for a, b in zip(rk[name]["grid"]["logits"], first["logits"]):
            np.testing.assert_array_equal(a, b)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _fed_cache_pairs(rec, one, name):
    """(path, the grid's leaf, the one-process leaf's slice) of every
    leaf of the fed run's final cache."""
    grid_shape = _Grid(S.SCENARIOS[name][1]).shape
    for path, full in _leaves(one["cache"]):
        spec = _at(rec["cache_specs"], path)
        yield path, _at(rec["cache"], path), full[
            _rank_slice(spec, grid_shape, rec["coords"], full)]


@pytest.mark.parametrize("name", NAMES)
def test_f32_grid_against_the_one_process_run(run, name):
    ranks, _ = run
    for rk in ranks:
        rec, one = rk[name]["fed"], rk[name]["one"]
        assert _rel(rk[name]["grid"]["prefill"], one["prefill"]) <= ONE_REL
        assert len(rec["logits"]) == len(one["logits"]) > 0
        for t, (got, want) in enumerate(zip(rec["logits"], one["logits"])):
            assert _rel(got, want) <= ONE_REL, t
        for path, got, want in _fed_cache_pairs(rec, one, name):
            assert got.shape == want.shape
            assert not np.any(want) or _rel(got, want) <= ONE_REL, path


@pytest.mark.parametrize("name", S.BF16_SCENARIOS)
def test_bf16_grid_decode_against_the_one_process_decode(run, name):
    ranks, _ = run
    bits = S.SCENARIOS[name][0] in BF16_BITS
    for rk in ranks:
        rec, one = rk["bf16"][name]["fed"], rk["bf16"][name]["one"]
        assert len(rec["logits"]) == len(one["logits"]) > 0
        pairs = [(f"step {t}", g, w) for t, (g, w) in
                 enumerate(zip(rec["logits"], one["logits"]))]
        pairs += [(str(p), g, w) for p, g, w in
                  _fed_cache_pairs(rec, one, name)]
        for what, got, want in pairs:
            if bits:
                np.testing.assert_array_equal(got, want, err_msg=what)
            elif np.any(want):
                assert _rel(got, want) <= BF16_REL, what


@pytest.mark.parametrize("name", NAMES)
def test_collective_bytes_equal_the_dry_run_serving_cells(run, name):
    """Each rank's bytes by kind and use, for the prefill and for every
    decode step, equal ``dryrun.analyze_serving`` of the same cell for
    that rank of a fake group of the grid's shape."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_replica_grid
    ranks, _ = run
    a = S.arch(name)
    pre, dec = S.shapes(name)
    for r, rk in enumerate(ranks):
        dryrun.fake_group(WORLD, r)
        try:
            grid = make_replica_grid(S.SCENARIOS[name][1], ("data", "model"),
                                     device_type="cpu")
            step, ex, _ = dryrun.build_prefill_cell(a, pre, grid)
            p_res = dryrun.analyze_serving(step, ex, grid, name)
            step, ex, _ = dryrun.build_decode_cell(a, dec, grid)
            d_res = dryrun.analyze_serving(step, ex, grid, name)
        finally:
            dist.destroy_process_group()
        assert rk[name]["grid"]["prefill_by_use"] == \
            p_res["collectives_by_use"]
        for t, got in enumerate(rk[name]["grid"]["by_use"]):
            assert got == d_res["collectives_by_use"], f"rank {r} step {t}"


@pytest.mark.parametrize("name", NAMES)
def test_the_layouts_are_cut_and_their_uses_follow(run, name):
    """The states are cut over `model` on their feature dimension (the
    mamba's d_inner, the sLSTM's D) and gathered over it a step by the
    bytes of their activations or state; the enc-dec's memory slots lie over
    `model` and its fold's statistics and products are gathered over them;
    the rows' logits over `data` where the batch is split."""
    ranks, _ = run
    model, grid, _, batch, _, _, _ = S.SCENARIOS[name]
    cfg = S.arch(name).model
    rec = ranks[0][name]["grid"]
    specs, uses = rec["cache_specs"], rec["by_use"][0]
    b_loc = batch // grid[0] if batch > 1 else 1
    if model == "hybrid":
        d_in = 2 * cfg.d_model
        assert specs["h"][3] == "model" and specs["conv"][4] == "model"
        assert rec["cache"]["h"].shape[3] == d_in // grid[1]
        # x_proj's and out_proj's inputs, f32, 7 mamba sublayers
        for use in ("all_gather:mamba_act", "all_gather:mamba_y"):
            assert uses[use] == 7 * b_loc * d_in * 4
        assert uses["all_to_all:moe_dispatch"] > 0
    elif model == "xlstm":
        assert specs["s"]["h"][-1] == "model"
        assert all("model" not in (e or ()) for e in specs["m"]["C"])
        # the four (B_loc, D) f32 leaves, the one sLSTM of the group
        assert uses["all_gather:slstm_state"] == 4 * b_loc * cfg.d_model * 4
    else:
        assert specs["mem_k"][2] == "model" and specs["k"][2] == "model"
        assert uses["all_gather:mem_softmax"] > 0
        assert uses["all_gather:mem_attn"] == \
            cfg.n_layers * grid[1] * b_loc * cfg.d_model * 4
        # the fill projects each rank's own frames: no gather of the memory
        assert not any("mem" in k for k in rec["fill_by_use"])
    assert ("all_gather:logits" in uses) == (batch > 1 and grid[0] > 1)
    if model != "xlstm":
        assert uses["all_gather:decode_softmax"] > 0


def test_the_grid_decode_crosses_every_slot_rank(run):
    """The positions written reach every slot rank's K/V: each rank's
    cache has written (nonzero) slots."""
    ranks, _ = run
    for name in NAMES:
        if S.SCENARIOS[name][0] == "xlstm":
            continue
        for rk in ranks:
            k = rk[name]["grid"]["cache"]["k"]
            assert (np.abs(k).sum(axis=(0, 1, 3, 4)) > 0).any(), name


class _G:
    """A stand-in grid of 2 x 2 for the spec rules alone."""
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}

    def axes(self, axes):
        return tuple(a for a in self.axis_names if a in tuple(axes))


_PLAN = SH.ParallelPlan(("data",), (), ("model",), ("model",), 2, 1, 8, 1)


@pytest.mark.parametrize("case", ["feature_is_batch", "state_is_seq",
                                  "slot_third_dim", "two_features"])
def test_serving_hints_refuse_an_unexplained_cut(case):
    """A cache spec that cuts a dimension none of the rules explains (a
    batch, slot or state feature dimension) raises ``ValueError``: a state
    whose feature dimension equals the batch and is cut as one, a state
    dimension of a sequence's size cut as the slots, a slot leaf cut on its
    head dimension, a state cut on two feature dimensions. The
    reference's ``cache_specs`` shards such dimensions by their size."""
    batch, seq = 16, 12
    shapes = {"k": (1, batch, seq, 2, 8), "v": (1, batch, seq, 2, 8),
              "s": (1, batch, 1024)}
    specs = {"k": (None, "data", "model"), "v": (None, "data", "model"),
             "s": (None, "data", "model")}
    if case == "feature_is_batch":
        shapes["s"] = (1, batch, batch)
        specs["s"] = (None, "data", "data")
    elif case == "state_is_seq":
        shapes["s"] = (1, batch, seq)
        specs["s"] = (None, "data", "model")
    elif case == "slot_third_dim":
        specs["k"] = specs["v"] = (None, "data", "model", "model")
    else:
        specs["s"] = ("model", None, "model")
        shapes["s"] = (batch, 4, 1024)
    # the good layout is accepted
    good = hints._cache_layout(_G(), _PLAN, {
        "k": (None, "data", "model"), "v": (None, "data", "model"),
        "s": (None, "data", "model")}, {"k": (1, batch, seq, 2, 8),
        "v": (1, batch, seq, 2, 8), "s": (1, batch, 1024)}, batch, (seq,))
    assert good == {"rows": ("data",), "slots": {"k": (("model",), seq)},
                    "state": ("model",)}
    with pytest.raises(ValueError):
        hints._cache_layout(_G(), _PLAN, specs, shapes, batch, (seq,))


def test_bundles_serve_every_family():
    """Every family's bundle has a prefill (the enc-dec's returns the
    memory's last frame)."""
    from repro_torch.configs.common import get_arch, list_archs
    for arch_id in list_archs():
        assert build_model(get_arch(arch_id).model).prefill is not None


# ---------------------------------------------------------------------------
# the dry run's serving cells of the three families (the CLI's records at
# full depth; a prefill whose scans loop over 32,768 positions is cut)
# ---------------------------------------------------------------------------

#: the uses each family's serving cell shows, by cell kind
FAMILY_USES = {
    ("hybrid", "decode"): ("all_gather:weight", "all_gather:mamba_act",
                           "all_gather:mamba_y", "all_gather:decode_softmax",
                           "all_gather:decode_attn",
                           "all_to_all:moe_dispatch"),
    ("hybrid", "prefill"): ("all_gather:weight", "all_gather:mamba_in",
                            "all_reduce:mamba_xproj",
                            "reduce_scatter:mamba_out", "all_gather:kv",
                            "all_gather:prefill_last",
                            "all_to_all:moe_dispatch"),
    ("xlstm", "decode"): ("all_gather:weight", "all_gather:slstm_state"),
    ("xlstm", "prefill"): ("all_gather:weight", "all_gather:kv",
                           "all_gather:gates", "all_gather:slstm_in",
                           "all_gather:prefill_last"),
    ("encdec", "decode"): ("all_gather:weight", "all_gather:decode_softmax",
                           "all_gather:mem_softmax", "all_gather:mem_attn"),
    ("encdec", "prefill"): ("all_gather:weight", "all_gather:kv",
                            "all_gather:prefill_last", "all_gather:mem_last"),
}


def serving_record(arch_id, shape_name, *, layers=None, seq=None,
                   multi_pod=False):
    """``dryrun.analyze_serving`` of an arch's serving cell as rank 0 of a
    fake production group, its depth cut to ``layers`` and its sequence
    to ``seq`` where given (the full cell is ``dryrun.run_cell``'s)."""
    import torch.distributed as dist
    from repro_torch.configs.common import SHAPES, ShapeCfg, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    arch = get_arch(arch_id)
    if layers is not None:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=layers))
    shape = SHAPES[shape_name]
    if seq is not None:
        shape = ShapeCfg(shape.name, shape.kind, seq, shape.global_batch)
    dryrun.fake_group(512 if multi_pod else 256, 0)
    try:
        grid = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        build = (dryrun.build_prefill_cell if shape.kind == "prefill"
                 else dryrun.build_decode_cell)
        step, ex, _ = build(arch, shape, grid)
        res = dryrun.analyze_serving(step, ex, grid, arch_id)
    finally:
        dist.destroy_process_group()
    res["fits_hbm"] = res["peak_bytes"] <= dryrun.HBM_BYTES
    return res


def check_family_serving_record(line, arch_id, shape_name):
    """A serving record of the xLSTM, hybrid or enc-dec family: no
    ``not_ported`` and no ``error``, a peak that fits the H100's 80 GB, the
    output of every row (the logits; the enc-dec prefill's memory frame)
    and the uses its layout calls for."""
    from repro_torch.configs.common import SHAPES, get_arch
    assert "error" not in line and "not_ported" not in line, line
    assert line["fits_hbm"] and 0 < line["peak_bytes"] < 80e9, line
    m = get_arch(arch_id).model
    sh = SHAPES[shape_name]
    kind = sh.kind
    width = m.d_model if (m.family, kind) == ("encdec", "prefill") \
        else m.vocab
    assert line["logits_shape"] == [sh.global_batch, 1, width]
    uses = line["collectives_by_use"]
    for use in FAMILY_USES[(m.family, kind)]:
        assert uses.get(use, 0) > 0, (use, uses)
    assert ("all_gather:logits" in uses) == (
        sh.global_batch > 1 and width == m.vocab)
