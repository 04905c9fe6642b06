"""Serving on the port's model-sharded grid against the reference: the
prefill and decode cells (``launch/dryrun.build_prefill_cell``,
``build_decode_cell``) on four gloo ranks of a (data, model) = 2 x 2 grid
on the CPU (``tests/torch_sharded_decode_ranks.py``, spawned ONCE for the
module), at reduced f32 configs (2 layers, d_model 64):

  * the dense model on the regular plan (batch rows over `data`, the
    replica and the cache's slots over `model`) and on the big plan (the
    replica over data x model, the rows over the micro axis `data`);
  * granite-style replicated MoE (the experts gathered a layer);
  * llama4-style ``moe_ep`` on the big plan (E over `model`, d_ff over
    `data`; the decode's dispatch swapped to the experts' ranks);
  * the VLM (internvl2 at vocab 256: the table stored sharded; tokens
    only, as the reference's prefill cell takes them);
  * a batch-1 sliding-window decode (h2o-danube, window 8), whose 24-slot
    cache is split over both axes, 6 slots a rank.

The weights are the reference's ``init`` (numpy, carried across with
``shard_params``). The reference runs in a subprocess on a forced-host
4-device CPU mesh (``tests/torch_decode_grid_reference.py``; an MoE
prefill under its ``sharding_hints``, so its capacity is counted over the
grid's sequence shards). Against it:

  * the grid's greedy tokens equal the reference's at every step (each
    side feeds back its own argmax);
  * the decode logits of every step and the prefill's last-token logits
    within rtol RTOL / atol ATOL of the reference's (f32; the softmax's
    max and sum and the V products are folded over the ranks and the
    gathered weights' matmuls add in another order), the same bits on
    every rank;
  * each rank's cache is the shard ``sharding.cache_specs`` names, and
    holds the reference's final cache at its rows and slots (within the
    same tolerance; a slot no step wrote stays zero);
  * each rank's collective bytes, by kind and use, equal the dry run's
    serving cells (``dryrun.analyze_serving``) for that rank of a fake
    2 x 2 group;
  * a position past the cache, a cache slice of another shape and a
    prefill whose sequence or batch does not split over the grid raise
    ``ValueError``.

The dense regular scenario runs again at bf16 (``BF16_SCENARIOS``), beside
the port's one-process prefill and decode of the same bf16 weights, both
decodes fed the one-process greedy tokens. The grid folds the softmax's
row max and sum over the ranks before it rounds the probabilities to bf16,
and adds the ranks' f32 products with V before their one rounding, as one
process rounds them: its logits at every step, its greedy tokens, its
cache slice and its prefill are the one-process run's bits (measured; a
grid that rounded elsewhere was 8e-3 relative L2 off from step 1 on).

Beside them, ``ModelBundle.subquadratic`` and ``decode_supported`` equal
the reference's for every arch of the registry.

The module takes ~35 s on one worker (the reference's jit ~15 s of it).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharded_decode_ranks as D
from repro.configs.common import get_arch as j_arch
from repro.configs.common import list_archs
from repro.models.api import ModelCfg as JModelCfg
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch
from repro_torch.launch import sharding as SH
from repro_torch.models.api import build_model

torch.set_num_threads(1)

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
#: logits against the reference's (f32 at every width of these configs)
RTOL, ATOL = 1e-4, 1e-5
NAMES = list(D.DECODE_SCENARIOS)


def _cfg_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


def _inputs():
    rng = np.random.default_rng(21)
    ranks = {"params": {}, "prefill_tokens": {}, "start": {}}
    ref = {}
    for name, (_, big, batch, slots, steps, (pb, ps)) in \
            D.DECODE_SCENARIOS.items():
        cfg = D.arch(name).model
        jcfg = JModelCfg(**_cfg_fields(cfg), dtype=jax.numpy.float32)
        params = jax.tree.map(np.asarray,
                              j_build(jcfg).init(jax.random.PRNGKey(0)))
        pre = rng.integers(0, cfg.vocab, (pb, ps), dtype=np.int32)
        start = rng.integers(0, cfg.vocab, (batch, 1), dtype=np.int32)
        ranks["params"][name] = params
        ranks["prefill_tokens"][name] = pre
        ranks["start"][name] = start
        ref[name] = {"cfg": _cfg_fields(cfg), "big": big, "params": params,
                     "prefill": pre, "start": start, "slots": slots,
                     "steps": steps}
    return ranks, ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_decode")
    ranks_in, ref_in = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(ranks_in, f)
    with open(out / "ref_in.pkl", "wb") as f:
        pickle.dump(ref_in, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_decode_grid_reference.py"),
         str(out / "ref_in.pkl"), str(out / "ref_out.pkl")], env=env)
    try:
        mp.spawn(D.main, args=(WORLD, str(out / "store"), str(out)),
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


@pytest.mark.parametrize("name", NAMES)
def test_grid_decode_gives_the_reference_greedy_tokens(run, name):
    ranks, want = run
    for rk in ranks:
        got = np.stack(rk[name]["tokens"])
        np.testing.assert_array_equal(got, np.stack(want[name]["tokens"]))


@pytest.mark.parametrize("name", NAMES)
def test_grid_decode_logits_match_the_reference_every_step(run, name):
    ranks, want = run
    for rk in ranks:
        for t, (got, ref) in enumerate(zip(rk[name]["logits"],
                                           want[name]["logits"])):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t}")


@pytest.mark.parametrize("name", NAMES)
def test_grid_prefill_matches_the_reference_last_token_logits(run, name):
    ranks, want = run
    for rk in ranks:
        assert rk[name]["prefill"].shape == want[name]["prefill"].shape
        np.testing.assert_allclose(rk[name]["prefill"], want[name]["prefill"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same_logits(run, name):
    ranks, _ = run
    first = ranks[0][name]
    for rk in ranks[1:]:
        np.testing.assert_array_equal(rk[name]["prefill"], first["prefill"])
        for a, b in zip(rk[name]["logits"], first["logits"]):
            np.testing.assert_array_equal(a, b)


def _cache_spec(name):
    a = D.arch(name)
    _, dec = D.shapes(name)
    plan = SH.make_plan(a, dec, _Grid())
    meta = build_model(a.model).init_cache(dec.global_batch, dec.seq_len,
                                           device="meta")
    return SH.cache_specs(meta, plan, batch=dec.global_batch,
                          seq_lens=(dec.seq_len, 2048)), meta


class _Grid:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


def _rank_slice(name, coords, full, key):
    """This rank's index into the whole cache leaf ``full`` under
    ``cache_specs``."""
    specs, _ = _cache_spec(name)
    grid = _Grid()
    idx = [slice(None)] * full.ndim
    for dim, axes in SH.spec_dims(specs[key]):
        n, i = 1, 0
        for ax in axes:
            n, i = n * grid.shape[ax], i * grid.shape[ax] + coords[ax]
        per = full.shape[dim] // n
        idx[dim] = slice(i * per, (i + 1) * per)
    return tuple(idx)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_cache_is_the_cache_specs_slice(run, name):
    ranks, want = run
    specs, meta = _cache_spec(name)
    grid = _Grid()
    batch = D.DECODE_SCENARIOS[name][2]
    for rk in ranks:
        for key in ("k", "v"):
            full = want[name]["cache"][key]
            spec = specs[key]
            assert rk[name]["cache"][key].shape == SH.shard_shape(
                tuple(meta[key].shape), spec, grid)
            # the batch over `data` where it splits, the slots over
            # `model` (over both axes at batch 1)
            dims = {d for d, _ in SH.spec_dims(spec)}
            assert dims == ({1, 2} if batch > 1 else {2})
            np.testing.assert_allclose(
                rk[name]["cache"][key],
                full[_rank_slice(name, rk[name]["coords"], full, key)],
                rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_collective_bytes_equal_the_dry_run_serving_cells(run, name):
    """Each rank's bytes by kind and use, for the prefill and for every
    decode step, equal ``dryrun.analyze_serving`` of the same cell for
    that rank of a fake 2 x 2 group."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_replica_grid
    ranks, _ = run
    a = D.arch(name)
    pre, dec = D.shapes(name)
    for r, rk in enumerate(ranks):
        dryrun.fake_group(WORLD, r)
        try:
            grid = make_replica_grid(D.GRID, ("data", "model"),
                                     device_type="cpu")
            step, ex, _ = dryrun.build_prefill_cell(a, pre, grid)
            p_res = dryrun.analyze_serving(step, ex, grid, name)
            step, ex, _ = dryrun.build_decode_cell(a, dec, grid)
            d_res = dryrun.analyze_serving(step, ex, grid, name)
        finally:
            dist.destroy_process_group()
        assert rk[name]["prefill_by_use"] == p_res["collectives_by_use"]
        for t, got in enumerate(rk[name]["by_use"]):
            assert got == d_res["collectives_by_use"], f"rank {r} step {t}"


@pytest.mark.parametrize("name", NAMES)
def test_collectives_by_use_follow_the_layout(run, name):
    """The softmax statistics and V products are gathered over the cache's
    sequence axes, the logits over the batch rows' axes; the replica's
    weights a layer and the table once a call; the expert-parallel MoE
    swaps its dispatch at decode and gathers no whole expert stack."""
    ranks, _ = run
    model, big, batch, slots, _, _ = D.DECODE_SCENARIOS[name]
    cfg = D.arch(name).model
    got = ranks[0][name]["by_use"][0]
    assert got["all_gather:decode_softmax"] > 0
    assert got["all_gather:decode_attn"] > 0
    assert ("all_gather:logits" in got) == (batch > 1)
    if batch > 1:
        assert got["all_gather:logits"] == 4 * batch * cfg.vocab
    assert got["all_gather:weight"] > 0
    ep = cfg.moe_experts > 0 and cfg.moe_ep
    assert ("all_to_all:moe_dispatch" in got) == ep
    pre = ranks[0][name]["prefill_by_use"]
    assert pre["all_gather:prefill_last"] > 0 and pre["all_gather:kv"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_shapes_that_do_not_split_and_positions_past_the_cache_raise(run,
                                                                      name):
    ranks, _ = run
    for rk in ranks:
        errs = rk[name]["errors"]
        assert "outside the cache's" in errs["past_cache"]
        assert "cache slice of" in errs["cache_shape"]
        assert "does not split" in errs["prefill_seq"]
        if "prefill_batch" in errs:
            assert "does not split" in errs["prefill_batch"]


def test_the_grid_decode_crosses_every_sequence_shard(run):
    """The positions written reach every sequence rank's slots: each
    rank's cache has written (nonzero) slots."""
    ranks, _ = run
    for name in NAMES:
        for rk in ranks:
            k = rk[name]["cache"]["k"]
            written = np.abs(k).reshape(k.shape[0], k.shape[1], k.shape[2],
                                        -1).sum(axis=(0, 1, 3)) > 0
            assert written.any(), (name, rk[name]["coords"])


@pytest.mark.parametrize("name", D.BF16_SCENARIOS)
def test_bf16_grid_decode_is_the_one_process_decode(run, name):
    ranks, _ = run
    for rk in ranks:
        grid, one = rk["bf16"][name]["grid"], rk["bf16"][name]["one"]
        assert len(grid["logits"]) == len(one["logits"]) > 0
        for t, (got, want) in enumerate(zip(grid["logits"], one["logits"])):
            np.testing.assert_array_equal(got, want, err_msg=f"step {t}")
            np.testing.assert_array_equal(grid["tokens"][t],
                                          one["tokens"][t + 1])
        for key in ("k", "v"):
            full = one["cache"][key]
            np.testing.assert_array_equal(
                grid["cache"][key],
                full[_rank_slice(name, grid["coords"], full, key)])


@pytest.mark.parametrize("name", D.BF16_SCENARIOS)
def test_bf16_grid_prefill_is_the_one_process_prefill(run, name):
    ranks, _ = run
    for rk in ranks:
        np.testing.assert_array_equal(rk["bf16"][name]["grid"]["prefill"],
                                      rk["bf16"][name]["one"]["prefill"])


@pytest.mark.parametrize("arch_id", list_archs())
def test_bundle_serving_flags_equal_the_reference(arch_id):
    """``subquadratic`` (which arch runs long_500k) and
    ``decode_supported``, per family as the reference sets them."""
    got = build_model(get_arch(arch_id).model)
    want = j_build(j_arch(arch_id).model)
    assert (got.subquadratic, got.decode_supported) == \
        (want.subquadratic, want.decode_supported)
    # every family serves its prefill cell (the enc-dec's the memory's
    # last frame, ``test_torch_sharded_serving.py``)
    assert got.prefill is not None
