"""The port's dry run (``launch/dryrun.py``): the sharded round step of a
production-mesh cell traced as rank 0 of a fake process group of 256 ranks.

  * qwen2_0_5b/train_4k on 16 x 16: the per-rank parameter bytes are the
    sum over leaves of their bytes over their shard factor under the spec
    rules, and the collective bytes by kind equal the closed form below,
    term by term.
  * qwen2_5_32b/train_4k on 16 x 16 (all 64 layers) completes and reports
    its bytes, FLOPs and H100 roofline terms.
  * granite_moe_1b_a400m, internvl2_1b and llama4_scout_17b_a16e (2 of
    its 48 layers; the full depth is the CLI's, ~2 min) train_4k on 16 x
    16: the per-rank parameter bytes in closed form (llama4's expert
    tensors cut along E and d_ff), each peak under the H100's 80 GB, and
    llama4's expert-parallel dispatch: the all-to-all of each (B_loc, E,
    C, D) bf16 buffer, both ways, three times a layer a group.
  * Every family's serving cells print a record (the xLSTM, hybrid and
    enc-dec families' since their cache layouts were ported); a cohort the
    grid does not run yet says "not ported" and prints no result.
  * The serving cells (since the prefill and decode cells were ported):
    qwen2_0_5b and llama4_scout_17b_a16e prefill_32k and decode_32k print
    a record (qwen2's decode collectives in closed form), long_500k runs
    for h2o_danube_3_4b and is skipped with the reference's reason for
    every full-attention arch.
  * The reference's launch flags (``--agg-backend``, ``--encode-backend``,
    ``--cohort``, ``--adversary``) reach ``build_train_cell``; at the
    reduced dense model on a fake 2 x 2 group the stateful pipelines'
    range state is in the arguments and the peak in closed form, and the
    new collectives (the whole-vector statistics' partial sums, EF's
    payload all-gather) are in the count.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_sharded_ranks as R
from repro_torch.configs.common import SHAPES, ShapeCfg, get_arch
from repro_torch.core.tree import tree_paths
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.models.api import family_module

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_group():
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    yield
    assert not dist.is_initialized()


def _shards(arch, mesh_shape, plan):
    class M:
        axis_names = ("data", "model")
        shape = dict(zip(axis_names, mesh_shape))
    full = family_module(arch.model).param_shapes(arch.model)
    specs = dict(tree_paths(SH.param_specs(
        full, M(), plan, moe_experts=arch.model.moe_experts)))
    out = {}
    for path, shape in tree_paths(full):
        n = 1
        for _, axes in SH.spec_dims(specs[path]):
            for a in axes:
                n *= M.shape[a]
        out[path] = (int(np.prod(shape)), n)
    return out


def test_qwen2_train_4k_bytes_and_collectives_closed_form():
    arch = get_arch("qwen2_0_5b")
    m = arch.model
    res = dryrun.run_cell("qwen2_0_5b", "train_4k", multi_pod=False)
    plan = SH.make_plan(arch, SHAPES["train_4k"], type(
        "M", (), {"axis_names": ("data", "model"),
                  "shape": {"data": 16, "model": 16}})())
    assert plan.replica_axes == ("model",) and plan.micro == 16
    R_, bpe = 16, 2
    shards = _shards(arch, (16, 16), plan)
    param_bytes = sum(n * bpe // k for n, k in shards.values())
    assert res["argument_bytes"]["params"] == param_bytes

    L, D, H, K = m.n_layers, m.d_model, m.n_heads, m.n_kv_heads
    hd, F, V = m.d_head, m.d_ff, m.vocab
    B, S = plan.micro, SHAPES["train_4k"].seq_len
    # a layer's sharded weights (wq, wk, wv, wo, w1, w2, w3) and its
    # replicated ones (bq, bk, bv, ln1, ln2), elements
    w_layer = D * H * hd * 2 + D * K * hd * 2 + 3 * D * F
    r_layer = H * hd + 2 * K * hd + 2 * D
    kv = 2 * B * S * K * hd * bpe                  # gathered K and V
    gathers = 1 if m.remat_save_weights else 2     # fwd (+ remat's)
    d = sum(n for n, _ in shards.values())
    n_tiles = -(-d // 8192)
    range0 = -(-n_tiles // R_) * 8192              # rank 0's range
    shard_elems = sum(n // k for n, k in shards.values())
    want = {
        # embed (V x D) once, each layer's weights, each layer's K/V, the
        # range's sign bytes of the 16 clients
        "all_gather": V * D * bpe + L * gathers * w_layer * bpe + L * kv
        + 16 * range0 // 8,
        # the gradients' shards, and the K/V gradients' sequence slices
        "reduce_scatter": (V * D + L * w_layer) * bpe // R_
        + L * kv // R_,
        # the pseudo-gradient into the range, the update back, f32
        "all_to_all": 4 * range0 + 4 * shard_elems,
        # replicated leaves' gradients (layers and lnf), the loss's token
        # sum and count, the loss over the 16 clients, the update norm
        "all_reduce": (L * r_layer + D) * bpe + 8 + 4 + 4,
    }
    assert res["collectives"] == want
    assert res["collective_bytes_per_device"] == sum(want.values())
    assert res["flops_per_device"] > 0 and res["peak_bytes"] > param_bytes
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
              "roofline_fraction", "output_size_in_bytes"):
        assert k in res
    print(json.dumps(res))


def test_qwen25_32b_train_4k_completes():
    res = dryrun.run_cell("qwen2_5_32b", "train_4k", multi_pod=False)
    print(json.dumps(res))
    arch = get_arch("qwen2_5_32b")
    plan = SH.make_plan(arch, SHAPES["train_4k"], type(
        "M", (), {"axis_names": ("data", "model"),
                  "shape": {"data": 16, "model": 16}})())
    assert res["plan"]["replica_axes"] == ["data", "model"] or \
        tuple(res["plan"]["replica_axes"]) == ("data", "model")
    shards = _shards(arch, (16, 16), plan)
    assert res["argument_bytes"]["params"] == sum(
        n * 2 // k for n, k in shards.values())
    assert res["chip"] == "H100 SXM 80GB"
    assert res["dominant"] in ("compute", "memory", "collective")
    assert all(res["collectives"][k] > 0 for k in
               ("all_gather", "reduce_scatter", "all_to_all"))


@pytest.mark.parametrize("arch_id,layers", [
    ("granite_moe_1b_a400m", None), ("internvl2_1b", None),
    ("llama4_scout_17b_a16e", 2)])
def test_moe_vlm_train_4k_shard_bytes_closed_form(arch_id, layers,
                                                  monkeypatch):
    arch = get_arch(arch_id)
    if layers is not None:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=layers))
        monkeypatch.setattr(dryrun, "get_arch", lambda _: arch)
    res = dryrun.run_cell(arch_id, "train_4k", multi_pod=False)
    print(json.dumps(res))
    m = arch.model
    plan = SH.make_plan(arch, SHAPES["train_4k"], type(
        "M", (), {"axis_names": ("data", "model"),
                  "shape": {"data": 16, "model": 16}})())
    shards = _shards(arch, (16, 16), plan)
    # bf16 leaves, the f32 MoE router (replicated)
    assert res["argument_bytes"]["params"] == sum(
        n * (4 if path[-1] == "router" else 2) // k
        for path, (n, k) in shards.items())
    assert res["fits_hbm"] and res["peak_bytes"] < 80e9
    by_use = res["collectives_by_use"]
    if m.moe_ep:
        # llama4: E over model, d_ff over data: 256 shards of each expert
        # tensor; the dispatch buffer (B_loc, E, C, D) in bf16
        assert shards[("moe", "w1")][1] == 256
        B_loc, S_loc = plan.micro // 16, SHAPES["train_4k"].seq_len // 16
        C = max(1, int(S_loc * m.moe_topk / m.moe_experts * 1.25))
        swap = B_loc * m.moe_experts * C * m.d_model * 2
        for use in ("moe_dispatch", "moe_combine"):
            assert by_use[f"all_to_all:{use}"] == \
                3 * m.n_layers * plan.client_groups * swap
        assert res["collectives"]["all_to_all"] > 0
    elif m.moe_experts:
        # granite: E = 32 over model, gathered a layer (forward + remat)
        assert shards[("moe", "w1")][1] == 16
        assert not any(k.startswith("all_to_all:moe") for k in by_use)
    else:
        # internvl2: the vocab (151,655) leaves the table replicated
        assert shards[("embed",)][1] == 1
        assert res["argument_bytes"]["batch"] > 0


@pytest.mark.parametrize("arch_id,shape", [
    ("jamba_1_5_large_398b", "decode_32k"), ("xlstm_350m", "prefill_32k"),
    ("seamless_m4t_large_v2", "decode_32k"),
    ("jamba_1_5_large_398b", "long_500k"), ("xlstm_350m", "long_500k")])
def test_cells_not_ported_say_so(arch_id, shape, capsys):
    """Five of the serving cells that waited for the recurrent, hybrid and
    enc-dec families' serving layouts (ROADMAP item 19 step 3) print a
    record: no ``not_ported``, a peak under 80 GB on 16 x 16, the uses
    their layouts call for (the mamba step's activations gathered over its
    state's channels, the sLSTM's state, the enc-dec's memory fold). The
    decode cells at full depth through the CLI; xlstm's prefill_32k at one
    of its six groups and seq 256 (its sLSTM loops over the sequence, on
    meta tensors too; the full record is the CLI's and PERF.md's)."""
    from test_torch_sharded_serving import check_family_serving_record, \
        serving_record
    if shape == "prefill_32k":
        line = serving_record(arch_id, shape, layers=4, seq=256)
    else:
        dryrun.main(["--arch", arch_id, "--shape", shape])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    check_family_serving_record(line, arch_id, shape)


# ---------------------------------------------------------------------------
# the serving cells: prefill_32k, decode_32k and long_500k
# ---------------------------------------------------------------------------

_SERVE_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "peak_bytes", "flops_per_device", "collectives",
               "collectives_by_use", "t_compute_s", "t_memory_s",
               "t_collective_s", "dominant", "fits_hbm")


@pytest.mark.parametrize("arch_id,shape", [
    ("qwen2_0_5b", "prefill_32k"), ("qwen2_0_5b", "decode_32k"),
    ("llama4_scout_17b_a16e", "prefill_32k"),
    ("llama4_scout_17b_a16e", "decode_32k")])
def test_serving_cells_print_a_record(arch_id, shape, capsys):
    """Each serving cell prints the train cell's fields: bytes, peak
    (under the H100's 80 GB), FLOPs, collectives by use, roofline terms;
    the logits of every row of the batch on every rank. llama4's decode
    swaps its dispatch to the experts' ranks (E over `model`) and gathers
    one expert's d_ff a rank, never the layer's 16."""
    dryrun.main(["--arch", arch_id, "--shape", shape])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "error" not in line and "not_ported" not in line, line
    assert all(k in line for k in _SERVE_KEYS)
    assert line["fits_hbm"] and line["peak_bytes"] > 0
    sh = SHAPES[shape]
    arch = get_arch(arch_id)
    assert line["logits_shape"] == [sh.global_batch, 1, arch.model.vocab]
    uses = line["collectives_by_use"]
    assert uses["all_gather:logits"] == 4 * sh.global_batch * \
        arch.model.vocab
    if shape == "prefill_32k":
        assert uses["all_gather:prefill_last"] > 0 and uses["all_gather:kv"]
    else:
        assert uses["all_gather:decode_softmax"] > 0
        assert uses["all_gather:decode_attn"] > 0
        assert line["argument_bytes"]["cache"] > 0
    m = arch.model
    if m.moe_ep:
        assert uses["all_to_all:moe_dispatch"] == \
            uses["all_to_all:moe_combine"] > 0
        expert = 3 * m.d_model * m.d_ff * 2
        # each layer's gathered bytes hold one expert (E/16 = 1) whole
        assert uses["all_gather:weight"] < m.n_layers * 2 * expert + \
            2 * m.vocab * m.d_model * 2 + m.n_layers * 2 * 4 * \
            m.d_model * m.d_model


def test_qwen2_decode_32k_collectives_closed_form(capsys):
    """qwen2-0.5B's decode step on 16 x 16: every sharded leaf gathered
    once (the layer stack a layer, the tied table once), the softmax's row
    max and sum of this rank's 8 rows (14 heads x 2 f32) and their
    probability-weighted V (14 heads x 64 f32) from the 16 sequence ranks
    a layer, the (128, 1, 151936) f32 logits; the cache slice (24, 8,
    2048, 2, 64) bf16, K and V."""
    dryrun.main(["--arch", "qwen2_0_5b", "--shape", "decode_32k"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    arch = get_arch("qwen2_0_5b")
    m = arch.model
    plan = SH.make_plan(arch, SHAPES["decode_32k"], type(
        "M", (), {"axis_names": ("data", "model"),
                  "shape": {"data": 16, "model": 16}})())
    shards = _shards(arch, (16, 16), plan)
    gathered = sum(n for n, f in shards.values() if f > 1) * 2
    hd = m.d_model // m.n_heads
    assert line["collectives_by_use"] == {
        "all_gather:weight": gathered,
        "all_gather:decode_softmax": m.n_layers * 16 * 8 * m.n_heads
        * 2 * 4,
        "all_gather:decode_attn": m.n_layers * 16 * 8 * m.n_heads * hd * 4,
        "all_gather:logits": 128 * m.vocab * 4}
    assert line["argument_bytes"]["cache"] == \
        2 * m.n_layers * 8 * 2048 * m.n_kv_heads * hd * 2


def test_long_500k_runs_for_h2o_danube(capsys):
    """h2o-danube-3-4b has a sliding window (4096), so the reference runs
    its long_500k: batch 1, the 524,288-slot cache over all 256 ranks
    (2,048 slots a rank), the softmax statistics and V products gathered
    over all of them, no batch gather."""
    dryrun.main(["--arch", "h2o_danube_3_4b", "--shape", "long_500k"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "error" not in line and "skipped" not in line, line
    m = get_arch("h2o_danube_3_4b").model
    hd = m.d_model // m.n_heads
    assert line["argument_bytes"]["cache"] == \
        2 * m.n_layers * 1 * 2048 * m.n_kv_heads * hd * 2
    uses = line["collectives_by_use"]
    assert "all_gather:logits" not in uses
    assert uses["all_gather:decode_softmax"] == \
        m.n_layers * 256 * m.n_heads * 2 * 4
    assert uses["all_gather:decode_attn"] == \
        m.n_layers * 256 * m.n_heads * hd * 4
    assert line["logits_shape"] == [1, 1, m.vocab] and line["fits_hbm"]


@pytest.mark.parametrize("arch_id", [
    "qwen2_0_5b", "granite_3_8b", "qwen2_5_32b", "granite_moe_1b_a400m",
    "llama4_scout_17b_a16e", "internvl2_1b", "seamless_m4t_large_v2"])
def test_long_500k_skipped_with_the_reference_reason(arch_id, capsys):
    """A full-attention arch skips long_500k before any family check, with
    the reference's record (``src/repro/launch/dryrun.py``'s
    ``run_cell``)."""
    dryrun.main(["--arch", arch_id, "--shape", "long_500k"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"label": f"{arch_id}/long_500k", "skipped":
                    "full-attention arch: no sub-quadratic path "
                    "(DESIGN.md)"}


def test_not_ported_has_no_serving_entries():
    assert set(dryrun.NOT_PORTED) == {"pipeline"}


# ---------------------------------------------------------------------------
# the launch flags, the range state and its collectives, at the reduced
# dense model on a fake 2 x 2 group
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _small_cell(spec, big=False, cohort="auto"):
    """``analyze`` of the reduced dense model's train cell (seq 32, global
    batch 4) for rank 0 of a fake 2 x 2 group, with ``spec`` and the
    cohort policy ``cohort``."""
    from repro_torch.launch.mesh import make_replica_grid
    dryrun.fake_group(4, 0)
    try:
        grid = make_replica_grid((2, 2), ("data", "model"),
                                 device_type="cpu")
        step, ex, plan = dryrun.build_train_cell(
            R.arch(big), ShapeCfg("test", "train", R.SEQ, 4), grid,
            pipeline=spec, agg_backend="cuda", encode_backend="cuda",
            cohort=cohort)
        res = dryrun.analyze(step, ex, grid, spec)
        # the step's layout, built by the traced round
        layout = ex["layout"](None)
    finally:
        dist.destroy_process_group()
    lo, hi = layout.bounds
    return res, plan, hi - lo, layout.spec.n_coords


@pytest.mark.parametrize("flag,value,key", [
    ("--agg-backend", "torch", "agg_backend"),
    ("--encode-backend", "torch", "encode_backend"),
    ("--cohort", "vmap", "cohort"),
    ("--adversary", "dropout(f=1)", "adversary")])
def test_launch_flags_reach_build_train_cell(flag, value, key, monkeypatch,
                                             capsys):
    """Each of the reference's four launch flags reaches
    ``build_train_cell``; ``auto`` backends take the kernels' route."""
    seen = {}

    def build(*a, **kw):
        seen.update(kw)
        raise dryrun.NotPorted("stop here")
    monkeypatch.setattr(dryrun, "build_train_cell", build)
    dryrun.main(["--arch", "qwen2_0_5b", "--shape", "train_4k", flag, value])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["not_ported"] == "stop here"
    want = {"agg_backend": "cuda", "encode_backend": "cuda",
            "cohort": "auto", "adversary": "none", key: value}
    assert {k: seen[k] for k in want} == want


@pytest.mark.parametrize("spec", ["ef|zsign", "cv|zsign_packed"])
@pytest.mark.parametrize("big", [False, True], ids=["regular", "big"])
def test_range_state_bytes_closed_form(spec, big):
    """The rank's state is its range: (G, 1, hi - lo) f32 client rows and
    (hi - lo,) server rows, in the arguments and in the peak (the same
    cell with a stateless codec peaks that much lower), beside the
    reference layout's (G, 1, d) and (d,)."""
    res, plan, L, d = _small_cell(spec, big)
    base = _small_cell("zsign", big)[0]
    G = plan.client_groups
    rows = G + (1 if spec.startswith("cv") else 0)
    assert res["state_bytes"] == {"range": 4 * rows * L,
                                  "replicated_coords": 4 * rows * d}
    # the key (2 int64) and sigma (f32) beside the slots; SGD keeps none
    assert res["argument_bytes"]["state"] == 4 * rows * L + 20
    assert res["peak_bytes"] == base["peak_bytes"] + 4 * rows * L


@pytest.mark.parametrize("spec,new", [
    ("ef|zsign", {"all_reduce:abs_sum": 4}),
    ("ef|zsign(use_kernel=true)", {"all_reduce:abs_sum": 4}),
    ("stosign", {"all_reduce:row_norm": 4}),
    ("dp(clip=1.0,eps=2.0)|zsign_packed", {"all_reduce:row_norm": 4}),
    ("cv|zsign_packed", {}),
    ("sigma_sched(head=1.0,tail=0.25)|zsign(z=1,sigma=0.01)", {})])
@pytest.mark.parametrize("big", [False, True], ids=["regular", "big"])
def test_new_collectives_in_the_count(spec, new, big):
    """Against the stateless codec's cell: one 4-byte partial sum over the
    replica a group for each whole-vector statistic; with clients side by
    side, the sign wire's payload rows all-gathered over the client axis
    (no f32 client sum), and on the EF wire its scales beside them."""
    res, plan, L, _ = _small_cell(spec, big)
    base = _small_cell("zsign", big)[0]
    G, N = plan.client_groups, plan.n_clients
    assert "all_reduce:client_sum" not in base["collectives_by_use"]
    if N > 1:
        assert base["collectives_by_use"]["all_gather:wire_bytes"] == \
            N * G * L // 8
    want = dict(base["collectives_by_use"])
    want.update({k: v * G for k, v in new.items()})
    if spec.startswith("ef|") and N > 1:
        want["all_gather:wire_scale"] = 4 * N * G
    assert res["collectives_by_use"] == want
    totals = {k: sum(v for u, v in want.items() if u.startswith(k + ":"))
              for k in res["collectives"]}
    assert res["collectives"] == totals


@pytest.mark.parametrize("spec", ["zsign", "ef|zsign(use_kernel=true)"])
def test_forced_stream_on_the_big_plan_prints_a_record(spec):
    """A cohort that streams the big plan's sequential groups runs the
    grid's stream plan (its full qwen2.5-32b ``train_4k`` record is
    ``test_torch_sharded_stream.py``'s): at the reduced dense model its 2
    groups in one shard of 2 (R1's fold mode on the EF wire) run the group
    round's collectives, byte for byte, from the same arguments."""
    res, plan, _, _ = _small_cell(spec, True, "stream(shard=2)")
    base = _small_cell(spec, True)[0]
    assert plan.client_groups == 2 and not plan.client_axes
    assert "not_ported" not in res and res["flops_per_device"] > 0
    assert res["collectives_by_use"] == base["collectives_by_use"]
    assert res["argument_bytes"] == base["argument_bytes"]


@pytest.mark.parametrize("args", [
    ["--adversary", "sign_flip(f=1)"],
    ["--adversary", "byte_corrupt(f=1,p=0.1)",
     "--pipeline", "zsign(z=1,sigma=0.01,agg=median)"],
    ["--pipeline", "zsign(z=1,sigma=0.01,agg=vote)"]],
    ids=["sign_flip", "byte_corrupt-median", "vote"])
def test_adversary_and_robust_laws_print_a_train_record(args, capsys):
    """The wire adversary and the robust laws run on the grid: the CLI
    prints qwen2-0.5B's ``train_4k`` record, with the payload rows
    all-gathered over the client axis (the sign wire's route, the vote
    pair's too) and no f32 client sum."""
    dryrun.main(["--arch", "qwen2_0_5b", "--shape", "train_4k"] + args)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["label"] == "qwen2_0_5b/train_4k/16x16"
    assert "error" not in line and "not_ported" not in line
    assert line["flops_per_device"] > 0 and line["fits_hbm"]
    by_use = line["collectives_by_use"]
    assert "all_gather:wire_bytes" in by_use
    assert "all_reduce:client_sum" not in by_use


@pytest.mark.parametrize("spec,new,gone", [
    ("zsign(z=1,sigma=0.01,agg=vote)", {}, ()),
    ("zsign(z=1,sigma=0.01,agg=median)", {}, ()),
    ("zsign_packed(z=2,sigma=0.01)", {}, ()),
    ("qsgd(s=1)", {"all_reduce:row_norm": 4, "all_reduce:client_sum": "4GL"},
     ("all_gather:wire_bytes",)),
    ("dp(clip=1.0,noise=0.1)|dense", {"all_reduce:row_norm": 4,
                                      "all_reduce:client_sum": "4GL"},
     ("all_gather:wire_bytes",)),
    ("topk(frac=0.25)", {"all_reduce:topk_hist": 8192,
                         "all_gather:topk_ties": 16,
                         "all_gather:topk_counts": "8N",
                         "all_gather:wire_values": "kv",
                         "all_gather:wire_indices": "kv"},
     ("all_gather:wire_bytes",))])
def test_new_specs_collectives_in_the_count(spec, new, gone):
    """At the reduced dense model on a fake 2 x 2 group (2 clients side by
    side, a replica of 2 ranks), against the zsign cell: the robust laws
    and z = 2 all-gather the range's bytes as zsign does; QSGD's norm and
    dpgauss's clip add a 4-byte partial sum, and their f32 wire folds
    over the client axis (an (L,) f32 running sum a group) in place of the
    bytes' all-gather; top-k adds its four 256-bin int64 counts, the
    ties' prefix (an int64 a replica rank), the clients' counts and their
    values and indices (the dry run's even share of k a range) in place
    of the bytes."""
    res, plan, L, d = _small_cell(spec)
    base = _small_cell("zsign")[0]
    N, G = plan.n_clients, plan.client_groups
    share = -(-max(1, int(d * 0.25)) * L // d)
    sizes = {"4GL": 4 * G * L, "8N": 8 * N * G,
             "kv": 4 * N * G * share}
    want = dict(base["collectives_by_use"])
    for k in gone:
        del want[k]
    want.update({k: sizes.get(v, v) if isinstance(v, str) else v * G
                 for k, v in new.items()})
    assert res["collectives_by_use"] == want
