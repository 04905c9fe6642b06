"""Dry run of the model-sharded cells (port of ``repro.launch.dryrun``):
one round of the sharded round step of a train cell, or one call of the
serving prefill or decode step, of an (arch x shape x production mesh)
cell, traced as one rank of a FAKE process group of the mesh's size, with
the per-rank bytes, FLOPs and collective bytes it would take, and the
analytic roofline terms of the H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_32b \
        --shape train_4k [--multi-pod | --both-meshes] [--pipeline SPEC] \
        [--agg-backend B] [--encode-backend B] [--cohort POLICY] \
        [--adversary SPEC] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_32b \
        --shape decode_32k            # or prefill_32k, long_500k

The reference lowers and compiles the jitted step on 512 placeholder TPU
devices and reads the compiled artifact. The port's counterpart builds the
same step (``build_train_cell``: ``core/fedavg.build_sharded_round_step``
on a ``launch/mesh.make_production_mesh`` grid; ``build_prefill_cell`` and
``build_decode_cell``: the family's ``prefill`` and ``decode_step`` under
``launch/hints.serving_hints``, the decode's KV cache cut by
``sharding.cache_specs``) and runs it once in a ``fake`` process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg.
FakeStore``): every tensor has a shape and no storage (``meta`` tensors),
every collective returns at once, and what the step does is counted, not
computed. ``analyze`` (train) and ``analyze_serving`` (prefill, decode)
report for this rank:

  * bytes of the arguments (param shards; the server state with this
    rank's range of each pipeline state slot, batch and mask; or the
    tokens and the cache slice), of the outputs, and the peak of
    everything live (``MemTracker``), the reference's ``memory_analysis``
    fields; a train cell's state slots' bytes in the range layout and in
    the reference's replicated-coordinate one (``state_bytes``);
  * FLOPs (``FlopCounterMode``);
  * collective bytes by kind (``launch/hints.collective_totals``: the bytes
    of each collective's result, as the reference sums the HLO's), and by
    kind and use (weight and K/V gathers, the MoE dispatch's all-to-alls,
    the wire's re-layout, the decode's softmax statistics, V products and
    logits, ...).

``run_cell`` adds ``launch/roofline.terms_for`` with the H100 ``Chip`` (the
reference's v5e constants are not ported) and the peak against one H100's
80 GB (``HBM_BYTES``). It skips ``long_500k`` on an arch whose bundle is
not ``subquadratic`` with the reference's record. The trace takes the
card's route through the wire (the ``auto`` backends): E1, R1, F1 and C1
stand in by their kernels' outputs (they count and do not compute), the
dense noise draw by its output, and top-k's selection by its collectives
and the range's even share of k; on a card ``chip_smoke.py`` runs this
same ``build_train_cell`` step for real on a 2 x 2 grid, and the serving
cells at its own shapes. Every cell of every family runs: the MoE experts
gathered a layer or, under ``moe_ep``, expert-parallel with the
dispatch's all-to-alls counted, at decode too, with every pipeline spec
(``--pipeline``) and the reference's ``--agg-backend``,
``--encode-backend``, ``--cohort`` and ``--adversary``; the xLSTM's train
cell gathers the mLSTM's K, V and gates and the sLSTM's input along the
sequence (``all_gather:kv``, ``:gates``, ``:slstm_in``), the hybrid's each
mamba sublayer's input (``all_gather:mamba_in``) with its ``x_proj``
partial all-reduced (``all_reduce:mamba_xproj``) and its output
reduce-scattered (``reduce_scatter:mamba_out``), the enc-dec's the
encoder's memory once (``all_gather:enc_mem``, its gradient
``reduce_scatter:enc_mem``). Their serving cells: the sLSTM's state, cut
over `model` on its D, gathered a step (``all_gather:slstm_state``); a
mamba step's activations gathered over its state's d_inner channels
(``all_gather:mamba_act``, ``:mamba_y``); the enc-dec's cross-attention
over its memory slots with the softmax folded over them
(``all_gather:mem_softmax``, ``:mem_attn``), its prefill cell's memory
frame gathered over the rows (``all_gather:mem_last``). A cohort that
streams the big plan's sequential groups (``--cohort "stream(shard=K)"``)
runs the grid's stream plan. The scans of the recurrent blocks are Python
loops over the sequence, on meta tensors too: a full train_4k record of
xlstm_350m or jamba_1_5_large_398b, and their prefill_32k records, take
tens of minutes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.common import SHAPES, ShapeCfg, get_arch, list_archs
from repro_torch.core import compression, fedavg, wire
from repro_torch.core import noise as znoise
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import hints
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import ENCDEC_SRC_LEN, BatchLeaf, build_model, \
    family_module

#: what a cell waits for (the CLI prints it, never a result): a round
#: mode the grid's train cell does not run
NOT_PORTED = {"pipeline": "{msg}"}
#: the reference's reason for skipping long_500k on an arch that is not
#: sub-quadratic (``src/repro/launch/dryrun.py``'s ``run_cell``)
LONG_SKIP = "full-attention arch: no sub-quadratic path (DESIGN.md)"


#: one H100's device memory, the gate each rank's peak is reported against
HBM_BYTES = 80e9


class NotPorted(NotImplementedError):
    """A cell whose machinery the port does not have yet."""


def build_train_cell(arch, shape: ShapeCfg, grid, *,
                     pipeline: Optional[str] = None, remat: bool = True,
                     agg_backend: str = "auto",
                     encode_backend: str = "auto", cohort: str = "auto",
                     adversary: str = "none"):
    """The sharded round step of a train cell -> (step, example, plan).

    ``step(state, batch, mask)`` is ``fedavg.build_sharded_round_step`` for
    the arch's loss on ``grid`` under ``sharding.make_plan``'s plan, with
    the arch's default codec ``zsign(z=..,sigma=..)`` or ``pipeline``, and
    the reference's backend selectors, cohort policy and wire adversary
    (a round mode that the grid does not run yet raises ``NotPorted``).
    ``example`` holds the shapes of its arguments: ``params`` (this rank's
    shards, a tree of ``BatchLeaf``), ``specs``, ``batch`` ((G, N, E,
    micro, S) leaves) and ``mask`` ((G, N)), and the step's ``layout``
    (its range state's); ``make_inputs`` builds them."""
    if shape.kind != "train":
        raise ValueError(f"build_train_cell takes a train shape, not "
                         f"{shape.kind} ({shape.name}): build_"
                         f"{shape.kind}_cell")
    bundle = build_model(arch.model)
    plan = SH.make_plan(arch, shape, grid)
    comp = compression.Pipeline(
        pipeline if pipeline else
        f"zsign(z={arch.zsign_z},sigma={arch.zsign_sigma})")
    fcfg = fedavg.FedConfig(n_clients=plan.n_clients,
                            client_groups=plan.client_groups,
                            local_steps=plan.local_steps,
                            client_lr=arch.client_lr,
                            server_lr=arch.server_lr)
    params, specs = _param_shards(arch, grid, plan)
    ctx = SH.round_context(plan, agg_backend=agg_backend,
                           encode_backend=encode_backend, cohort=cohort,
                           adversary=adversary)
    try:
        step = fedavg.build_sharded_round_step(
            bundle.loss_fn, comp, fcfg, ctx, grid=grid, plan=plan,
            specs=specs, remat=remat)
        # the cohort's plan resolves with the layout
        step.layout(params)
    except NotImplementedError as e:
        raise NotPorted(NOT_PORTED["pipeline"].format(msg=e)) from e
    per_step = bundle.train_batch_spec(plan.micro, shape.seq_len)
    batch = {k: BatchLeaf((plan.client_groups, plan.n_clients,
                           plan.local_steps) + tuple(v.shape), v.dtype)
             for k, v in per_step.items()}
    example = {"params": params, "specs": specs, "batch": batch,
               "mask": BatchLeaf((plan.client_groups, plan.n_clients),
                                 torch.float32),
               "fcfg": fcfg, "comp": comp, "plan": plan,
               "layout": step.layout, "vocab": arch.model.vocab}
    return step, example, plan


def _shard_leaves(meta, specs, grid):
    """``BatchLeaf``s of this rank's shards of a tree of ``meta`` tensors
    under ``specs``; a dimension that does not split over its axes raises
    ``ValueError`` (a shard is never padded)."""
    def leaf(t, sp):
        for d, axes in SH.spec_dims(sp):
            n = SH.axis_size(grid, axes)
            if t.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(t.shape)} does "
                                 f"not split over {n} ranks ({axes})")
        return BatchLeaf(SH.shard_shape(t.shape, sp, grid), t.dtype)
    return tree_map(leaf, meta, specs)


def _param_shards(arch, grid, plan):
    """(this rank's parameter shards as ``BatchLeaf``s, the spec tree):
    each leaf in its own dtype (the MoE router is f32 in a bf16 model)."""
    meta = family_module(arch.model).init_params(None, arch.model,
                                                 device="meta")
    specs = SH.param_specs(meta, grid, plan,
                           moe_experts=arch.model.moe_experts)
    return _shard_leaves(meta, specs, grid), specs


def build_prefill_cell(arch, shape: ShapeCfg, grid):
    """The serving prefill of a prefill cell (the reference's
    ``build_prefill_cell``) -> (step, example, plan). ``step(params, x)``
    is the family's ``prefill`` under ``hints.serving_hints`` on ``grid``,
    ``params`` this rank's shards (the train cell's specs) and ``x`` the
    whole batch, split over the plan's client and micro axes and its seq
    axes: for the decoder-only, hybrid and xLSTM families the (B, S)
    ``tokens`` (the VLM's without an image prefix, as the reference's cell
    takes them) -> the last position's f32 logits (B, 1, V); for the
    enc-dec the (B, S // 2, D) f32 frames ``embeds`` -> the encoder
    memory's last frame (B, 1, D), as the reference's cell returns it. The
    output is whole on every rank. ``example`` holds the shapes of the
    arguments, under the input's name."""
    bundle = build_model(arch.model)
    plan = SH.make_plan(arch, shape, grid)
    params, specs = _param_shards(arch, grid, plan)

    def step(params, x):
        with hints.serving_hints(grid, plan, specs):
            return bundle.prefill(params, x)

    example = {"params": params, "specs": specs, "plan": plan}
    if arch.model.family == "encdec":
        example["embeds"] = BatchLeaf((shape.global_batch,
                                       shape.seq_len // 2, arch.model.d_model),
                                      torch.float32)
    else:
        example["tokens"] = BatchLeaf((shape.global_batch, shape.seq_len),
                                      torch.int32)
    return step, example, plan


def build_decode_cell(arch, shape: ShapeCfg, grid):
    """One decode step of a decode cell (the reference's
    ``build_decode_cell``) -> (step, example, plan). The cache is the
    family's ``init_cache(batch, seq_len)`` cut by ``sharding.cache_specs``
    (``seq_lens=(seq_len, 2048)``, the reference's): its batch rows over
    the plan's client and micro axes; the self-attention's slots over the
    seq axes, or, at batch 1, over every axis; the enc-dec's 2,048 memory
    slots likewise; a recurrent state's feature dimension of 1,024 or more
    over `model` (Jamba's mamba d_inner, the sLSTM's D). ``step(params,
    cache, tokens, position)`` is ``bundle.decode_step`` under
    ``hints.serving_hints`` (the whole cache spec tree): ``params`` this
    rank's shards, ``cache`` its slice, ``tokens`` the whole (B, 1) batch
    -> (f32 logits (B, 1, V) on every rank, the cache slice written in
    place). ``example`` holds the shapes of its arguments and the cache's
    specs; for the enc-dec also ``fill_cache(params, cache, embeds)``, the
    family's ``prefill_cache`` under the same hints (each rank's memory
    slots from its own frames)."""
    bundle = build_model(arch.model)
    plan = SH.make_plan(arch, shape, grid)
    params, specs = _param_shards(arch, grid, plan)
    batch = shape.global_batch
    meta = bundle.init_cache(batch, shape.seq_len, device="meta")
    seq_lens = (shape.seq_len, ENCDEC_SRC_LEN)
    cspecs = SH.cache_specs(meta, plan, batch=batch, seq_lens=seq_lens)
    cache = _shard_leaves(meta, cspecs, grid)

    def serving():
        return hints.serving_hints(grid, plan, specs, cache_specs=cspecs,
                                   cache_shapes=meta, batch=batch,
                                   seq_lens=seq_lens)

    def step(params, cache, tokens, position):
        with serving():
            return bundle.decode_step(params, cache, tokens, position)

    example = {"params": params, "specs": specs, "plan": plan,
               "cache": cache, "cache_specs": cspecs,
               "tokens": BatchLeaf((batch, 1), torch.int32),
               "position": shape.seq_len - 1}
    if arch.model.family == "encdec":
        from repro_torch.models import encdec

        def fill_cache(params, cache, embeds):
            with serving():
                return encdec.prefill_cache(params, cache, embeds,
                                            arch.model)
        example["fill_cache"] = fill_cache
    return step, example, plan


def make_inputs(example, seed: int = 0):
    """(state, batch, mask) for ``build_train_cell``'s step on ``meta``
    tensors: the server state over storage-less param shards, with this
    rank's range of each pipeline state slot (``init_server_state(
    layout=)``), the batch's leaves (tokens, the VLM's image embeds;
    storage-less, so no values to draw), the PRNG key ``[0, seed]`` and a
    full mask."""
    params = tree_map(lambda leaf: torch.empty(
        leaf.shape, dtype=leaf.dtype, device="meta"), example["params"])
    state = fedavg.init_server_state(
        params, example["fcfg"], example["comp"],
        torch.tensor([0, seed], dtype=torch.int64),
        layout=example["layout"](params))
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in example["batch"].items()}
    mask = torch.ones(example["mask"].shape, dtype=torch.float32)
    return state, batch, mask


def _nbytes(tree) -> int:
    """Bytes of the tensors in a tree, lists and tuples (a ServerState's
    fields, the metrics) walked too."""
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _KernelFootprint:
    """Stands in for a kernel module inside ``core.compression`` while a
    trace runs: E1, R1 and F1 return empty outputs of their kernels'
    shapes, which is what the card allocates for them (F1 writes its
    residual in place; R1's fold mode closes the streamed carry in place),
    and compute nothing."""

    def __init__(self, ops):
        self._ops = ops

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def zsign_encode(self, x2d, keys, sigma, z, tile0=None):
        return torch.empty((x2d.shape[0], x2d.shape[1] // 8),
                           dtype=torch.uint8, device=x2d.device)

    def zsign_compress_rows(self, x2d, noise2d, sigma):
        return self.zsign_encode(x2d, None, sigma, None)

    def sign_reduce(self, packed, weights, acc=None):
        out = torch.empty((8 * packed.shape[1],), dtype=torch.float32,
                          device=packed.device)
        return out if acc is None else acc + out

    @staticmethod
    def _fold_close(rows, w, sums):
        return sums

    def sign_fold_step(self, packed, weights, acc):
        return wire._sign_fold_step(packed, weights, acc,
                                    close=self._fold_close)

    def sign_fold_finalize(self, acc):
        return wire.sign_fold_finalize(acc, close=self._fold_close)

    def ef_sign_rows(self, g2d, e2d, scale, *, live=None, in_place=False,
                     with_q=False):
        return (self.zsign_encode(g2d, None, None, None),
                e2d if in_place else torch.empty_like(e2d),
                torch.empty_like(e2d) if with_q else None)


def _noise_footprint(key, shape, z, device=None, dtype=torch.float32,
                     lo=0):
    """Stands in for ``noise.sample_z_noise`` while a trace runs: the
    draw's output, uncomputed."""
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _topk_footprint(n_coords: int):
    """Stands in for ``compression.range_topk_select`` while a trace runs:
    the same collectives (four 256-bin counts over the replica, the ties'
    prefix), and the range's even share of the k kept entries, k * L / d,
    in place of a selection that would read values a trace has not."""
    def select(row, k, all_sum, rank_prefix):
        for _ in range(4):
            all_sum(torch.zeros((256,), dtype=torch.int64,
                                device=row.device), "topk_hist")
        rank_prefix(torch.zeros((1,), dtype=torch.int64,
                                device=row.device), "topk_ties")
        n = min(row.shape[0], -(-k * row.shape[0] // n_coords))
        return torch.empty((n,), dtype=torch.int64, device=row.device)
    return select


def state_bytes(example, layout, grid) -> dict:
    """A rank's bytes of the pipeline's state slots in the model-sharded
    replica's layout and in the reference's, each slot's whole shape cut by
    its layout's spec rule (``sharding.shard_shape``). The replica's rules
    (``sharding.range_state_specs``, ``range_server_specs``) cut (G, N, S)
    client and (S,) server slots, S the R ranges' even span, to (G, 1, hi -
    lo) and (hi - lo,), a full range as ``fedavg.init_server_state(
    layout=)`` keeps it; the reference's (``wire_state_specs``,
    ``server_state_specs``) cut (G, N, d) and (d,) to (G, 1, d) and (d,),
    the coordinates replicated."""
    plan = example["plan"]
    G, N, d = plan.client_groups, plan.n_clients, layout.spec.n_coords
    span = layout.R * (layout.ranges[0][1] - layout.ranges[0][0])
    rules = {"range": (span, SH.range_state_specs, SH.range_server_specs),
             "replicated_coords": (d, SH.wire_state_specs,
                                   SH.server_state_specs)}
    out = {}
    for name, (n, client_rule, server_rule) in rules.items():
        out[name] = 0
        for s in example["comp"].state_slots(1):
            shape = (G, N, n) if s.scope == "client" else (n,)
            rule = client_rule if s.scope == "client" else server_rule
            spec = rule({s.name: shape}, plan)[s.name]
            out[name] += (math.prod(SH.shard_shape(shape, spec, grid))
                          * torch.empty((), dtype=s.dtype).element_size())
    return out


def analyze(step, example, grid, label: str, seed: int = 0) -> dict:
    """One round of ``step`` traced as this rank of a fake process group
    (the caller's): the per-rank bytes (arguments, outputs, peak live),
    FLOPs and collective bytes by kind. Nothing is allocated or computed:
    the tensors are ``meta`` tensors, and E1 and R1 stand in by their
    kernels' outputs, the card's memory, so ``step`` is built with the
    ``cuda`` backends (``run_cell`` does)."""
    t0 = time.time()
    state, batch, mask = make_inputs(example, seed=seed)
    args = {"params": _nbytes(state.params),
            "state": _nbytes([state.opt_state, state.comp_state,
                              state.rng, state.sigma,
                              state.comp_server]),
            "batch": _nbytes(batch) + _nbytes(mask)}
    layout = example["layout"](state.params)
    ops, eops = compression.K, compression.EK
    select, draw = compression.range_topk_select, znoise.sample_z_noise
    compression.K, compression.EK = (_KernelFootprint(ops),
                                     _KernelFootprint(eops))
    compression.range_topk_select = _topk_footprint(layout.spec.n_coords)
    znoise.sample_z_noise = _noise_footprint
    try:
        (new_state, metrics), peak, flops = _counted(
            lambda: step(state, batch, mask), [state.params, batch, mask])
    finally:
        compression.K, compression.EK = ops, eops
        compression.range_topk_select, znoise.sample_z_noise = select, draw
    out_bytes = _nbytes(new_state.params) + _nbytes(list(metrics))
    return _record(label, grid, t0, args, out_bytes, peak, flops,
                   state_bytes=state_bytes(example, layout, grid))


def _counted(run, external):
    """``run()`` under the memory tracker (``external``'s tensors counted
    as live), the FLOP counter and fresh collective counts -> (its result,
    the peak bytes, the FLOPs)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    mt = MemTracker()
    mt.track_external(*[t for t in tree_leaves(external)
                        if isinstance(t, torch.Tensor)])
    fc = FlopCounterMode(display=False)
    hints.reset_collective_stats()
    with mt, fc:
        out = run()
    # the device's peak (the host's few bytes of keys and mask left out)
    peak = max(v.get("Total", 0) for v in
               mt.get_tracker_snapshot("peak").values())
    return out, peak, float(fc.get_total_flops())


def _record(label, grid, t0, args, out_bytes, peak, flops, **extra):
    arg_total = sum(args.values())
    return {
        "label": label, "devices": grid.size, "rank": grid.rank,
        "trace_s": round(time.time() - t0, 2),
        "argument_size_in_bytes": arg_total,
        "argument_bytes": args, **extra,
        "output_size_in_bytes": out_bytes,
        "peak_bytes": peak,
        "temp_size_in_bytes": max(0, peak - arg_total),
        "flops_per_device": flops,
        "collectives": hints.collective_totals(0),
        "collective_calls": hints.collective_totals(1),
        "collectives_by_use": {k: v[0] for k, v in
                               sorted(hints.COLLECTIVES.items())},
        "collective_bytes_per_device": sum(
            hints.collective_totals(0).values()),
    }


def analyze_serving(step, example, grid, label: str) -> dict:
    """``analyze`` of a prefill or decode cell: one call of ``step``
    (``build_prefill_cell``'s or ``build_decode_cell``'s) traced as this
    rank of a fake process group on ``meta`` tensors -> the same fields:
    the argument bytes (param shards, the cache slice, the tokens or the
    enc-dec's frames), the output bytes (the logits or the memory frame; a
    decode's cache slice too, as the reference's cell returns it), the
    peak of everything live, the FLOPs and the collective bytes by kind and
    by use (the layers' weight gathers, ``decode_softmax``,
    ``decode_attn``, ``logits``, ``prefill_last``, the MoE dispatch, the
    states' ``slstm_state``, ``mamba_act`` and ``mamba_y``, the memory's
    ``mem_softmax`` and ``mem_attn``, ``mem_last``)."""
    t0 = time.time()

    def meta(tree):
        return tree_map(lambda leaf: torch.empty(
            leaf.shape, dtype=leaf.dtype, device="meta"), tree)

    name = "embeds" if "embeds" in example else "tokens"
    params, tokens = meta(example["params"]), meta(example[name])
    args = {"params": _nbytes(params), name: _nbytes(tokens)}
    if "cache" in example:
        cache = meta(example["cache"])
        args["cache"] = _nbytes(cache)
        (logits, cache), peak, flops = _counted(
            lambda: step(params, cache, tokens, example["position"]),
            [params, cache, tokens])
        out_bytes = _nbytes(logits) + _nbytes(cache)
    else:
        logits, peak, flops = _counted(lambda: step(params, tokens),
                                       [params, tokens])
        out_bytes = _nbytes(logits)
    return _record(label, grid, t0, args, out_bytes, peak, flops,
                   logits_shape=list(logits.shape))


def fake_group(world: int, rank: int = 0) -> None:
    """(Re)initialize the default group as a ``fake`` group of ``world``
    ranks, this process being ``rank``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             pipeline: Optional[str] = None, rank: int = 0,
             agg_backend: str = "auto", encode_backend: str = "auto",
             cohort: str = "auto", adversary: str = "none") -> dict:
    """One cell on the production mesh (a fake group of 256 or 512 ranks):
    ``analyze`` (of rank ``rank``) and the H100 roofline terms. The trace
    is the card's: the ``auto`` backends take the kernels' route."""
    from repro_torch.launch import roofline as RF
    arch = get_arch(arch_id)
    shape = SHAPES[shape_name]
    mesh_label = "pod2x16x16" if multi_pod else "16x16"
    label = f"{arch_id}/{shape_name}/{mesh_label}"
    # the reference's skip of an arch with no sub-quadratic path
    if shape_name == "long_500k" and not build_model(arch.model).subquadratic:
        return {"label": f"{arch_id}/{shape_name}", "skipped": LONG_SKIP}
    fake_group(512 if multi_pod else 256, rank)
    try:
        grid = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        if shape.kind == "train":
            step, example, plan = build_train_cell(
                arch, shape, grid, pipeline=pipeline,
                agg_backend="cuda" if agg_backend == "auto" else agg_backend,
                encode_backend=("cuda" if encode_backend == "auto"
                                else encode_backend),
                cohort=cohort, adversary=adversary)
            res = analyze(step, example, grid, label)
        else:
            build = (build_prefill_cell if shape.kind == "prefill" else
                     build_decode_cell)
            step, example, plan = build(arch, shape, grid)
            res = analyze_serving(step, example, grid, label)
    finally:
        dist.destroy_process_group()
    res["plan"] = dataclasses.asdict(plan)
    terms = RF.terms_for(arch, shape, plan,
                         res["collective_bytes_per_device"], grid.size)
    secs = terms.seconds()
    res.update({
        "chip": terms.chip.name,
        "hbm_bytes_per_device": terms.hbm_bytes_per_dev,
        "model_flops_total": terms.model_flops_total,
        "analytic_flops_per_device": terms.flops_per_dev,
        "t_compute_s": res["flops_per_device"] / terms.chip.peak_flops,
        "t_memory_s": secs["memory"],
        "t_collective_s": secs["collective"],
        "dominant": terms.dominant(),
        "peak_over_hbm": res["peak_bytes"] / HBM_BYTES,
        "fits_hbm": res["peak_bytes"] <= HBM_BYTES,
        "roofline_fraction": terms.roofline_fraction(),
        "useful_ratio": terms.model_flops_total / max(
            1.0, res["flops_per_device"] * grid.size),
    })
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="train_4k | prefill_32k | decode_32k | long_500k "
                         "(the serving cells: the prefill's last-token "
                         "logits, one decode step against the sharded KV "
                         "cache; the enc-dec's prefill the memory's last "
                         "frame), every family")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--agg-backend", default="auto",
                    choices=list(compression.AGG_BACKENDS))
    ap.add_argument("--encode-backend", default="auto",
                    choices=list(compression.ENCODE_BACKENDS))
    ap.add_argument("--cohort", default="auto",
                    help="cohort execution policy: auto | vmap | "
                         "stream(shard=K|auto[,unroll=U][,devices=D|auto]"
                         "[,feed=device|host])")
    ap.add_argument("--adversary", default="none", metavar="SPEC",
                    help="wire-level fault-injection policy compiled into "
                         "the train cell (none | sign_flip(f=..) | "
                         "byte_corrupt(f=..,p=..) | collude(f=..) | "
                         "dropout(f=..))")
    ap.add_argument("--pipeline", default=None, metavar="SPEC",
                    help="full compression pipeline spec overriding the "
                         "arch default, e.g. 'cv|zsign_packed' or "
                         "'ef|zsign' (grammar: docs/API.md)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch_id in archs:
        for shape_name in shapes:
            for mp in meshes:
                label = (f"{arch_id}/{shape_name}/"
                         f"{'pod2x16x16' if mp else '16x16'}")
                try:
                    res = run_cell(arch_id, shape_name, multi_pod=mp,
                                   pipeline=args.pipeline,
                                   agg_backend=args.agg_backend,
                                   encode_backend=args.encode_backend,
                                   cohort=args.cohort,
                                   adversary=args.adversary)
                except NotPorted as e:
                    res = {"label": label, "not_ported": str(e)}
                except Exception as e:  # record the failure, keep sweeping
                    res = {"label": label,
                           "error": f"{type(e).__name__}: {e}"}
                results.append(res)
                print(json.dumps(res, default=str), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)


if __name__ == "__main__":
    main()
