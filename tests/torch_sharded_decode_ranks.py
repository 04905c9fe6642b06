"""The rank side of ``tests/test_torch_sharded_decode.py``: one process per
rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once for the module. Imports torch and the port only.

The test process writes each scenario's numpy params and tokens to
``<out>/inputs.pkl``; every rank runs each scenario of
``DECODE_SCENARIOS`` on a (data, model) = 2 x 2 ``ReplicaGrid`` through the
dry run's serving cells (``launch/dryrun.build_prefill_cell`` and
``build_decode_cell``), from its shards of the params
(``models/api.shard_params``): one prefill, then a greedy decode of
``steps`` steps from a zero cache slice, feeding back its own argmax. It
pickles to ``<out>/rank<r>.pkl`` its coordinates, the prefill's logits,
each step's logits and token, its final cache slice, the collective bytes
by use of the prefill and of each step, and the text of the ``ValueError``
that a position past the cache and shapes that do not split over the grid
raise. Each scenario of ``BF16_SCENARIOS`` runs again at bf16 beside the
port's one-process prefill and decode of the same bf16 weights, both
decodes fed the one-process greedy tokens.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle

import torch

import torch_sharded_ranks as R

#: the reduced models beside ``torch_sharded_ranks.FAMILIES``: h2o-danube's
#: sliding window (8 at the reduced size)
MODELS = {**R.FAMILIES, "danube": ("h2o_danube_3_4b", {})}
#: name -> (model (None: the reduced dense model), big plan, decode batch,
#: cache slots, steps, prefill (batch, seq)). A batch of 16 splits over the
#: production mesh's client and micro axes (``sharding.cache_specs``' rule),
#: so over the 2 x 2 grid's `data`: 8 rows a rank; 12 slots are 6 a
#: sequence rank, so 10 steps cross the shard at 6. At batch 1 the 24 slots
#: split over both axes, 6 a rank, and 20 steps reach the last rank's.
DECODE_SCENARIOS = {
    "dense_regular": (None, False, 16, 12, 10, (4, 32)),
    "dense_big": (None, True, 16, 12, 10, (4, 32)),
    "granite_regular": ("granite", False, 16, 12, 10, (4, 32)),
    "llama4_big": ("llama4", True, 16, 12, 10, (4, 32)),
    "internvl2_regular": ("internvl2_v256", False, 16, 12, 10, (4, 32)),
    "window_b1": ("danube", False, 1, 24, 20, (2, 32)),
}
#: the scenarios run again at the configurations' bf16 (the grid's decode
#: against the port's one-process decode; the reference runs f32 here)
BF16_SCENARIOS = ("dense_regular",)
GRID = (2, 2)


def arch(name, dtype=torch.float32):
    """The port's ArchConfig of a scenario's reduced model in ``dtype``."""
    model, big = DECODE_SCENARIOS[name][:2]
    if model is None or model in R.FAMILIES:
        a = R.arch(big, model=model)
    else:
        from repro_torch.configs.common import ArchConfig, get_arch
        arch_id, over = MODELS[model]
        m = dataclasses.replace(get_arch(arch_id).reduced().model, **over)
        a = ArchConfig(arch_id=model, model=m, source="test", big=big,
                       seq_client_groups=2)
    return dataclasses.replace(a, model=dataclasses.replace(a.model,
                                                            dtype=dtype))


def shapes(name):
    """(prefill shape, decode shape) of a scenario."""
    from repro_torch.configs.common import ShapeCfg
    _, _, batch, slots, _, (pb, ps) = DECODE_SCENARIOS[name]
    return (ShapeCfg("test_prefill", "prefill", ps, pb),
            ShapeCfg("test_decode", "decode", slots, batch))


def _by_use():
    from repro_torch.launch import hints
    return {k: v[0] for k, v in hints.COLLECTIVES.items()}


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _run(name, grid, inputs, a=None, params=None, feed=None):
    """The scenario on the grid: arch ``a`` (the scenario's f32 one) from
    ``params`` (its numpy weights); step t's input the previous step's
    argmax or, given ``feed``, ``feed[t]``."""
    from repro_torch.configs.common import ShapeCfg
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import dryrun, hints
    from repro_torch.models.api import shard_params
    a = a or arch(name)
    steps = DECODE_SCENARIOS[name][4]
    pre_shape, dec_shape = shapes(name)
    params = inputs["params"][name] if params is None else params
    rec = {"coords": dict(grid.coords)}
    prefill, _, plan = dryrun.build_prefill_cell(a, pre_shape, grid)
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    hints.reset_collective_stats()
    rec["prefill"] = prefill(shards, torch.from_numpy(
        inputs["prefill_tokens"][name])).numpy()
    rec["prefill_by_use"] = _by_use()
    step, ex, plan = dryrun.build_decode_cell(a, dec_shape, grid)
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    cache = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=leaf.dtype),
                     ex["cache"])
    tok = torch.from_numpy(inputs["start"][name])
    rec.update(logits=[], tokens=[], by_use=[])
    for t in range(steps):
        hints.reset_collective_stats()
        logits, cache = step(shards, cache, tok if feed is None else feed[t],
                             t)
        rec["by_use"].append(_by_use())
        rec["logits"].append(logits.numpy().copy())
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        rec["tokens"].append(tok.numpy().copy())
    rec["cache"] = {k: v.float().numpy().copy() for k, v in cache.items()}
    # what must raise: a position past the whole cache, a cache slice of
    # another shape, a prefill whose sequence or batch does not split
    rec["errors"] = {
        "past_cache": _error(lambda: step(shards, cache, tok,
                                          dec_shape.seq_len)),
        "cache_shape": _error(lambda: step(
            shards, {k: v[:, :, :-1] for k, v in cache.items()}, tok, 0)),
        "prefill_seq": _error(lambda: dryrun.build_prefill_cell(
            a, ShapeCfg("odd", "prefill", pre_shape.seq_len + 1,
                        pre_shape.global_batch), grid)[0](
            shards, torch.zeros((pre_shape.global_batch,
                                 pre_shape.seq_len + 1), dtype=torch.int32))),
    }
    if plan.client_axes or plan.micro_axes:
        rec["errors"]["prefill_batch"] = _error(
            lambda: dryrun.build_prefill_cell(
                a, ShapeCfg("odd", "prefill", pre_shape.seq_len, 3),
                grid)[0](shards, torch.zeros((3, pre_shape.seq_len),
                                             dtype=torch.int32)))
    return rec


def _run_bf16(name, grid, inputs):
    """The scenario at bf16 (its f32 weights rounded), on the grid and in
    this process alone through the bundle's entry points (no grid): the
    one-process greedy decode, then the grid's fed the same tokens. ->
    {"grid": ``_run``'s record, "one": the one-process prefill, logits,
    tokens (the start token first) and cache}."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.api import build_model
    a = arch(name, torch.bfloat16)
    _, batch, slots, steps = DECODE_SCENARIOS[name][1:5]
    params = tree_map(lambda v: torch.from_numpy(v).to(torch.bfloat16),
                      inputs["params"][name])
    bundle = build_model(a.model)
    one = {"prefill": bundle.prefill(params, torch.from_numpy(
        inputs["prefill_tokens"][name])).numpy()}
    cache = bundle.init_cache(batch, slots, device="cpu")
    feed = [torch.from_numpy(inputs["start"][name])]
    logits = []
    for t in range(steps):
        lg, cache = bundle.decode_step(params, cache, feed[-1], t)
        logits.append(lg.numpy().copy())
        feed.append(torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None])
    one.update(logits=logits, tokens=[f.numpy() for f in feed],
               cache={k: v.float().numpy() for k, v in cache.items()})
    return {"grid": _run(name, grid, inputs, a, params, feed), "one": one}


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_replica_grid
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    grid = make_replica_grid(GRID, ("data", "model"), device_type="cpu")
    rec = {name: _run(name, grid, inputs) for name in DECODE_SCENARIOS}
    rec["bf16"] = {name: _run_bf16(name, grid, inputs)
                   for name in BF16_SCENARIOS}
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
