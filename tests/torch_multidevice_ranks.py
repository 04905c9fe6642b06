"""The rank side of ``tests/test_torch_multidevice.py``: one process per
rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once per test module. Imports torch and the port only.

Every scenario of ``SCENARIOS`` runs the reference's consensus problem
(``tests/test_cohort_stream.py``: loss 0.5 * ||x - y||^2, n = 16, d = 96,
``MASK16``) through the port's round step under ``stream(...,devices=D)``:
at D = 4 over the whole group, at D = 2 on the two pairs of ranks (0, 1)
and (2, 3), which split the scenarios between them. Each rank records its
params, its client-state rows, the round metrics and every
``torch.distributed`` call the round steps made (with its bytes). Then
every rank runs the launcher, ``launch.train.run``, at D = 4 with a
checkpoint. The scenarios' checkpoints gather their rows in pieces of 1 KiB,
so each rank's rows cross in several messages. Each rank pickles what it saw to ``<out>/rank<r>.pkl``."""
from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch

N, D_COORDS = 16, 96
#: 8 of 16 live (the reference's _MASK16): n_live a power of two
DEAD16 = [1, 4, 5, 9, 11, 12, 13, 15]
#: the uneven cohort: 10 clients, 2 dead, shards of 2 -> 5 shards
DEAD10 = [2, 7]
ASYNC = dict(round_mode="async(deadline=1.0,staleness=cutoff(2))",
             latency="linear(base=0.0,step=0.25)")

#: name -> (spec, shard at D=2, shard at D=4, rounds, options)
SCENARIOS = {
    "zsign_s3": ("zsign_packed(z=1,sigma=0.7)", 3, 3, 4, {}),
    "zsign_s8": ("zsign_packed(z=1,sigma=0.7)", 8, 4, 4, {}),
    "ef_none": ("ef|zsign(scale=none)", 3, 3, 4, {}),
    "topk": ("ef|topk(frac=0.25)", 3, 3, 4,
             {"glr": 0.5, "slr": 0.5, "integer_targets": True}),
    "ef_1r": ("ef|zsign", 8, 4, 1, {}),
    "vote": ("zsign_packed(z=1,sigma=0.7,agg=vote)", 3, 3, 4, {}),
    "trimmed": ("zsign_packed(z=1,sigma=0.7,agg=trimmed(f=2))", 3, 3, 4,
                {}),
    "median": ("zsign_packed(z=1,sigma=0.7,agg=median)", 3, 3, 4, {}),
    "byte_corrupt": ("zsign_packed(z=1,sigma=0.7,agg=median)", 2, 2, 3,
                     {"adversary": "byte_corrupt(f=2,p=0.1)"}),
    "uneven": ("ef|zsign(scale=none)", 2, 2, 4, {"n": 10}),
    "async": ("zsign_packed(z=1,sigma=0.7)", 4, 4, 3, ASYNC),
    "ckpt": ("ef|zsign(scale=none)", 3, 3, 4, {"ckpt_at": 2}),
    # the (2, d) value/count carry and the dense f32 wire, on dyadic sums
    "topk_coord": ("topk(frac=0.25,agg=coord)", 3, 3, 4,
                   {"glr": 0.5, "slr": 0.5, "integer_targets": True}),
    "dense": ("dense", 3, 3, 4,
              {"glr": 0.5, "slr": 0.5, "integer_targets": True}),
}


def cohort(name: str, devices: int) -> str:
    spec, s2, s4, _, _ = SCENARIOS[name]
    shard = s2 if devices == 2 else s4
    return (f"stream(shard={shard},devices={devices})" if devices > 1
            else f"stream(shard={shard})")


def mask_for(n: int) -> np.ndarray:
    m = np.ones((1, n), np.float32)
    m[0, DEAD16 if n == 16 else DEAD10] = 0.0
    return m


def targets(n: int, integer_targets: bool) -> np.ndarray:
    """(1, n, 1, 96) f32 targets from a seeded numpy draw (dyadic when
    ``integer_targets``: every sum of the top-k path stays exact)."""
    y = np.random.RandomState(5).standard_normal((1, n, 1, D_COORDS))
    y = y.astype(np.float32)
    return np.round(y * 4.0) if integer_targets else y


def loss_fn(p, b):
    return 0.5 * torch.sum((p["x"] - b["y"]) ** 2)


def build(name: str, cohort_spec: str, group=None):
    """-> (step, state, cfg, ctx, batch, mask, rounds, ckpt_at) of a
    scenario on this rank."""
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    spec, _, _, rounds, opt = SCENARIOS[name]
    n = opt.get("n", N)
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=n, client_lr=opt.get("glr", 0.01),
                       server_lr=opt.get("slr", 0.3))
    ctx = TF.RoundContext(cohort=cohort_spec, weights_are_mask=True,
                          adversary=opt.get("adversary", "none"),
                          round_mode=opt.get("round_mode", "sync"),
                          latency=opt.get("latency", "zero"))
    step = TF.build_round_step(loss_fn, comp, cfg, ctx, group=group)
    st = TF.init_server_state({"x": torch.zeros(D_COORDS)}, cfg, comp,
                              TN.prng_key(1), ctx=ctx, group=group)
    batch = {"y": torch.from_numpy(targets(
        n, opt.get("integer_targets", False)))}
    return step, st, cfg, ctx, batch, mask_for(n), rounds, opt.get("ckpt_at")


class CallLog:
    """Records every torch.distributed call made while it is on, as
    (name, payload bytes)."""
    NAMES = ("send", "recv", "isend", "irecv", "broadcast", "all_reduce",
             "reduce", "all_gather", "all_gather_into_tensor", "gather",
             "scatter", "reduce_scatter", "all_to_all", "all_to_all_single",
             "barrier", "broadcast_object_list", "all_gather_object")

    def __init__(self):
        import torch.distributed as dist
        self.calls, self.on = [], False
        for name in self.NAMES:
            fn = getattr(dist, name, None)
            if fn is not None:
                setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapped(*a, **k):
            if self.on:
                t = a[0] if a and isinstance(a[0], torch.Tensor) else None
                self.calls.append(
                    (name, None if t is None else t.numel() * t.element_size()))
            return fn(*a, **k)
        return wrapped


def run_scenario(name: str, devices: int, group, log: CallLog, ckdir: str):
    from repro_torch.checkpoint.manager import CheckpointManager, StateRows
    from repro_torch.core import fedavg as TF
    from repro_torch.core import wire
    step, st, cfg, ctx, batch, mask, rounds, ckpt_at = build(
        name, cohort(name, devices), group)
    total = cfg.n_clients
    plan = TF.resolve_cohort(ctx.cohort, total, D_COORDS, group)
    rows = StateRows(tuple(TF.owned_rows(plan, total, r)
                           for r in range(plan.devices)),
                     (1, total), group=group)
    out = {"calls": [], "losses": []}
    wire.reset_reduce_stats()
    for t in range(rounds):
        if ckpt_at is not None and t == ckpt_at:
            mgr = CheckpointManager(ckdir)
            mgr.save(t, st._asdict(), rows=rows)
            # resume at this D from what was just written: every rank
            # restores its rows into a fresh state
            import torch.distributed as dist
            dist.barrier(group)
            step, fresh = build(name, cohort(name, devices), group)[:2]
            r, tree = CheckpointManager(ckdir).restore_latest(
                fresh._asdict(), rows=rows)
            assert r == t
            st = TF.ServerState(**tree)
        log.calls = []
        log.on = True
        st, m = step(st, batch, mask)
        log.on = False
        out["calls"].append(log.calls)
        out["losses"].append(float(m.loss))
    out["params"] = st.params["x"].numpy().copy()
    out["participation"] = float(m.participation)
    out["state"] = (None if st.comp_state is None else
                    {k: v.numpy().copy() for k, v in st.comp_state.items()})
    out["owned"] = TF.owned_rows(plan, total, wire.rank_world(group)[0])
    out["plan_devices"] = plan.devices
    out["reduce_stats"] = dict(wire.REDUCE_STATS)
    return out


#: the launcher's run at D = 4: a reduced qwen2-0.5B, 8 EF clients (0/1
#: weights) in shards of 2, checkpointed by rank 0 at its end
TRAIN_ARGS = ["--arch", "qwen2_0_5b", "--reduced", "--clients", "8",
              "--local-steps", "1", "--seq-len", "16", "--device", "cpu",
              "--pipeline", "ef|zsign(scale=none)", "--save-every", "100"]
TRAIN_ROUNDS = 2


def train_argv(cohort: str, rounds: int, ckpt_dir: str) -> list:
    return TRAIN_ARGS + ["--cohort", cohort, "--rounds", str(rounds),
                         "--ckpt-dir", ckpt_dir]


def run_train(out_dir: str) -> dict:
    """``launch.train.run`` on every rank of the group (joined already):
    -> its params, its residual rows and what it printed."""
    import contextlib
    import io
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train
    states, text = [], io.StringIO()
    with contextlib.redirect_stdout(text):
        train.run(train.parse_args(train_argv(
            "stream(shard=2,devices=4)", TRAIN_ROUNDS,
            os.path.join(out_dir, "ck-train"))),
            on_round=lambda t, b, a, m, s: states.append(a))
    st = states[-1]
    return {"params": [v.numpy().copy() for v in tree_leaves(st.params)],
            "state": st.comp_state["ef"].numpy().copy(),
            "printed": text.getvalue()}


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cohort_group
    torch.set_num_threads(1)
    make_cohort_group(device_type="cpu", init_method=f"file://{store}",
                      rank=rank, world_size=world,
                      timeout=datetime.timedelta(seconds=120), verbose=False)
    from repro_torch.checkpoint import manager
    res = {}
    try:                      # a cohort of fewer ranks than the group has
        make_cohort_group(2, device_type="cpu")
    except ValueError as e:
        res["fewer_devices"] = str(e)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    log = CallLog()
    names = list(SCENARIOS)
    # the scenarios' checkpoint gathers go in pieces of 1 KiB (2-3 a rank)
    manager.GATHER_CHUNK_BYTES = 1024
    for name in names:
        ck = os.path.join(out_dir, f"ck-{name}-4")
        res[(name, 4)] = run_scenario(name, 4, None, log, ck)
    pair = rank // 2
    for i, name in enumerate(names):
        if i % 2 == pair:
            ck = os.path.join(out_dir, f"ck-{name}-2")
            res[(name, 2)] = run_scenario(name, 2, pairs[pair], log, ck)
    manager.GATHER_CHUNK_BYTES = 256 << 20
    res["train"] = run_train(out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
