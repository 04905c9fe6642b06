"""The big plan's forced stream cohort on the port's model-sharded grid,
against the reference's stream round and the port's group round.

Four gloo ranks on the CPU (``tests/torch_sharded_stream_ranks.py``) are
spawned ONCE for the module and run the reduced qwen2.5-32b (2 layers,
d_model 64, 4 heads with 2 kv heads, QKV bias, vocab 997, f32, seq 32) on
the big plan of a 2 x 2 grid: G = 2 or 3 sequential groups of one client,
the replica over data x model, the micro-batch over `data`. Each scenario
runs two rounds (round 1 drops the last client) of ``zsign(z=1,
sigma=0.01)`` or ``ef|zsign(use_kernel=true)`` under the group round (the
vmap plan) or a forced ``stream(shard=K)`` (K = 1, 2, 3: at G = 3 and K =
2 the last shard wraps its second slot to client 0 under a zero mask),
``stream(shard=2,feed=host)`` and ``stream(shard=1,devices=2)``.

Against the port's group round on the grid: the stream's params, EF
residual rows and payload bytes are bit-identical every round (0/1-mask
sums are whole counts; the EF wire's f32 fold is the ``SignFoldAcc``,
bit-identical to one reduce at any shard size), the loss within rtol
1e-6; ``devices=2`` is bit-identical on the 0/1-mask wire. Each encode
holds K rows, never G, and every per-client collective scales with the
shard slots (the wrapped slot runs its local SGD, as in the reference).

Against the reference (a subprocess on a forced-host 4-device CPU
platform, ``tests/torch_stream_grid_reference.py``): each client's
pseudo-gradient within rtol 1e-4 / atol 1e-6 of the reference's
gradient, the loss within rtol 1e-5, ``shard_clients`` equal, and round
0's params within rtol 1e-5 of the reference's stream round (the same
cohort policy, ``devices=2`` on two of its devices) at every coordinate
whose wire bits agree with the port's encode of the reference's gradient;
on the EF wire, whose update is the sign sum weighted by a gradient
statistic (mean |g|), the update within the gradient's rtol 1e-4.
``resolve_cohort`` without client axes equals the reference's, and the
dry run prints qwen2.5-32b's full ``train_4k`` record under ``--cohort
"stream(shard=2)"``.
"""
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_sharded_ranks as R
import torch_sharded_stream_ranks as SR
from repro.configs.common import get_arch as j_arch
from repro.core import fedavg as JF
from repro.models.api import build_model as j_build
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core.context import CohortPolicy
from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.models.api import family_module
from test_torch_sharded_round import _Grid, _bits, _flat, assemble

torch.set_num_threads(1)

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
_STREAMS = [n for n, (_, _, k) in SR.SCENARIOS.items() if k != "group"]


def _group_of(name):
    G, spec, _ = SR.SCENARIOS[name]
    return f"{spec}_g{G}_group"


def _inputs():
    cfg = j_arch(SR.ARCH_ID).reduced().model
    params = jax.tree.map(np.asarray, j_build(cfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(29)
    tokens = {G: [rng.integers(0, cfg.vocab, (G, 1, 1, 2, SR.SEQ),
                               dtype=np.int32) for _ in range(SR.ROUNDS)]
              for G in (2, 3)}
    ref = {"params": params, "tokens": {G: t[0] for G, t in tokens.items()},
           "lrs": (R.CLR, R.SLR),
           "scenarios": {n: (G, SR.SPECS[s], SR.COHORTS[k])
                         for n, (G, s, k) in SR.SCENARIOS.items()}}
    return {"params": params, "tokens": tokens}, ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    out = tmp_path_factory.mktemp("sharded_stream")
    inputs, ref_in = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with open(out / "ref_in.pkl", "wb") as f:
        pickle.dump(ref_in, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_stream_grid_reference.py"),
         str(out / "ref_in.pkl"), str(out / "ref_out.pkl")], env=env)
    try:
        mp.spawn(SR.main, args=(WORLD, str(out / "store"), str(out)),
                 nprocs=WORLD, join=True)
    finally:
        assert ref.wait(timeout=600) == 0
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(out / "ref_out.pkl", "rb") as f:
        want = pickle.load(f)
    return inputs, ranks, want


def _packed(b):
    return b["packed"] if isinstance(b, dict) else b


def _slots(name):
    """The encodes' slots in order: (global slot, its client or None for
    the wrapped padding), K to an encode."""
    G, _, k = SR.SCENARIOS[name]
    if k == "group":
        return [[(g, g)] for g in range(G)]
    pol = CohortPolicy.parse(SR.COHORTS[k])
    K = min(pol.shard, G)
    n = -(-G // K)
    devices = min(pol.devices, n)
    n = -(-n // devices) * devices
    return [[(j, j if j < G else None) for j in range(s * K, (s + 1) * K)]
            for s in range(n)]


@pytest.mark.parametrize("name", _STREAMS)
def test_stream_round_is_the_group_round(run, name):
    _, ranks, _ = run
    G, spec, kind = SR.SCENARIOS[name]
    exact = not (kind == "k1_dev2" and spec == "ef")
    for rk in ranks:
        for t, (a, b) in enumerate(zip(rk[name]["rounds"],
                                       rk[_group_of(name)]["rounds"])):
            if exact:
                for p in b["params"]:
                    np.testing.assert_array_equal(
                        a["params"][p].view(np.int32),
                        b["params"][p].view(np.int32), err_msg=str((t, p)))
                if b["state"] is not None:
                    for k in b["state"]:
                        np.testing.assert_array_equal(
                            a["state"][k].view(np.int32),
                            b["state"][k].view(np.int32))
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
            # the real clients' payloads are the group round's
            got = {c: (_packed(x)[i]) for call, x in zip(_slots(name),
                                                         a["bytes"])
                   for i, (_, c) in enumerate(call) if c is not None}
            for g, x in enumerate(b["bytes"]):
                np.testing.assert_array_equal(got[g], _packed(x)[0])


@pytest.mark.parametrize("name", _STREAMS)
def test_stream_holds_shard_rows_only(run, name):
    """Each encode holds the shard's K rows; ``shard_clients`` is K; a
    per-client collective scales with the shard slots (the wrapped slot
    runs its local SGD), the update's re-layout and the round's norm
    stay once a round."""
    _, ranks, want = run
    G, _, kind = SR.SCENARIOS[name]
    calls = _slots(name)
    K = len(calls[0])
    slots = len(calls) * K
    for rk in ranks:
        for a, b in zip(rk[name]["rounds"], rk[_group_of(name)]["rounds"]):
            assert a["shard_clients"] == K == \
                want["rounds"][name]["shard_clients"]
            assert [x.shape[0] for x in a["x"]] == [K] * len(calls)
            ua, ub = a["collective_by_use"], b["collective_by_use"]
            assert set(ua) == set(ub)
            for u in ub:
                if u in ("all_to_all:from_range", "all_reduce:norm"):
                    assert ua[u] == ub[u], u
                else:
                    assert ua[u] * G == ub[u] * slots, u


@pytest.mark.parametrize("name", _STREAMS)
def test_stream_round_against_the_reference(run, name):
    inputs, ranks, want = run
    G, spec, _ = SR.SCENARIOS[name]
    ref = want["grads"][G]
    grads = [c["grad"] for c in ref]
    d = grads[0].size
    sub = TN.split(TN.prng_key(1))[1]
    keys = TN.client_keys(sub, 0, G).numpy()
    same = np.ones(d, bool)
    for rk in ranks:
        r0 = rk[name]["rounds"][0]
        np.testing.assert_allclose(r0["loss"],
                                   np.mean([c["loss"] for c in ref]),
                                   rtol=1e-5)
        lo, hi = rk[name]["bounds"]
        real = min(hi, d) - lo
        for call, x, b in zip(_slots(name), r0["x"], r0["bytes"]):
            for i, (_, c) in enumerate(call):
                if c is None:
                    continue
                ref_p = grads[c][lo:lo + real]
                np.testing.assert_allclose(x[i, :real], ref_p, rtol=1e-4,
                                           atol=1e-6)
                pad = np.zeros((1, hi - lo), np.float32)
                pad[0, :real] = ref_p
                port = TO.zsign_encode_plain(
                    torch.from_numpy(pad), torch.from_numpy(keys[c:c + 1]),
                    torch.full((1,), R.SIGMA), 1, lo // 8192).numpy()
                got = _bits(_packed(b)[i])[:real]
                if spec == "ef":
                    # round 0's residual is 0: the EF bits pack p >= 0
                    mine = np.packbits(pad[0] >= 0, bitorder="little")
                    want_bits = _bits(mine)[:real]
                else:
                    want_bits = _bits(port[0])[:real]
                diff = np.nonzero(got != want_bits)[0]
                assert np.all(x[i, diff] != ref_p[diff])
                same[lo:lo + real] &= got == want_bits
    grid = _Grid((2, 2))
    plan = SR.plan_for(grid, G)
    m = SR.arch(G).model
    specs = dict(tree_paths(SH.param_specs(
        family_module(m).param_shapes(m), grid, plan)))
    got_tree = {}
    recs = [{"coords": rk[name]["coords"],
             "params": rk[name]["rounds"][0]["params"]} for rk in ranks]
    for p, v in assemble(recs, grid, plan, specs).items():
        tree_set(got_tree, p, v)
    p_ref = want["rounds"][name]["params"]
    if spec == "ef":
        # the EF update is the scale-weighted sign sum, its scale mean|g|
        # a gradient statistic: held as the gradient is
        p0 = _flat(inputs["params"])
        np.testing.assert_allclose((_flat(got_tree) - p0)[same],
                                   (p_ref - p0)[same], rtol=1e-4, atol=0)
    else:
        np.testing.assert_allclose(_flat(got_tree)[same], p_ref[same],
                                   rtol=1e-5, atol=0)
    assert same.mean() > 0.99


@pytest.mark.parametrize("policy", ["stream(shard=2)", "stream(shard=1)",
                                    "stream(shard=3)", "stream",
                                    "stream(shard=2,feed=host)", "auto",
                                    "vmap", "stream(shard=1,devices=2)"])
def test_resolve_cohort_without_client_axes_is_the_reference(policy):
    """A plan without client axes resolves the cohort as the reference
    does with no ``spmd_axes``: a forced stream keeps its shard (clamped
    to the cohort), ``auto`` and a bare stream at this size are the vmap
    plan, and more devices than there are raises the reference's
    ``ValueError`` head."""
    try:
        want = JF.resolve_cohort(policy, 3, 1 << 10)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TF.resolve_cohort(policy, 3, 1 << 10)
        head = str(e).split(" (")[0]
        assert str(got.value).startswith(head)
        return
    assert tuple(TF.resolve_cohort(policy, 3, 1 << 10)) == tuple(want)


def test_dry_run_prints_the_forced_stream_record(capsys):
    """qwen2.5-32b's full ``train_4k`` cell under ``--cohort
    "stream(shard=2)"``: its two sequential groups in one shard of 2, a
    record (not ``not_ported``) whose range buffer holds 2 rows."""
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    dryrun.main(["--arch", "qwen2_5_32b", "--shape", "train_4k",
                 "--cohort", "stream(shard=2)"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["label"] == "qwen2_5_32b/train_4k/16x16"
    assert "error" not in line and "not_ported" not in line, line
    assert line["plan"]["client_groups"] == 2 and line["fits_hbm"]
    assert line["flops_per_device"] > 0
    assert line["collectives_by_use"]["all_to_all:to_range"] > 0
